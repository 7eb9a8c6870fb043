"""Quantization-quality sweep: reconstruction and attention-output error per
(M, nbits), the weights-free analogue of the reference's perplexity
sensitivity table.

Counterpart of million_tpu/benchmarks/quality_bench.py, with its data, its
six combinations and its JSON line. The synthetic K/V (a low-rank
correlated base plus heavy-tailed outlier channels) is drawn with numpy
from the seed, so both packages sweep the same vectors. Codebooks are
trained with the port's k-means on `--device` (every Lloyd assignment
through the fused encode kernel on the card) and the round trip encodes
with the same kernel ("exact"); the (d/4, 10) combination trains C = 1024
codebooks and writes int16 codes.

    python -m million_tpu_torch.benchmarks.quality_bench [--n 8192] [--d 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from million_tpu_torch import resolve_device


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_kv(rng, n, d, outlier_scale=8.0):
    """Low-rank correlated vectors with heavy-tailed outlier channels."""
    rank = max(4, d // 8)
    basis = rng.standard_normal((rank, d))
    x = rng.standard_normal((n, rank)) @ basis / np.sqrt(rank)
    n_out = max(1, d // 16)  # a few channels carry outliers
    idx = rng.choice(d, n_out, replace=False)
    x[:, idx] += outlier_scale * rng.standard_normal((n, n_out)) ** 3 / 3.0
    return x.astype(np.float32)


def attention_mae(q, k, v, khat, vhat):
    """Mean |softmax(q K^T) V - softmax(q K_hat^T) V_hat|."""
    def attn(kk, vv):
        s = q @ kk.T / np.sqrt(q.shape[-1])
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        return p @ vv

    return float(np.abs(attn(k, v) - attn(khat, vhat)).mean())


def combos(d: int) -> List[tuple]:
    """(M_k, nbits_k, M_v, nbits_v): the symmetric sweep and the asymmetric
    kernel geometry (K d_m = 2 at nbits 8, V d_m = 4 at nbits 7)."""
    return [
        (d // 2, 8, d // 2, 8), (d // 2, 6, d // 2, 6), (d // 2, 4, d // 2, 4),
        (d // 4, 8, d // 4, 8), (d // 4, 10, d // 4, 10),
        (d // 2, 8, d // 4, 7),
    ]


def sweep(*, n: int = 8192, d: int = 64, n_queries: int = 64, iters: int = 25, outlier_scale: float = 8.0,
          seed: int = 0, device="cuda",
          tables: Optional[Callable[[np.ndarray, int, int], np.ndarray]] = None) -> Dict:
    """The sweep and its headline, as the reference's main prints them.
    `tables(x, M, nbits)` -> (M, 2^nbits, d/M) codebooks replaces the port's
    training (the tests hand it the reference's)."""
    from million_tpu_torch.ops.pq_encode_kernel import pq_encode_fused
    from million_tpu_torch.pq.kmeans import train_pq
    from million_tpu_torch.pq.ops import pq_decode

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    k = synth_kv(rng, n, d, outlier_scale)
    v = synth_kv(rng, n, d, 1.0)
    q = rng.standard_normal((n_queries, d)).astype(np.float32)
    var = float(k.var())

    def roundtrip(x, M, nbits):
        xt = torch.from_numpy(x).to(dev)
        if tables is None:
            cents = train_pq(xt, M=M, nbits=nbits, iters=iters, layout="strided", seed=seed)
        else:
            cents = torch.from_numpy(np.array(tables(x, M, nbits), np.float32)).to(dev)
        codes = pq_encode_fused(xt, cents, "strided", precision="exact")
        return pq_decode(codes, cents, "strided").cpu().numpy()

    rows = []
    for M_k, nb_k, M_v, nb_v in combos(d):
        khat = roundtrip(k, M_k, nb_k)
        vhat = roundtrip(v, M_v, nb_v)
        mse = float(((k - khat) ** 2).mean())
        row = {
            "M": M_k, "nbits": nb_k, "M_v": M_v, "nbits_v": nb_v,
            "bits_per_dim": (M_k * nb_k + M_v * nb_v) / (2 * d),
            "rel_mse": round(mse / var, 5), "attn_mae": round(attention_mae(q, k, v, khat, vhat), 5),
        }
        rows.append(row)
        log(row)
    prod = rows[0]  # the production shape (M = d/2, nbits 8: 4 bits a dim)
    return {
        "metric": f"PQ relative reconstruction MSE, M=d/2 nbits=8 (4-bit effective), "
                  f"outlier-scale {outlier_scale}",
        "value": prod["rel_mse"],
        "unit": "mse/var",
        "attn_mae": prod["attn_mae"],
        "sweep": rows,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192, help="training vectors")
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--n-queries", type=int, default=64)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--outlier-scale", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = sweep(n=args.n, d=args.d, n_queries=args.n_queries, iters=args.iters,
                outlier_scale=args.outlier_scale, seed=args.seed, device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

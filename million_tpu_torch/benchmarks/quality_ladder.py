"""End-to-end quality ladder: Δppl(dense -> PQ) on a trained model and real text.

Counterpart of million_tpu/benchmarks/quality_ladder.py, with its protocol:
for each rung it runs the real pipeline on the pinned byte LMs
(benchmarks/tiny_lm.py) -- sample KV from the model's own dense prefill,
train codebooks with the port's k-means (pq/kmeans.py; on the card every
Lloyd assignment is the fused encode kernel), evaluate distorted-prefill
perplexity (every PQ prefill encodes through the same kernel) -- and reports
Δppl against dense.

Rungs as in the reference, the OPQ rung included (rotations and codebooks
trained together by pq/kmeans.train_opq), and the nbits 9-12 rungs on wide
int16 codes; `--coarse-sweep` is the reference's M = d/4 ladder at nbits
8-12.

    python -m million_tpu_torch.benchmarks.quality_ladder --fast --device cpu
    python -m million_tpu_torch.benchmarks.quality_ladder --fast      # on the card

`--frozen` runs chip_smoke.py's quality ladder instead (lm_l_v1 on
tiny_lm.build_corpus_frozen(), the FROZEN_* protocol), at `--seeds N`
k-means seeds, and prints each rung's Δppl at every seed with their mean and
standard deviation: how far seed noise alone moves a rung. `--wide` takes
the wide rungs (FROZEN_WIDE_RUNGS) instead of the four 8-bit ones.

    python -m million_tpu_torch.benchmarks.quality_ladder --frozen --seeds 5 [--wide]

`main` appends its result to the port's ledger, results_torch.jsonl.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from million_tpu_torch.benchmarks.perplexity import perplexity
from million_tpu_torch.benchmarks.tiny_lm import (
    build_corpus,
    build_corpus_frozen,
    build_corpus_v2,
    checkpoint_path,
    checkpoint_path_l,
    load_checkpoint,
)
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama
from million_tpu_torch.pq.kmeans import train_opq, train_pq
from million_tpu_torch.pq.ops import select_outlier_channels, zero_channels


# The frozen-stream ladder (chip_smoke.py's quality phase): lm_l_v1 over
# tiny_lm.build_corpus_frozen(), K/V from its first 16 windows of 1,024 tokens
# (65,536 rows a layer and side, the 8-bit budget 256 x 2^8), perplexity over
# its last 32 windows of 1,024 tokens, 25 k-means iterations (the reference's
# run_ladder(model="large") protocol), and the rungs docs/PERF.md:557-567 names.
FROZEN_SAMPLE_WINDOWS, FROZEN_EVAL_WINDOWS, FROZEN_CTX, FROZEN_ITERS = 16, 32, 1024, 25
FROZEN_RUNGS = {
    "dm2": dict(M_k=32, nbits_k=8),
    "dm4+16/16 C=256": dict(M_k=16, nbits_k=8, outlier_k=16, outlier_kk=16),
    "dm4+16/16 C=128": dict(M_k=16, nbits_k=7, outlier_k=16, outlier_kk=16),
    "dm8+16/16 C=128": dict(M_k=8, nbits_k=7, outlier_k=16, outlier_kk=16),
}
# The wide rungs on the same stream and protocol: dm2 at nbits 9-12 (ladder_rungs' full ladder),
# then the coarse sweep, M = d/4 at nbits 8-12. The frozen sample holds 65,536 rows a layer and
# side, so every rung above nbits 8 trains on all of them (its budget of 256 x 2^nbits rows is
# 131,072 to 1,048,576).
FROZEN_WIDE_RUNGS = {
    **{f"dm2 C={2 ** nb}": dict(M_k=32, nbits_k=nb) for nb in (9, 10, 11, 12)},
    **{f"dm4 C={2 ** nb}": dict(M_k=16, nbits_k=nb) for nb in (8, 9, 10, 11, 12)},
}


def frozen_split(tokens):
    """(sample tokens, evaluation tokens) of the frozen-stream ladder."""
    return tokens[:FROZEN_SAMPLE_WINDOWS * FROZEN_CTX], tokens[-FROZEN_EVAL_WINDOWS * FROZEN_CTX:]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def sample_kv(params, cfg, tokens, *, windows=8, ctx=512, bs=8):
    """Per-layer K/V head vectors from dense prefills of the stream's first
    `windows` windows of `ctx` tokens, bs windows a prefill -> (kv_k, kv_v),
    each (L, rows, d) float16 numpy, rows stored f16 as the reference keeps
    them (its 256 * 2^12-row budgets)."""
    dev = params["embed"].device
    bs = min(bs, windows)
    dcfg = DenseCacheConfig(bs=bs, nh_k=cfg.num_kv_heads, d=cfg.head_dim, N_max=ctx, dtype=cfg.dtype)
    ks, vs = [], []
    for w0 in range(0, windows - windows % bs, bs):
        ids = np.stack([tokens[(w0 + i) * ctx:(w0 + i + 1) * ctx] for i in range(bs)])
        cache = init_dense_state(dcfg, cfg.num_layers, device=dev)
        llama.prefill(params, cfg, torch.from_numpy(ids.astype(np.int64)).to(dev), cache, None,
                      mode="dense", last_logit_only=True)
        # (L, bs, nh_k, n, d) -> per layer (bs * nh_k * n, d)
        for out, side in ((ks, "k"), (vs, "v")):
            out.append(cache[side].to(torch.float16).reshape(cfg.num_layers, -1, cfg.head_dim).cpu().numpy())
    return np.concatenate(ks, axis=1), np.concatenate(vs, axis=1)


def train_cents(kv, M, nbits, *, iters=15, opq=False, seed=0, device="cuda"):
    """Per-layer codebooks from kv (L, rows, d), layer l seeded with seed + l:
    (codebooks (L, M, C, d_m) f32, OPQ rotations (L, d, d) f32 with opq=True
    else None), on `device`."""
    cents, rots = [], []
    for l in range(kv.shape[0]):
        x = torch.as_tensor(kv[l], device=device)
        if opq:
            R, c = train_opq(x, M=M, nbits=nbits, iters=iters, seed=seed + l, layout="strided")
            rots.append(R)
        else:
            c = train_pq(x, M=M, nbits=nbits, iters=iters, seed=seed + l, layout="strided")
        cents.append(c)
    return torch.stack(cents), (torch.stack(rots) if opq else None)


def _split_outliers(kv, k: int, device):
    """The k highest-energy channels of each layer's samples, kept exact:
    (L, k) int32 indices and the samples with those channels zeroed."""
    idx, zeroed = [], []
    for l in range(kv.shape[0]):
        x = torch.as_tensor(kv[l], device=device)
        i = select_outlier_channels(x, k)
        idx.append(i)
        zeroed.append(zero_channels(x, i))
    return torch.stack(idx), torch.stack(zeroed)


def rung_cents(cfg, kv_k, kv_v, *, M_k: int, nbits_k: int, M_v: Optional[int] = None,
               nbits_v: Optional[int] = None, opq: bool = False, outlier_k: int = 0,
               outlier_kk: int = 0, train_iters: int = 15, seed: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """A rung's tables: per-layer K and V codebooks trained on the rung's
    sample budget (the reference's 256 rows per centroid), with exact V
    (outlier_k) and K (outlier_kk) channels split off first. K layer l is
    seeded with seed + l, V with seed + 100 + l (the reference's seeds at
    seed=0)."""
    M_v = M_v or M_k
    nbits_v = nbits_v or nbits_k
    budget = 256 * (2 ** max(nbits_k, nbits_v))
    kv_k_b, kv_v_b = kv_k[:, :budget], kv_v[:, :budget]
    cents = {}
    if outlier_k:
        cents["v_outlier_idx"], kv_v_b = _split_outliers(kv_v_b, outlier_k, device)
    if outlier_kk:
        cents["k_outlier_idx"], kv_k_b = _split_outliers(kv_k_b, outlier_kk, device)
    cents["key"], Rk = train_cents(kv_k_b, M_k, nbits_k, iters=train_iters, opq=opq, seed=seed,
                                   device=device)
    cents["value"], Rv = train_cents(kv_v_b, M_v, nbits_v, iters=train_iters, opq=opq, seed=seed + 100,
                                     device=device)
    if opq:
        cents["Rk"], cents["Rv"] = Rk, Rv
    return cents


def rung_perplexity(params, cfg, eval_tokens, cents, *, max_length: int, max_windows: int,
                    use_kernel: bool = True) -> Dict:
    """Distorted-prefill perplexity of one rung's tables, on a flat PQ cache
    with Lt=64 and N_max=max_length (C from the wider of the two sides: int16
    arenas above 256)."""
    M_k, C_k = cents["key"].shape[1:3]
    M_v, C_v = cents["value"].shape[1:3]
    pqc = PQCacheConfig(
        bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M_k, M_v=M_v, C=max(C_k, C_v), Lt=64,
        N_max=max_length, dtype=cfg.dtype,
        OK=cents["k_outlier_idx"].shape[1] if "k_outlier_idx" in cents else 0,
        OV=cents["v_outlier_idx"].shape[1] if "v_outlier_idx" in cents else 0,
    )
    dev = params["embed"].device
    return perplexity(params, cfg, eval_tokens, lambda: init_state(pqc, cfg.num_layers, device=dev),
                      cents, mode="pq", max_length=max_length, distort_recent=True,
                      max_windows=max_windows, use_kernel=use_kernel)


def ladder_rung(
    params, cfg, eval_tokens, kv_k, kv_v, *,
    M_k: int, nbits_k: int, M_v: Optional[int] = None,
    nbits_v: Optional[int] = None, opq: bool = False, outlier_k: int = 0,
    outlier_kk: int = 0,
    max_length: int = 512, max_windows: int = 8, train_iters: int = 15,
) -> Dict:
    """One rung: train its tables, then its perplexity; with the seconds of each."""
    dev = params["embed"].device
    M_v = M_v or M_k
    nbits_v = nbits_v or nbits_k
    t0 = time.perf_counter()
    cents = rung_cents(cfg, kv_k, kv_v, M_k=M_k, nbits_k=nbits_k, M_v=M_v, nbits_v=nbits_v,
                       opq=opq, outlier_k=outlier_k, outlier_kk=outlier_kk,
                       train_iters=train_iters, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    r = rung_perplexity(params, cfg, eval_tokens, cents, max_length=max_length,
                        max_windows=max_windows)
    _sync(dev)
    return {
        "M": M_k, "nbits": nbits_k, "M_v": M_v, "nbits_v": nbits_v,
        "opq": opq, "outlier_k": outlier_k, "outlier_kk": outlier_kk,
        "ppl": r["ppl"], "train_s": t1 - t0, "eval_s": time.perf_counter() - t1,
    }


def dense_perplexity(params, cfg, eval_tokens, *, max_length: int, max_windows: int) -> Dict:
    dev = params["embed"].device
    dcfg = DenseCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, N_max=max_length,
                            dtype=cfg.dtype)
    return perplexity(params, cfg, eval_tokens, lambda: init_dense_state(dcfg, cfg.num_layers, device=dev),
                      None, mode="dense", max_length=max_length, distort_recent=False,
                      max_windows=max_windows)


def ladder_rungs(cfg, *, fast: bool = False, coarse_sweep: bool = False):
    """The reference's rungs for a model of head dim cfg.head_dim."""
    d = cfg.head_dim
    M = d // 2
    if coarse_sweep:  # the resolvable nbits curve lives at M = d/4
        return [dict(M_k=d // 4, nbits_k=nb) for nb in (8, 9, 10, 11, 12)]
    rungs = [dict(M_k=M, nbits_k=8)]
    if not fast:
        rungs += [dict(M_k=M, nbits_k=nb) for nb in (9, 10, 11, 12)]
        rungs += [
            dict(M_k=d // 4, nbits_k=8),  # degenerate d_m=4
            dict(M_k=M, nbits_k=8, opq=True),  # OPQ
            dict(M_k=M, nbits_k=8, M_v=d // 4, nbits_v=7),  # asymmetric V d_m=4
            # ... rescued by exact V outlier channels
            dict(M_k=M, nbits_k=8, M_v=d // 4, nbits_v=7, outlier_k=max(d // 16, 2)),
            dict(M_k=M, nbits_k=8, M_v=d // 4, nbits_v=7, outlier_k=max(d // 8, 4)),
            # d_m=4 on both sides with outliers on both
            dict(M_k=d // 4, nbits_k=8, M_v=d // 4, nbits_v=8,
                 outlier_k=max(d // 8, 4), outlier_kk=max(d // 8, 4)),
        ]
    return rungs


def run_ladder(*, fast: bool = False, max_windows: int = 8, max_length: int = 512,
               model: str = "tiny", train_iters: int = 15, coarse_sweep: bool = False,
               device="cuda") -> Dict:
    """model="tiny": the d=32 regression model, sampled and evaluated on the
    tail of build_corpus. model="large": the d=64 anchor with the reference's
    sample budget (256 * 2^12 rows a layer), evaluated on the held-out tail
    of build_corpus_v2."""
    if model == "large":
        params, cfg = load_checkpoint(checkpoint_path_l(), device=device)
        tokens = build_corpus_v2()
        holdout = 2 << 20
        eval_tokens = tokens[-holdout:][: max_windows * max_length + 1]
        ctx = 1024
        windows = -(-(256 * 4096) // (cfg.num_kv_heads * ctx))
        kv_k, kv_v = sample_kv(params, cfg, tokens[: windows * ctx], windows=windows, ctx=ctx, bs=8)
    else:
        params, cfg = load_checkpoint(checkpoint_path(), device=device)
        tokens = build_corpus()
        holdout = 1 << 16
        eval_tokens = tokens[-holdout:]
        kv_k, kv_v = sample_kv(params, cfg, tokens[-2 * holdout: -holdout])

    dense = dense_perplexity(params, cfg, eval_tokens, max_length=max_length, max_windows=max_windows)
    rows = []
    for kw in ladder_rungs(cfg, fast=fast, coarse_sweep=coarse_sweep):
        row = ladder_rung(params, cfg, eval_tokens, kv_k, kv_v, max_length=max_length,
                          max_windows=max_windows, train_iters=train_iters, **kw)
        row["dppl"] = row["ppl"] - dense["ppl"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"dense_ppl": dense["ppl"]}), flush=True)
    return {"dense_ppl": dense["ppl"], "rows": rows}


def frozen_ladder(params, cfg, tokens, *, seeds: int = 1, rungs: Optional[Dict] = None,
                  sample_windows: int = FROZEN_SAMPLE_WINDOWS, eval_windows: int = FROZEN_EVAL_WINDOWS,
                  ctx: int = FROZEN_CTX, train_iters: int = FROZEN_ITERS) -> Dict:
    """The frozen-stream ladder (FROZEN_RUNGS unless `rungs` is given) at
    `seeds` k-means seeds, K layer l seeded with 1000 s + l and V with
    1000 s + 100 + l: K/V from the first sample_windows windows of ctx tokens,
    perplexity over the last eval_windows. Returns the dense ppl and, per
    rung, its Δppl at each seed with their mean and standard deviation."""
    dev = params["embed"].device
    sample, eval_tokens = tokens[:sample_windows * ctx], tokens[-eval_windows * ctx:]
    kv_k, kv_v = sample_kv(params, cfg, sample, windows=sample_windows, ctx=ctx, bs=8)
    dense = dense_perplexity(params, cfg, eval_tokens, max_length=ctx, max_windows=eval_windows)["ppl"]
    rows = []
    for name, geom in (rungs or FROZEN_RUNGS).items():
        dppl = []
        for s in range(seeds):
            cents = rung_cents(cfg, kv_k, kv_v, train_iters=train_iters, seed=1000 * s, device=dev, **geom)
            dppl.append(rung_perplexity(params, cfg, eval_tokens, cents, max_length=ctx,
                                        max_windows=eval_windows)["ppl"] - dense)
        rows.append({"rung": name, **geom, "dppl_by_seed": dppl, "mean": float(np.mean(dppl)),
                     "std": float(np.std(dppl, ddof=1)) if seeds > 1 else None})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"dense_ppl": dense}), flush=True)
    return {"dense_ppl": dense, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="the nbits=8 rung only")
    ap.add_argument("--model", choices=("tiny", "large"), default="tiny")
    ap.add_argument("--windows", type=int, default=None)
    ap.add_argument("--max-length", type=int, default=None)
    ap.add_argument("--coarse-sweep", action="store_true", help="nbits 8..12 at M=d/4")
    ap.add_argument("--frozen", action="store_true",
                    help="chip_smoke.py's ladder: lm_l_v1 on the frozen stream, its four rungs")
    ap.add_argument("--seeds", type=int, default=1, help="k-means seeds of each --frozen rung")
    ap.add_argument("--wide", action="store_true", help="--frozen over FROZEN_WIDE_RUNGS")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--results", default=None, help="ledger file (default results_torch.jsonl)")
    args = ap.parse_args(argv)
    if args.model == "large":
        windows, max_length, iters = args.windows or 32, args.max_length or 1024, 25
    else:
        windows, max_length, iters = args.windows or 8, args.max_length or 512, 15
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from million_tpu_torch.benchmarks.serving_bench import card_line

        card = card_line()
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        card = "cpu (not a device measurement)"
    from million_tpu_torch.utils.ledger import RESULTS, append_result

    if args.frozen:
        params, cfg = load_checkpoint(checkpoint_path_l(), device=dev)
        out = frozen_ladder(params, cfg, build_corpus_frozen(), seeds=args.seeds,
                            rungs=FROZEN_WIDE_RUNGS if args.wide else None)
        append_result(args.results or RESULTS, {
            "stage": "quality_ladder_frozen", "backend": dev.type, "card": card, "seeds": args.seeds,
            "wide": args.wide, "result": out})
        return
    out = run_ladder(fast=args.fast, max_windows=windows, max_length=max_length, model=args.model,
                     train_iters=iters, coarse_sweep=args.coarse_sweep, device=dev)
    append_result(args.results or RESULTS, {
        "stage": "quality_ladder", "backend": dev.type, "card": card, "model": args.model,
        "coarse_sweep": args.coarse_sweep, "max_length": max_length, "windows": windows,
        "result": out,
    })


if __name__ == "__main__":
    main()

"""The JAX package's quality ladder on the frozen stream, on the CPU: the
numbers the port's ladder in chip_smoke.py (the quality phase) is compared
with. Run from the repository root as

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/quality_reference_jax.py [--seed S] [--rungs NAME ...] [--wide]
        [--parts DIR [--part k0|v0|k1|...]]

It runs million_tpu's own sample_kv, train_cents, select_outlier_channels,
zero_channels and perplexity, unchanged, composed as million_tpu's
ladder_rung composes them (the same budgets and cache), on lm_l_v1 over
million_tpu_torch.benchmarks.tiny_lm.build_corpus_frozen() with the
protocol of million_tpu_torch.benchmarks.quality_ladder.FROZEN_*: the four
rungs of FROZEN_RUNGS by default, the wide rungs of FROZEN_WIDE_RUNGS (dm2 at
nbits 9-12, then the coarse sweep M = d/4 at nbits 8-12) with --wide, or
the rungs named. K layer l
is seeded with 1000 S + l and V with 1000 S + 100 + l (million_tpu's own
seeds at S = 0, the port's `quality_ladder --frozen --seeds` at seed S).

It prints one JSON line for the stream, dense and each rung. Each rung's
line also holds the port's perplexity of million_tpu's tables, evaluated
with the port on the CPU (`port_ppl`): the two packages' perplexity code
held to each other on the same tables, apart from the k-means. A seed of the
four 8-bit rungs takes about an hour on one CPU thread, 40 min of it the dm2
rung's large-n k-means. A wide rung's k-means costs about C / 256 times the
dm2 rung's (M = 32), or half that (M = 16): hours a seed at nbits 11 and 12.
Run the seeds and the costly rungs as separate processes. A costly rung
can also be split by layer and side: each `--parts DIR --part k3` process
trains one layer's table (train_cents on that layer alone, with the seed
train_cents gives it, so the same table) into DIR and exits; a run with
`--parts DIR` and no `--part` then reads the tables it finds there, trains
any missing, and evaluates."""

import argparse
import hashlib
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from million_tpu.benchmarks.perplexity import perplexity
from million_tpu.benchmarks.quality_ladder import sample_kv, train_cents
from million_tpu.benchmarks.tiny_lm import checkpoint_path_l, load_checkpoint
from million_tpu.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu.cache.pq_cache import PQCacheConfig, init_state
from million_tpu.pq.ops import select_outlier_channels, zero_channels
from million_tpu_torch.benchmarks import quality_ladder as ql
from million_tpu_torch.benchmarks.tiny_lm import build_corpus_frozen
from million_tpu_torch.benchmarks.tiny_lm import load_checkpoint as port_load_checkpoint
from million_tpu_torch.convert import cents_from_numpy


def split_outliers(kv, k):
    idx = np.stack([np.asarray(select_outlier_channels(jnp.asarray(kv[l]), k)) for l in range(kv.shape[0])])
    zeroed = np.stack([np.asarray(zero_channels(jnp.asarray(kv[l]), jnp.asarray(idx[l])))
                       for l in range(kv.shape[0])])
    return idx, zeroed


def train_side(kv, M, nbits, seed, parts=None, tag="k", only=None):
    """million_tpu's train_cents over every layer, or, with `parts`, layer by
    layer through one .npy file a layer (train_cents seeds layer l with
    seed + l, so layer l trained alone with seed + l is the same table).
    With `only` (a layer), train just that layer's file."""
    if parts is None:
        return train_cents(kv, M, nbits, iters=ql.FROZEN_ITERS, seed=seed)[0]
    layers = range(kv.shape[0]) if only is None else [only]
    for l in layers:
        f = parts / f"{tag}{l}.npy"
        if not f.exists():
            c = train_cents(kv[l:l + 1], M, nbits, iters=ql.FROZEN_ITERS, seed=seed + l)[0][0]
            np.save(parts / f"{tag}{l}.tmp.npy", np.asarray(c))
            (parts / f"{tag}{l}.tmp.npy").replace(f)
    if only is not None:
        return None
    return jnp.asarray(np.stack([np.load(parts / f"{tag}{l}.npy") for l in layers]), jnp.float32)


def rung(params, cfg, eval_tokens, kv_k, kv_v, *, M_k, nbits_k, outlier_k=0, outlier_kk=0, seed=0,
         parts=None, part=None):
    """million_tpu's ladder_rung for a rung with one geometry on both sides,
    returning its tables too: (ppl, tables). With `part` ("k3", "v0"), train
    only that side and layer into `parts` and return None."""
    budget = 256 * 2**nbits_k
    kv_k_b, kv_v_b = kv_k[:, :budget], kv_v[:, :budget]
    cents = {}
    if outlier_k:
        oidx, kv_v_b = split_outliers(kv_v_b, outlier_k)
        cents["v_outlier_idx"] = jnp.asarray(oidx, jnp.int32)
    if outlier_kk:
        koidx, kv_k_b = split_outliers(kv_k_b, outlier_kk)
        cents["k_outlier_idx"] = jnp.asarray(koidx, jnp.int32)
    if part is not None:
        side, l = part[0], int(part[1:])
        train_side(kv_k_b if side == "k" else kv_v_b, M_k, nbits_k, seed + (0 if side == "k" else 100),
                   parts, side, only=l)
        return None
    cents["key"] = train_side(kv_k_b, M_k, nbits_k, seed, parts, "k")
    cents["value"] = train_side(kv_v_b, M_k, nbits_k, seed + 100, parts, "v")
    pqc = PQCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M_k, M_v=M_k, C=2**nbits_k, Lt=64,
                        N_max=ql.FROZEN_CTX, dtype=cfg.dtype, OK=outlier_kk, OV=outlier_k)
    r = perplexity(params, cfg, eval_tokens, lambda: init_state(pqc, cfg.num_layers), cents, mode="pq",
                   max_length=ql.FROZEN_CTX, distort_recent=True, max_windows=ql.FROZEN_EVAL_WINDOWS)
    return r["ppl"], cents


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0, help="K layer l seeded 1000 S + l, V 1000 S + 100 + l")
    ap.add_argument("--rungs", nargs="*", default=None,
                    help="names from FROZEN_RUNGS or FROZEN_WIDE_RUNGS (default: FROZEN_RUNGS)")
    ap.add_argument("--wide", action="store_true", help="every rung of FROZEN_WIDE_RUNGS")
    ap.add_argument("--parts", type=Path, default=None,
                    help="train layer by layer through DIR/<rung>_s<S>/{k,v}<layer>.npy")
    ap.add_argument("--part", default=None, help="with --parts and one rung: train only this side and layer "
                    "(k0, v3, ...) and exit")
    args = ap.parse_args()
    if args.part is not None and (args.parts is None or len(args.rungs or ()) != 1):
        ap.error("--part needs --parts and exactly one rung in --rungs")
    every = {**ql.FROZEN_RUNGS, **ql.FROZEN_WIDE_RUNGS}
    names = args.rungs or list(ql.FROZEN_WIDE_RUNGS if args.wide else ql.FROZEN_RUNGS)
    jax.config.update("jax_platforms", "cpu")
    tokens = build_corpus_frozen()
    print(json.dumps({"stream_bytes": len(tokens),
                      "sha256": hashlib.sha256(tokens.astype(np.uint8).tobytes()).hexdigest(),
                      "backend": jax.default_backend(), "seed": args.seed}), flush=True)
    params, cfg = load_checkpoint(checkpoint_path_l())
    port_params, port_cfg = port_load_checkpoint(checkpoint_path_l(), device="cpu")
    sample, eval_tokens = ql.frozen_split(tokens)
    kv_k, kv_v = sample_kv(params, cfg, sample, windows=ql.FROZEN_SAMPLE_WINDOWS, ctx=ql.FROZEN_CTX, bs=8)

    def parts_dir(name):
        if args.parts is None:
            return None
        d = args.parts / f"{name.replace(' ', '_')}_s{args.seed}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    if args.part is not None:
        t0 = time.perf_counter()
        name = args.rungs[0]
        rung(params, cfg, eval_tokens, kv_k, kv_v, seed=1000 * args.seed, parts=parts_dir(name),
             part=args.part, **every[name])
        print(json.dumps({"rung": name, "seed": args.seed, "part": args.part,
                          "s": time.perf_counter() - t0}), flush=True)
        return
    t0 = time.perf_counter()
    dense = perplexity(params, cfg, eval_tokens, lambda: init_dense_state(
        DenseCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, N_max=ql.FROZEN_CTX, dtype=cfg.dtype),
        cfg.num_layers), None, mode="dense", max_length=ql.FROZEN_CTX, distort_recent=False,
        max_windows=ql.FROZEN_EVAL_WINDOWS)["ppl"]
    print(json.dumps({"dense_ppl": dense, "s": time.perf_counter() - t0}), flush=True)
    for name in names:
        t0 = time.perf_counter()
        ppl, cents = rung(params, cfg, eval_tokens, kv_k, kv_v, seed=1000 * args.seed, parts=parts_dir(name),
                          **every[name])
        s = time.perf_counter() - t0
        with torch.no_grad():
            port_ppl = ql.rung_perplexity(port_params, port_cfg, eval_tokens,
                                          cents_from_numpy({k: np.asarray(v) for k, v in cents.items()},
                                                           device="cpu"),
                                          max_length=ql.FROZEN_CTX, max_windows=ql.FROZEN_EVAL_WINDOWS)["ppl"]
        print(json.dumps({"rung": name, "seed": args.seed, "ppl": ppl, "dppl": ppl - dense,
                          "rel": (ppl - dense) / dense, "s": s, "port_ppl": port_ppl,
                          "port_rel_gap": abs(port_ppl - ppl) / ppl}), flush=True)


if __name__ == "__main__":
    main()

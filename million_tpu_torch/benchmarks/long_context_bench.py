"""Long-context decode benchmark: time per output token at 128K tokens of
context, PQ code arenas against the dense bf16 KV cache.

Counterpart of million_tpu/benchmarks/long_context_bench.py. At 131,072
tokens the dense bf16 KV cache of llama-3.2-3b is 2 x 28 x 8 x 131,072 x 128
x 2 B = 15.0 GB, which a 16 GB TPU could not hold beside 6.4 GB of weights;
an 80 GB card holds it, so the dense row runs here beside the PQ geometries
(dm2's arena is 3.76 GB). Weights are random from --seed; the arenas hold
synthetic uniform codes (a random tile of tokens repeated along the token
axis; the tile divides the arena, so n_codes never claims more tokens than
were written), and the codebooks are synthetic (standard normal, the
outlier geometries with 16 + 16 exact channels). The decode step is timed by
utils.timing.chained_bench_stats (a chain of --iters steps, each feeding its
argmax token to the next, --repeats chains, CUDA events) and reported as p10 /
p50 / p90 ms a token. --ttft-chunk also times a chunked prefill of the same
context (PQ geometries only: generate refuses a chunked dense prefill).

Run:  python3 -m million_tpu_torch.benchmarks.long_context_bench \\
          --geometry dense,dm2,dm4_outlier_c128 [--ctx 131072] [--ttft-chunk 4096]
One JSON line per geometry, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from million_tpu_torch.benchmarks.serving_bench import GEOMETRIES, card_line, synthetic_cents
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, cache_memory_bytes, init_state
from million_tpu_torch.convert import cents_from_numpy
from million_tpu_torch.models import llama
from million_tpu_torch.models.chunked_prefill import chunked_prefill
from million_tpu_torch.utils.timing import chained_bench_stats

LT = 128  # residual window rows
CODE_TILE = 1024  # tokens of the random code tile that fills the arena
PREFIX = 512  # tokens short of the arena: n_codes = ctx - 512, as the reference fills it


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def code_arena(shape, C: int, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    """(..., ctx, M) uint8 arena of uniform codes: a random tile of
    gcd(ctx, 1024) tokens repeated ctx / tile times. The tile divides ctx, so
    the arena holds exactly ctx tokens."""
    *lead, ctx, M = shape
    tile = math.gcd(ctx, CODE_TILE)
    t = torch.randint(0, C, (*lead, tile, M), generator=gen, device=dev, dtype=torch.uint8)
    out = t.repeat(*([1] * len(lead)), ctx // tile, 1)
    if tuple(out.shape) != tuple(shape):
        raise RuntimeError(f"arena {tuple(out.shape)} != {tuple(shape)}")
    return out


def arena_bytes(cfg: llama.ModelConfig, geometry: str, ctx: int, bs: int) -> dict:
    """Bytes of the cache a geometry holds at ctx tokens (codes, exact
    channels and residual windows), and the dense bf16 KV cache's."""
    L, nh_k, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    dense = 2 * L * bs * nh_k * ctx * d * 2
    if geometry == "dense":
        return {"cache_bytes": dense, "dense_bytes": dense}
    d_m, C, O = GEOMETRIES[geometry]
    pqc = PQCacheConfig(bs=bs, nh_k=nh_k, d=d, M=d // d_m, C=C, Lt=LT, N_max=ctx, OK=O, OV=O)
    return {"cache_bytes": cache_memory_bytes(pqc, L)["total"], "dense_bytes": dense}


def make_cache(cfg, geometry: str, ctx: int, bs: int, dev: torch.device, seed: int):
    """(cache, cents): the arena filled with ctx tokens of codes (or the
    dense cache with random bf16 K/V), counters at ctx - 512."""
    L, nh_k, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if geometry == "dense":
        cache = init_dense_state(DenseCacheConfig(bs=bs, nh_k=nh_k, d=d, N_max=ctx), L, device=dev)
        for i in range(L):  # random K/V, one layer at a time (no f32 transient of the whole cache)
            cache["k"][i].normal_(generator=gen)
            cache["v"][i].normal_(generator=gen)
        return cache, None
    import numpy as np

    cents_np, M, C, O = synthetic_cents(L, d, geometry, np.random.default_rng(seed))
    pqc = PQCacheConfig(bs=bs, nh_k=nh_k, d=d, M=M, C=C, Lt=LT, N_max=ctx, OK=O, OV=O)
    cache = init_state(pqc, L, device=dev)
    for side in ("key", "value"):
        cache[side + "_codes"] = code_arena(tuple(cache[side + "_codes"].shape), C, gen, dev)
    for side in ("key_outliers", "value_outliers"):
        if side in cache:
            cache[side].normal_(generator=gen)
    return cache, cents_from_numpy(cents_np, device=dev)


def reset(cache: dict, ctx: int) -> dict:
    """Counters of a step chain's start: ctx - 512 tokens in the arena (or
    the dense cache), an empty residual window. The steps write only residual
    rows (dense: positions ctx - 512 on), so the filled arena is reused."""
    if "length" in cache:
        cache["length"] = ctx - PREFIX
    else:
        cache["n_codes"], cache["r"] = ctx - PREFIX, 0
    return cache


def run_geometry(params, cfg, geometry: str, *, ctx: int, bs: int = 1, iters: int = 12, repeats: int = 5,
                 ttft_chunk: int = 0, ttft_only: bool = False, device="cuda", seed: int = 0) -> dict:
    """Decode TPOT of one geometry at ctx tokens (p10 / p50 / p90 over
    `repeats` chains of `iters` steps) and, with ttft_chunk, the chunked
    prefill's TTFT of ctx - 512 tokens; the cache is freed before it
    returns. Returns the result row."""
    dev = torch.device(device)
    if iters > LT:
        raise ValueError(f"iters={iters}: a chain must not fill the {LT}-row residual window")
    sizes = arena_bytes(cfg, geometry, ctx, bs)
    log(f"ctx={ctx} {geometry}: cache {sizes['cache_bytes'] / 1e9:.2f} GB vs dense bf16 KV "
        f"{sizes['dense_bytes'] / 1e9:.2f} GB")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    row = {"geometry": geometry, "ctx": ctx, "bs": bs, **sizes}
    mode = "dense" if geometry == "dense" else "pq_kernel"
    cache, cents = make_cache(cfg, geometry, ctx, bs, dev, seed)
    n_arena = cache["k" if geometry == "dense" else "key_codes"].shape[3]
    if n_arena != ctx:
        raise RuntimeError(f"the arena holds {n_arena} tokens, not {ctx}")
    if not ttft_only:
        tok0 = torch.zeros((bs,), dtype=torch.long, device=dev)

        def step(state):
            tok, c = state
            logits = llama.decode_step(params, cfg, tok, ctx - PREFIX + 12, c, cents, mode=mode)
            return logits.argmax(-1), c

        stats = chained_bench_stats(step, lambda: (tok0, reset(cache, ctx)), iters=iters, warmup=2,
                                    repeats=repeats)
        row.update(tpot_ms_p10=stats["p10"] * 1e3, tpot_ms_p50=stats["p50"] * 1e3,
                   tpot_ms_p90=stats["p90"] * 1e3, tpot_ms_samples=[x * 1e3 for x in stats["samples"]],
                   tokens_per_s=bs / stats["p50"])
        log(f"{geometry}: TPOT p50 {stats['p50'] * 1e3:.3f} ms (p10 {stats['p10'] * 1e3:.3f}, "
            f"p90 {stats['p90'] * 1e3:.3f}) at ctx={ctx} bs={bs}")
    del cache
    if ttft_chunk and geometry != "dense":
        d_m, C, O = GEOMETRIES[geometry]
        pqc = PQCacheConfig(bs=bs, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=cfg.head_dim // d_m, C=C, Lt=LT,
                            N_max=ctx, OK=O, OV=O)
        ids = torch.randint(0, cfg.vocab_size, (bs, ctx - PREFIX), generator=torch.Generator(device=dev)
                            .manual_seed(seed + 2), device=dev)
        # warm-up on one chunk: the first launches of each kernel and GEMM leave the timed run
        chunked_prefill(params, cfg, ids[:, :ttft_chunk], init_state(pqc, cfg.num_layers, device=dev), cents,
                        chunk=ttft_chunk)
        cache = init_state(pqc, cfg.num_layers, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, _ = chunked_prefill(params, cfg, ids, cache, cents, chunk=ttft_chunk)
        _sync(dev)
        row["ttft_s"] = time.perf_counter() - t0
        row["ttft_chunk"] = ttft_chunk
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("non-finite logits after the chunked prefill")
        log(f"{geometry}: chunked-prefill TTFT {row['ttft_s']:.3f} s (chunk={ttft_chunk}, "
            f"{ctx - PREFIX} tokens)")
        del cache, logits
    if dev.type == "cuda":
        row["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.empty_cache()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ctx", type=int, default=131072)
    ap.add_argument("--preset", default="llama-3.2-3b", choices=sorted(llama.PRESETS))
    ap.add_argument("--bs", type=int, default=1)
    ap.add_argument("--iters", type=int, default=12, help="decode steps a chain")
    ap.add_argument("--repeats", type=int, default=5, help="chains (the spread's samples)")
    ap.add_argument("--geometry", default="dm2",
                    help="comma list of dense, " + ", ".join(sorted(GEOMETRIES)))
    ap.add_argument("--ttft-chunk", type=int, default=0,
                    help="also time a chunked prefill of ctx - 512 tokens in chunks of this size (0: skip)")
    ap.add_argument("--ttft-only", action="store_true", help="skip the decode TPOT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (small presets only)")
    args = ap.parse_args(argv)
    geoms = args.geometry.split(",")
    for g in geoms:
        if g != "dense" and g not in GEOMETRIES:
            raise SystemExit(f"unknown geometry {g!r}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("long_context_bench: no CUDA device (pass --device cpu for a small rehearsal)")
    card = card_line() if dev.type == "cuda" else "cpu (not a device measurement)"
    if dev.type == "cuda":  # build the kernels now, so that no timed phase pays for nvcc
        from concurrent.futures import ThreadPoolExecutor

        from million_tpu_torch.ops.cuda_build import build

        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(build, ("pq_decode_attention", "pq_chunk_attention", "pq_encode", "causal_attention")))
    cfg = llama.PRESETS[args.preset]
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    log(f"card: {card}")
    for g in geoms:
        row = run_geometry(params, cfg, g, ctx=args.ctx, bs=args.bs, iters=args.iters, repeats=args.repeats,
                           ttft_chunk=args.ttft_chunk, ttft_only=args.ttft_only, device=dev, seed=args.seed)
        print(json.dumps({
            "metric": f"decode TPOT, {args.preset} @ {args.ctx} ctx, bs={args.bs}, {g}",
            "value": row.get("tpot_ms_p50"), "unit": "ms/token", **row, "card": card}), flush=True)


if __name__ == "__main__":
    main()

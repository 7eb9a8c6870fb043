"""Where a decode step's time goes on the card: llama-3.2-3b at full width,
a synthetic 32K cache (--ctx; random codes as bench.py builds them), decode steps
timed on the host clock and then traced with torch.profiler.

    python3 -m million_tpu_torch.benchmarks.decode_profile [--bs 4] [--steps 8]
    python3 -m million_tpu_torch.benchmarks.decode_profile --bs 6 --modes paged:dm2,paged:dm4_outlier_c128
    python3 -m million_tpu_torch.benchmarks.decode_profile --bs 1 --ctx 131072 --modes pq:dm2

For each mode (dense bf16 KV, pq_kernel dm2, pq_kernel dm4_outlier_c128 over
the flat cache; paged:<geometry> for a serving tick, paged_decode_step over
--bs slots of a paged cache in 2048-token pages) it prints the step time
(host clock around synchronised steps), the device's busy time per step
(union of the traced kernels' intervals), the idle share, and the kernels
that take most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch

from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig, init_paged_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama
from million_tpu_torch.models.paged_decode import paged_decode_step

CTX, HEADROOM = 32768, 512  # cache tokens, and those left free past the fill
PAGE_SIZE = 2048
GEOMETRIES = {"dm2": (64, 256, 0), "dm4_outlier_c128": (32, 128, 16)}


def synthetic_state(cfg, bs, mode, gen, dev, ctx=CTX):
    """A cache of ctx tokens filled to ctx - 512 with random contents, and
    its cents."""
    L, nk, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    fill = ctx - HEADROOM
    if mode == "dense":
        c = init_dense_state(DenseCacheConfig(bs=bs, nh_k=nk, d=d, N_max=ctx), L, device=dev)
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
        c["length"] = fill
        return c, None
    kind, geom = mode.split(":")
    M, C, O = GEOMETRIES[geom]
    if kind == "paged":  # every slot fill tokens long, its pages one after the other
        pps = ctx // PAGE_SIZE
        pcfg = PagedPQCacheConfig(num_layers=L, nh_k=nk, d=d, M=M, C=C, page_size=PAGE_SIZE,
                                  n_pages=bs * pps, max_seqs=bs, pages_per_seq=pps, OK=O, OV=O)
        c = init_paged_state(pcfg, device=dev)
        c["page_table"].copy_(torch.arange(bs * pps, device=dev).reshape(bs, pps))
        c["seq_n_codes"].fill_(fill)
        c["seq_n_pages"].fill_(pps)
        c["seq_active"].fill_(1)
        c["config"] = pcfg
        arenas, outliers = ("key_pool", "value_pool"), ("key_outlier_pool", "value_outlier_pool")
    else:
        c = init_state(PQCacheConfig(bs=bs, nh_k=nk, d=d, M=M, C=C, N_max=ctx, OK=O, OV=O), L, device=dev)
        c["n_codes"] = fill
        arenas, outliers = ("key_codes", "value_codes"), ("key_outliers", "value_outliers")
    for k in arenas:
        c[k].copy_(torch.randint(0, C, c[k].shape, generator=gen, device=dev, dtype=torch.uint8))
    if O:
        for k in outliers:
            c[k].normal_(generator=gen)
    cents = {"key": torch.randn((L, M, C, d // M), generator=gen, device=dev),
             "value": torch.randn((L, M, C, d // M), generator=gen, device=dev)}
    if O:
        idx = torch.randperm(d, generator=gen, device=dev)[:O].sort().values.int()
        cents["k_outlier_idx"] = idx.repeat(L, 1).contiguous()
        cents["v_outlier_idx"] = idx.repeat(L, 1).contiguous()
    return c, cents


def busy_us(events) -> float:
    """Length of the union of the intervals of device events (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_mode(params, cfg, bs, mode, steps, gen, dev, ctx=CTX):
    cache, cents = synthetic_state(cfg, bs, mode, gen, dev, ctx)
    fill = ctx - HEADROOM
    tok = torch.zeros((bs,), dtype=torch.long, device=dev)
    if mode.startswith("paged"):
        pcfg = cache.pop("config")

        def step(i):  # positions come from the device counters, as in a serving tick
            return paged_decode_step(params, cfg, pcfg, tok, None, cache, cents, n_bound=ctx)

        def rewind():
            cache["seq_r"].zero_()
    else:
        run_mode = "dense" if mode == "dense" else "pq_kernel"

        def step(i):
            return llama.decode_step(params, cfg, tok, fill + i, cache, cents, mode=run_mode)

        def rewind():
            cache.update({"length": fill} if mode == "dense" else {"r": 0})

    for i in range(2):  # warm-up (and the kernel build)
        step(i)
    rewind()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    rewind()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in dev_events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = busy_us(dev_events) / steps / 1e3
    print(f"[{mode}] bs={bs} ctx={ctx} step {wall_ms:.3f} ms (host clock, no profiler); device busy "
          f"{busy:.3f} ms/step; idle share {max(0.0, 1 - busy / wall_ms):.3f}; "
          f"{len(dev_events) / steps:.0f} kernels/step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / steps / 1e3:8.4f} ms/step  {name[:110]}")
    del cache


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--modes", default="dense,pq:dm2,pq:dm4_outlier_c128")
    ap.add_argument("--ctx", type=int, default=CTX, help="cache tokens (a multiple of 2048)")
    args = ap.parse_args()
    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA device")
    cfg = llama.PRESETS["llama-3.2-3b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev)
    for mode in args.modes.split(","):
        profile_mode(params, cfg, args.bs, mode, args.steps, gen, dev, args.ctx)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""Where a decode step's time goes on the card: llama-3.2-3b at full width,
a synthetic 32K cache (random codes as bench.py builds them), decode steps
timed on the host clock and then traced with torch.profiler.

    python3 -m million_tpu_torch.benchmarks.decode_profile [--bs 4] [--steps 8]

For each mode (dense bf16 KV, pq_kernel dm2, pq_kernel dm4_outlier_c128) it
prints the step time (host clock around synchronised steps), the device's
busy time per step (union of the traced kernels' intervals), the idle
share, and the kernels that take most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch

from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama

CTX, FILL = 32768, 32768 - 512
GEOMETRIES = {"dm2": (64, 256, 0), "dm4_outlier_c128": (32, 128, 16)}


def synthetic_state(cfg, bs, mode, gen, dev):
    """A cache filled to FILL tokens with random contents, and its cents."""
    L, nk, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if mode == "dense":
        c = init_dense_state(DenseCacheConfig(bs=bs, nh_k=nk, d=d, N_max=CTX), L, device=dev)
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
        c["length"] = FILL
        return c, None
    M, C, O = GEOMETRIES[mode.split(":")[1]]
    c = init_state(PQCacheConfig(bs=bs, nh_k=nk, d=d, M=M, C=C, N_max=CTX, OK=O, OV=O), L, device=dev)
    for side in ("key", "value"):
        c[side + "_codes"].copy_(torch.randint(0, C, c[side + "_codes"].shape, generator=gen,
                                               device=dev, dtype=torch.uint8))
        if O:
            c[side + "_outliers"].normal_(generator=gen)
    c["n_codes"] = FILL
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


def profile_mode(params, cfg, bs, mode, steps, gen, dev):
    cache, cents = synthetic_state(cfg, bs, mode, gen, dev)
    run_mode = "dense" if mode == "dense" else "pq_kernel"
    tok = torch.zeros((bs,), dtype=torch.long, device=dev)

    def step(i):
        return llama.decode_step(params, cfg, tok, FILL + i, cache, cents, mode=run_mode)

    for i in range(2):  # warm-up (and the kernel build)
        step(i)
    if run_mode != "dense":
        cache["r"] = 0
    else:
        cache["length"] = FILL
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    if run_mode != "dense":
        cache["r"] = 0
    else:
        cache["length"] = FILL
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
    print(f"[{mode}] bs={bs} step {wall_ms:.3f} ms (host clock, no profiler); device busy "
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
    args = ap.parse_args()
    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA device")
    cfg = llama.PRESETS["llama-3.2-3b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev)
    for mode in args.modes.split(","):
        profile_mode(params, cfg, args.bs, mode, args.steps, gen, dev)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

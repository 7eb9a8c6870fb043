"""Where one chunk of the chunked prefill spends its time on the card:
llama-3.2-3b at full width and depth, a synthetic cache holding the history of
the earlier chunks (random codes), one 4096-token chunk run through every
layer, timed on the host clock and then traced with torch.profiler.

    python3 -m million_tpu_torch.benchmarks.prefill_profile [--bs 4] [--n-prev 24576]

For each geometry (dm2, dm4_outlier_c128) it prints the chunk's time (host
clock around a synchronised run), the device's busy time, the idle share and
the kernels that take most device time, the hand-written ones by name
(pq_chunk_attention*, causal_*, pq_encode*). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch

from million_tpu_torch.benchmarks.decode_profile import busy_us, synthetic_state
from million_tpu_torch.models import llama
from million_tpu_torch.models.chunked_prefill import _prefill_one_chunk

CHUNK = 4096


def profile_chunk(params, cfg, bs, geom, n_prev, gen, dev):
    cache, cents = synthetic_state(cfg, bs, "pq:" + geom, gen, dev)
    ids = torch.randint(0, cfg.vocab_size, (bs, CHUNK), generator=gen, device=dev)

    def chunk():
        cache["n_codes"], cache["r"] = n_prev, 0
        return _prefill_one_chunk(params, cfg, ids, cache, cents, n_prev, last_chunk=False)

    chunk()  # warm-up (and the kernel builds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        chunk()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in dev_events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = busy_us(dev_events) / 1e3
    print(f"[{geom}] bs={bs} chunk of {CHUNK} tokens over {n_prev} history tokens: {wall_ms:.1f} ms "
          f"(host clock, no profiler); device busy {busy:.1f} ms; idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}; {len(dev_events)} kernels")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.2f} ms  {name[:110]}")
    del cache


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--n-prev", type=int, default=24576, help="history tokens before the chunk")
    ap.add_argument("--geometries", default="dm2,dm4_outlier_c128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prefill_profile needs a CUDA device")
    dev = torch.device("cuda")
    cfg = llama.PRESETS["llama-3.2-3b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev)
    for geom in args.geometries.split(","):
        profile_chunk(params, cfg, args.bs, geom, args.n_prev, gen, dev)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

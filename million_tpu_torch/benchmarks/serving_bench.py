"""Continuous-batching serving benchmark on one NVIDIA GPU.

Counterpart of million_tpu/benchmarks/serving_bench.py, with its three
protocols:

  mixed-length arrivals (default: neither --steady nor --preempt-demo):
    --requests prompts (default 16) whose lengths are drawn from 4
    word-aligned buckets between --min-prompt and --max-prompt (defaults 128
    and 1,024), --max-new 64 new tokens each, 8 slots of 512-token pages (32
    a slot). A warm-up scheduler serves one request per bucket first; a
    fresh one is then timed through an explicit tick loop that samples the
    pool from the host mirrors (no device reads): generated tokens/s,
    requests/s, pool pages, peak pages in use, mean requests in flight,
    preemptions and the pages a worst-case reservation would have charged
    against those allocated on demand.
  steady state (--steady TICKS): fill every slot with a max-prompt
    request, then time pure decode steps: steady tokens/s, per-token p50 and
    p90, and the steps that pay flush_paged_slots. The admission wall (with
    the first chain of decode ticks) is reported separately. The scheduler
    never waits for the device beyond its pipelined token readback, so the
    host clock around un-synced steps IS the tick time once the pipeline is
    full; each step records (wall, chained ticks) and the percentiles are
    over wall / ticks.
  --profile-admission: trace the admission step with torch.profiler and
    report its device busy time, idle share and the kernels that take most
    of it (use with --steady 0 to stop after admission).
  --preempt-demo: admit max_seqs long prompts into a pool sized so that
    on-demand growth cannot be satisfied for every slot, run every request
    to completion and verify that no token is lost: each finished request
    has exactly --max-new tokens and the tokens stashed at preemption time
    are a prefix of its final output.

Weights are random from --seed, codebooks synthetic (standard normal; the
outlier geometries get 16 + 16 exact channels with zero centroid components).
Every result line carries the card's name and power limit.

Run:  python3 -m million_tpu_torch.benchmarks.serving_bench            # mixed lengths
      python3 -m million_tpu_torch.benchmarks.serving_bench \\
          --preset llama-3.2-3b --max-seqs 6 --max-prompt 32640 \\
          --page-size 2048 --pages-per-seq 17 --pool-pages 104 --steady 40
The steady and preemption modes default to 6 slots of 32,640-token prompts in
2048-token pages (17 a slot), the mixed mode to the reference's 8 slots of
512-token pages (32 a slot) and prompts of 128-1,024 tokens.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
from million_tpu_torch.convert import cents_from_numpy
from million_tpu_torch.models.llama import PRESETS, init_params
from million_tpu_torch.runtime.sampling import SamplingConfig
from million_tpu_torch.runtime.scheduler import Request, Scheduler

GEOMETRIES = {  # name -> (d_m, C, exact outlier channels per side)
    "dm2": (2, 256, 0),
    "dm4_outlier": (4, 256, 16),
    "dm4_outlier_c128": (4, 128, 16),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synthetic_cents(L: int, d: int, geometry: str, rng: np.random.Generator):
    """Standard-normal codebooks (L, M, C, d_m); outlier geometries get
    sorted random exact channels whose centroid components are 0 (strided
    layout: channel c is component c // M of subspace c % M)."""
    d_m, C, O = GEOMETRIES[geometry]
    M = d // d_m
    cents = {side: rng.standard_normal((L, M, C, d_m)).astype(np.float32) for side in ("key", "value")}
    if O:
        for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")):
            idx = np.sort(rng.choice(d, O, replace=False)).astype(np.int32)
            for c in idx:
                cents[side][:, c % M, :, c // M] = 0.0
            cents[name] = np.stack([idx] * L)
    return cents, M, C, O


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def steady_state(args, cfg, pcfg, make_scheduler, card):
    S = pcfg.max_seqs
    n = (args.max_prompt // 4) * 4
    rng = np.random.default_rng(args.seed)
    sched = make_scheduler()
    dev = sched.device
    t0 = time.perf_counter()
    for rid in range(S):
        sched.submit(Request(rid, rng.integers(0, cfg.vocab_size, n), 1 << 30))
    profile = {}
    if args.profile_admission:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            sched.step()
            _sync(dev)
        admit_wall = time.perf_counter() - t0
        profile = admission_profile(prof, admit_wall)
    else:
        sched.step()  # admits all S (capacity permitting) + the first chain of decode ticks
        _sync(dev)
        admit_wall = time.perf_counter() - t0
    act = sum(r is not None for r in sched.slot_req)
    log(f"admitted {act}/{S} slots of {n}-token prompts in {admit_wall:.2f} s")

    ticks, flush_ticks, n_tok = [], [], 0
    T0 = time.perf_counter()
    for _ in range(args.steady):
        will_flush = any(sched.slot_r[i] >= pcfg.Lt
                         for i, r in enumerate(sched.slot_req) if r is not None)
        before = sched.ticks_dispatched
        t1 = time.perf_counter()
        n_tok += sched.step()
        dt = time.perf_counter() - t1
        (flush_ticks if will_flush else ticks).append(dt / max(sched.ticks_dispatched - before, 1))
    sched.drain()
    _sync(dev)
    total = time.perf_counter() - T0
    p50 = float(np.median(ticks)) if ticks else None  # None: every step flushed (Lt <= tick_chain)
    flush_med = float(np.median(flush_ticks)) if flush_ticks else None
    print(json.dumps({
        "metric": f"steady-state serving decode, {args.preset}, {act} slots x {n}-token context "
                  "(paged PQ, window-flush batching)",
        "value": n_tok / total,
        "unit": "generated tokens/s",
        "tick_p50_ms": p50 * 1e3 if p50 else None,
        "tick_p90_ms": float(np.percentile(ticks, 90)) * 1e3 if ticks else None,
        "flush_tick_ms": flush_med * 1e3 if flush_med else None,
        "flush_over_p50": flush_med / p50 if flush_med and p50 else None,
        "admission_s": admit_wall,
        "steps": args.steady,
        "tick_chain": sched.tick_chain,
        "ticks_dispatched": sched.ticks_dispatched,
        "tokens": n_tok,
        "preemptions": sched.preemptions,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None,
        "geometry": args.geometry,
        **profile,
        "card": card,
    }))


def admission_profile(prof, wall_s: float) -> dict:
    """Device busy time, idle share and the top kernels of a traced admission
    (the wall includes the profiler's own cost)."""
    from collections import defaultdict

    from million_tpu_torch.benchmarks.decode_profile import busy_us

    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy_s = busy_us(events) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"admission traced: wall {wall_s:.3f} s (with the profiler), device busy {busy_s:.3f} s, "
        f"{len(events)} kernels")
    for name, us in top:
        log(f"    {us / 1e6:8.3f} s  {name[:110]}")
    return {"admission_traced_wall_s": wall_s, "admission_device_busy_s": busy_s,
            "admission_idle_share": max(0.0, 1 - busy_s / wall_s),
            "admission_top_kernels_s": {name[:80]: us / 1e6 for name, us in top}}


def preempt_demo(args, cfg, pcfg, make_scheduler, card):
    S = pcfg.max_seqs
    n = (args.max_prompt // 4) * 4
    rng = np.random.default_rng(args.seed)
    sched = make_scheduler()
    for rid in range(S):
        sched.submit(Request(rid, rng.integers(0, cfg.vocab_size, n), args.max_new))
    stashes = {}  # rid -> tokens captured the moment it was preempted
    seen_preempt = 0
    t0 = time.perf_counter()
    ticks = 0
    while sched.waiting or any(r is not None for r in sched.slot_req):
        if sched.step() == 0 and sched.waiting:
            raise RuntimeError("preempt demo stalled")
        ticks += 1
        if sched.preemptions > seen_preempt:
            seen_preempt = sched.preemptions
            for rid, toks in sched._preempt_saved.items():
                stashes.setdefault(rid, list(toks))
        if ticks > 200000:
            raise RuntimeError("runaway preempt demo")
    sched.drain()
    wall = time.perf_counter() - t0
    fin = {f.rid: f.tokens for f in sched.finished}
    continuity = True
    for rid, pre in stashes.items():
        got = list(fin[rid][: len(pre)])
        if got != pre:
            continuity = False
            log(f"CONTINUITY VIOLATION rid {rid}: stash {pre[:8]}... vs final {got[:8]}...")
    lens_ok = all(len(t) == args.max_new for t in fin.values())
    print(json.dumps({
        "metric": f"preemption demo, {args.preset}, {S} slots x {n}-token prompts x "
                  f"{args.max_new} new, pool {pcfg.n_pages} pages (undersized for combined growth)",
        "value": sum(len(t) for t in fin.values()) / wall,
        "unit": "generated tokens/s",
        "preemptions": sched.preemptions,
        "requests": len(fin),
        "all_lengths_exact": lens_ok,
        "stash_continuity_ok": continuity,
        "stashed_rids": sorted(stashes),
        "wall_s": wall,
        "card": card,
    }))
    if not (sched.preemptions > 0 and continuity and lens_ok and len(fin) == S):
        raise SystemExit("preempt demo FAILED its invariants")


def prompt_buckets(min_prompt: int, max_prompt: int):
    """The 4 word-aligned prompt lengths of the mixed mode, between
    min_prompt and max_prompt."""
    return sorted({(min_prompt + k * (max_prompt - min_prompt) // 3) // 4 * 4 for k in range(4)})


def mixed(args, cfg, pcfg, make_scheduler, card):
    """The reference's default protocol: a stream of mixed-length requests
    through one scheduler, ticked explicitly to sample pool use from the host
    mirrors. Returns the result row (also printed as one JSON line)."""
    rng = np.random.default_rng(args.seed)
    buckets = prompt_buckets(args.min_prompt, args.max_prompt)
    # warm every shape (one request per bucket and the decode ticks) on a throwaway scheduler, freed
    # before the measured one is built
    warm = make_scheduler()
    for i, n in enumerate(buckets):
        warm.submit(Request(-1 - i, np.zeros(n, np.int64), 2))
    warm.run_to_completion()
    dev = warm.device
    del warm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sched = make_scheduler()
    total_prompt = 0
    for rid in range(args.requests):
        n = int(rng.choice(buckets))
        total_prompt += n
        sched.submit(Request(rid, rng.integers(0, cfg.vocab_size, n), args.max_new))
    _sync(dev)
    t0 = time.perf_counter()
    peak_pages = inflight_acc = worst_case_acc = ticks = 0
    while sched.waiting or any(r is not None for r in sched.slot_req):
        if sched.step() == 0 and sched.waiting:
            raise RuntimeError("scheduler stalled")
        ticks += 1
        peak_pages = max(peak_pages, int(sched.slot_pages.sum()))
        act = [i for i, r in enumerate(sched.slot_req) if r is not None]
        inflight_acc += len(act)
        # the pages a worst-case reservation (prompt + max_new + one window) would charge for the same
        # requests in flight
        worst_case_acc += sum(-(-(len(sched.slot_req[i].prompt) + sched.slot_req[i].max_new_tokens + pcfg.Lt)
                                // pcfg.page_size) for i in act)
        if ticks > 100000:
            raise RuntimeError("runaway serving bench")
    sched.drain()
    _sync(dev)
    wall = time.perf_counter() - t0
    finished = sched.finished
    n_gen = sum(len(f.tokens) for f in finished)
    if len(finished) != args.requests:
        raise RuntimeError(f"served {len(finished)} of {args.requests} requests")
    log(f"served {len(finished)} requests | prompt tokens {total_prompt} | generated {n_gen} | wall {wall:.2f} s")
    row = {
        "metric": f"serving throughput, {args.preset}, {args.requests} reqs x {args.max_new} new tokens, "
                  f"{pcfg.max_seqs} slots (paged PQ, continuous batching)",
        "value": n_gen / wall,
        "unit": "generated tokens/s",
        "requests_per_s": len(finished) / wall,
        "pool_pages": pcfg.n_pages,
        "peak_pages_used": peak_pages,
        "mean_in_flight": inflight_acc / max(ticks, 1),
        "preemptions": sched.preemptions,
        "worst_case_overcommit": worst_case_acc / max(inflight_acc, 1),
        "card": card,
    }
    print(json.dumps(row), flush=True)
    return row, sched


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="llama-3.2-3b", choices=sorted(PRESETS))
    ap.add_argument("--max-new", type=int, default=64,
                    help="new tokens per request (mixed and --preempt-demo)")
    ap.add_argument("--requests", type=int, default=16, help="requests of the mixed mode")
    ap.add_argument("--min-prompt", type=int, default=128, help="shortest prompt bucket (mixed mode)")
    ap.add_argument("--max-prompt", type=int, default=None,
                    help="longest prompt (default 1024 mixed, 32640 steady / preempt demo)")
    ap.add_argument("--max-seqs", type=int, default=None, help="scheduler slots (default 8 mixed, else 6)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per page (default 512 mixed, else 2048); the card needs a multiple of 256")
    ap.add_argument("--pages-per-seq", type=int, default=None, help="(default 32 mixed, else 17)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="page-pool size (default max_seqs * pages_per_seq); shrink it below the "
                    "worst-case demand to exercise on-demand growth and preemption")
    ap.add_argument("--lt", type=int, default=128, help="residual window rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--admit-chunk", type=int, default=2048, help="chunked-admission chunk length")
    ap.add_argument("--geometry", default="dm2", choices=sorted(GEOMETRIES))
    ap.add_argument("--steady", type=int, default=0, metavar="STEPS",
                    help="steady-state mode: timed scheduler steps after admission (0: the mixed mode, "
                    "unless --preempt-demo)")
    ap.add_argument("--tick-chain", type=int, default=8, help="most decode ticks chained per step")
    ap.add_argument("--preempt-demo", action="store_true")
    ap.add_argument("--profile-admission", action="store_true",
                    help="trace the admission step (steady-state mode)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (small presets only)")
    args = ap.parse_args(argv)
    is_mixed = not (args.steady or args.preempt_demo or args.profile_admission)
    for name, mixed_default, full_default in (("max_prompt", 1024, 32640), ("max_seqs", 8, 6),
                                              ("page_size", 512, 2048), ("pages_per_seq", 32, 17)):
        if getattr(args, name) is None:
            setattr(args, name, mixed_default if is_mixed else full_default)

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (not a device measurement)"
    if dev.type == "cuda":  # build the kernels now, so that no timed phase pays for nvcc
        from concurrent.futures import ThreadPoolExecutor

        from million_tpu_torch.ops.cuda_build import build

        with ThreadPoolExecutor(max_workers=3) as pool:
            list(pool.map(build, ("pq_paged_attention", "pq_chunk_attention", "pq_encode")))
    cfg = PRESETS[args.preset]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    cents, M, C, O = synthetic_cents(cfg.num_layers, cfg.head_dim, args.geometry,
                                     np.random.default_rng(args.seed))
    tables = cents_from_numpy(cents, device=dev)
    pcfg = PagedPQCacheConfig(
        num_layers=cfg.num_layers, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M, C=C, Lt=args.lt,
        page_size=args.page_size, n_pages=args.pool_pages or args.max_seqs * args.pages_per_seq,
        max_seqs=args.max_seqs, pages_per_seq=args.pages_per_seq, dtype=cfg.dtype, OK=O, OV=O)

    def make_scheduler():
        return Scheduler(params, cfg, pcfg, tables, SamplingConfig(), seed=args.seed,
                         admit_chunk=args.admit_chunk, tick_chain=args.tick_chain, device=dev)

    log(f"card: {card}")
    if is_mixed:
        mixed(args, cfg, pcfg, make_scheduler, card)
    else:
        (preempt_demo if args.preempt_demo else steady_state)(args, cfg, pcfg, make_scheduler, card)


if __name__ == "__main__":
    main()

"""Benchmark timing by a chain of dependent calls.

Counterpart of million_tpu/utils/timing.py. `step` maps a state to the next
state, and every call consumes the previous call's output, so every call has
to run; the chain is timed as a whole, after a warm-up, and repeated inside
one invocation for a spread. On a card the chain is timed with CUDA events on
the current stream (the device's own clock, so the host's launch time counts
only where it holds the device back); on the CPU with time.perf_counter.

The reference differences two chain lengths to cancel a fixed device-to-host
round trip of its TPU runtime (its module note). A CUDA event pair has no
such fixed cost, so the port times one chain of `iters` calls.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch


def _first_tensor(x: Any) -> Optional[torch.Tensor]:
    """The first tensor in a state made of tensors, tuples, lists and dicts."""
    if torch.is_tensor(x):
        return x
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (tuple, list)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _chain_seconds(step: Callable[[Any], Any], factory: Callable[[], Any], n: int) -> float:
    """Seconds per call of a chain of n calls from a fresh state."""
    st = factory()
    t = _first_tensor(st)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            st = step(st)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        st = step(st)
    return (time.perf_counter() - t0) / n


def chained_bench_stats(step: Callable[[Any], Any], init_state: Any, iters: int = 30, warmup: int = 2,
                        repeats: int = 5) -> dict:
    """Seconds per call of `step`, a state -> state function, over `repeats`
    chains of `iters` calls, each from a fresh state, after `warmup` calls:
    {"p50", "p10", "p90", "samples"}. `init_state` is a state or a zero-
    argument callable that makes one (use that when `step` updates its state
    in place, so each chain starts from the same state)."""
    if iters < 1 or repeats < 1:
        raise ValueError("iters and repeats must be at least 1")
    factory = init_state if callable(init_state) else (lambda: init_state)
    st = factory()
    for _ in range(warmup):
        st = step(st)
    t = _first_tensor(st)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    del st
    arr = np.asarray([_chain_seconds(step, factory, iters) for _ in range(repeats)])
    return {
        "p50": float(np.median(arr)),
        "p10": float(np.percentile(arr, 10)),
        "p90": float(np.percentile(arr, 90)),
        "samples": [float(x) for x in arr],
    }


def chained_bench(step: Callable[[Any], Any], init_state: Any, iters: int = 30, warmup: int = 2) -> float:
    """Seconds per call of `step` over one chain of `iters` calls after
    `warmup` calls (chained_bench_stats with one repeat)."""
    return chained_bench_stats(step, init_state, iters, warmup, repeats=1)["p50"]

"""Tracing and timing utilities: the reference's Timer / Ticker subsystem
over torch.profiler and CUDA synchronisation.

Counterpart of million_tpu/utils/profiling.py:
  * named_scope        - torch.profiler.record_function: a named range in a
                         trace (the Timer names of the reference's ranges);
  * trace              - a torch.profiler context (CPU and, with a card, CUDA
                         activity), exported as a Chrome trace if asked;
  * StepTimer          - host wall-clock phases, the card synchronised at the
                         boundaries when the phase's result lives on it;
  * Ticker             - per-token host timestamps for TTFT / TPOT;
  * device_memory_report - live / peak / total bytes of the card
                         (torch.cuda.memory_stats);
  * trace_op_breakdown - total time per op or kernel name of one call, from
                         the profiler's events (CUDA kernel time on the card,
                         CPU op time on the CPU), in place of the reference's
                         xplane harvest.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

named_scope = torch.profiler.record_function  # with named_scope("attn.decode"): ...


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """Profile the enclosed block; yields the profiler. With `path` the
    trace is written there as a Chrome trace (JSON) on exit."""
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    if path is not None:
        prof.export_chrome_trace(path)


def _force(x: Any) -> None:
    """Synchronise the card if any tensor in x (nested lists, tuples, dicts)
    lives on it."""
    stack = [x]
    while stack:
        y = stack.pop()
        if isinstance(y, torch.Tensor):
            if y.is_cuda:
                torch.cuda.synchronize(y.device)
                return
        elif isinstance(y, dict):
            stack.extend(y.values())
        elif isinstance(y, (list, tuple)):
            stack.extend(y)


class StepTimer:
    """Named wall-clock phases with device forcing at the boundaries."""

    def __init__(self):
        self.durations: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result: Any = None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            _force(result)
        dt = time.perf_counter() - t0
        self.durations[name] = self.durations.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_s": v / self.counts[k]}
            for k, v in self.durations.items()
        }


class Ticker:
    """Per-event host timestamps (the reference's Ticker)."""

    def __init__(self):
        self.ticks: List[float] = []

    def tick(self) -> None:
        self.ticks.append(time.perf_counter())

    @property
    def intervals(self) -> np.ndarray:
        return np.diff(np.asarray(self.ticks))

    def tpot_ttft(self) -> Dict[str, float]:
        iv = self.intervals
        if len(iv) == 0:
            return {"ttft_s": float("nan"), "tpot_s": float("nan")}
        return {
            "ttft_s": float(iv[0]),
            "tpot_s": float(iv[1:].mean()) if len(iv) > 1 else float("nan"),
        }


def device_memory_report(device=None) -> Optional[Dict[str, float]]:
    """Live / peak bytes allocated by PyTorch on the card and its total
    memory; None without a card."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda") if device is None else torch.device(device)
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


def trace_op_breakdown(fn, *, device="cuda", top: int = 12) -> Dict[str, float]:
    """Run `fn()` under torch.profiler and return the time per name (ms) of
    its `top` costliest entries: on a CUDA `device` the kernels by device
    time, on the CPU the ops by self time. Returns a dict with a
    "breakdown_error" key when the profile holds no such events (on the card:
    no device time was traced)."""
    on_card = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _force(fn())
    if on_card:
        tot = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0}
    else:
        tot = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages() if e.self_cpu_time_total > 0}
    if not tot:
        return {"breakdown_error": f"the profile recorded no {'device' if on_card else 'CPU'} time"}
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return {name: round(ms, 3) for name, ms in rows}

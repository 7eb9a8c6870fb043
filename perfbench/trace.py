"""Reading a torch.profiler trace of the traced segment: device operations
and their union (busy time), kernel time by name pattern, and the device's
idle gaps labelled with the innermost harness span the host was in."""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # the traced segment on the host clock
    busy_s: float  # union of device operations
    n_ops: int  # device operations (kernels, copies, sets)
    by_name: Dict[str, float]  # device seconds by operation name
    idle_by_span: Dict[str, float]  # idle device seconds by host span
    span_us: Tuple[float, float] = (0.0, 0.0)  # first device start, last device end (wall clock, us)

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, names matched) of operations whose name matches."""
        rx = re.compile(pattern)
        hits = [s for n, s in self.by_name.items() if rx.search(n)]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof, window_s: float, spans: List[Tuple[float, float, str]]) -> TraceSummary:
    """Device events of the profile (the raw kineto events: no tree of host
    operations is built; annotations on the device's timeline are not
    operations) and the host spans (start us, end us, name) on the same
    clock that label the idle gaps."""
    dev = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            dev.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()))
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e6
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    idle: Dict[str, float] = defaultdict(float)
    spans = sorted(spans)
    stack: List[Tuple[float, float, str]] = []  # open spans, innermost last (ranges nest)
    j = 0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while j < len(spans) and spans[j][0] <= a:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < a:
            stack.pop()
        idle[stack[-1][2] if stack else "harness"] += (b - a) / 1e6
    edges = (busy[0][0], busy[-1][1]) if busy else (0.0, 0.0)
    return TraceSummary(window_s, busy_s, len(dev), dict(by_name), dict(idle), edges)

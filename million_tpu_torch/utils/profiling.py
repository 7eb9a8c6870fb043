"""Tracing and timing: the port's one tracer, the profiler's exporter, the
card's memory and a per-kernel breakdown.

Counterpart of million_tpu/utils/profiling.py, whose Timer / Ticker
subsystem the serving path's spans and request events replace here:
  * TRACER             - the process's Tracer: counters (integer adds and host
                         clock differences, always on) and spans (recorded
                         while enabled or while torch.profiler records);
  * trace              - a torch.profiler context (CPU and, with a card, CUDA
                         activity), exported as a Chrome trace if asked; the
                         tracer's spans show in it beside the kernels;
  * device_memory_report - live / peak / total bytes of the card
                         (torch.cuda.memory_stats);
  * trace_op_breakdown - total time per op or kernel name of one call, from
                         the profiler's events (CUDA kernel time on the card,
                         CPU op time on the CPU), in place of the reference's
                         xplane harvest.

The scheduler (runtime/scheduler.py) is the tracer's writer; its spans and
counters are listed in its module docstring.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


@dataclasses.dataclass(eq=False)  # spans compare by identity
class Span:
    """One recorded range: its name, start and end on time.time_ns() (the
    clock of torch.profiler's device events, so a span lies against the
    device trace), its own id, the id of the span it was opened in, the
    request it serves where there is one, and a few attributes (ticks,
    slots, tokens, launches). An event is a span that ends where it starts."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    rid: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Scope:
    """Tracer.span's context manager: a span while the tracer records, and
    the range's host time added to a counter either way."""

    __slots__ = ("tracer", "name", "counter", "rid", "attrs", "span", "t0", "rf")

    def __init__(self, tracer: "Tracer", name: str, counter: Optional[str], rid, attrs: dict):
        self.tracer, self.name, self.counter, self.rid, self.attrs = tracer, name, counter, rid, attrs
        self.span = self.rf = None

    def __enter__(self) -> Optional[Span]:
        tr = self.tracer
        if tr.recording():
            self.t0 = time.time_ns()
            self.span = tr._open(self.name, self.t0, self.rid, self.attrs)
            if _autograd_profiler._is_profiler_enabled:
                self.rf = torch.profiler.record_function(self.name)
                self.rf.__enter__()
        elif self.counter is not None:
            self.t0 = time.time_ns()
        return self.span

    def __exit__(self, *exc) -> bool:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.span is None and self.counter is None:
            return False
        t1 = time.time_ns()
        if self.span is not None:
            self.tracer._close(self.span, t1)
        if self.counter is not None:
            self.tracer.counters[self.counter] += t1 - self.t0
        return False


class Tracer:
    """Counters and spans of one process (one thread writes them).

    Counters (`counters`, name -> int) are always on: the writer adds counts
    and host clock differences (ns) at its boundaries. Spans are recorded
    only while `enable()` holds or torch.profiler records (its own flag,
    checked as each span opens); under the profiler each span is also a
    torch.profiler.record_function range. At most `max_spans` are kept, in
    the order they end; `dropped` counts the rest."""

    def __init__(self, max_spans: int = 1 << 16):
        self.max_spans = max_spans
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.spans: List[Span] = []
        self.dropped = 0
        self._enabled = False
        self._open_spans: List[Span] = []
        self._last_id = 0

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def recording(self) -> bool:
        return self._enabled or _autograd_profiler._is_profiler_enabled

    def reset(self) -> None:
        """Zero the counters and forget every span."""
        self.counters.clear()
        self.spans.clear()
        self.dropped = 0
        self._open_spans.clear()

    def span(self, name: str, counter: Optional[str] = None, rid: Optional[int] = None, **attrs) -> _Scope:
        """`with tracer.span(name, counter) as sp:` records a span (sp is
        None while not recording) and adds the range's host ns to
        counters[counter] when a counter is named."""
        return _Scope(self, name, counter, rid, attrs)

    def event(self, name: str, rid: Optional[int] = None, **attrs) -> None:
        """A span of no length, in the span open now, while recording; under
        torch.profiler also an empty record_function range, so the event
        shows in the profile (and its Chrome trace) beside the kernels."""
        if self.recording():
            t = time.time_ns()
            self._keep(Span(name, t, t, self._new_id(), self._parent(), rid, attrs))
            if _autograd_profiler._is_profiler_enabled:
                with torch.profiler.record_function(name):
                    pass

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def _new_id(self) -> int:
        self._last_id += 1
        return self._last_id

    def _parent(self) -> Optional[int]:
        return self._open_spans[-1].id if self._open_spans else None

    def _open(self, name: str, t0: int, rid, attrs: dict) -> Span:
        sp = Span(name, t0, t0, self._new_id(), self._parent(), rid, attrs)
        self._open_spans.append(sp)
        return sp

    def _close(self, sp: Span, t1: int) -> None:
        sp.end_ns = t1
        if sp in self._open_spans:  # and whatever an exception left open inside it
            del self._open_spans[self._open_spans.index(sp):]
        self._keep(sp)

    def _keep(self, sp: Span) -> None:
        if len(self.spans) < self.max_spans:
            self.spans.append(sp)
        else:
            self.dropped += 1


TRACER = Tracer()


def device_memory_report(device=None) -> Optional[Dict[str, float]]:
    """Live / peak bytes allocated by PyTorch on the card and its total
    memory; None without a card or for a device that is not one."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if not torch.cuda.is_available() or dev.type != "cuda":
        return None
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

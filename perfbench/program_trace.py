"""The program's own spans and counters: million_tpu_torch's TRACER
(utils/profiling.py), which runtime/scheduler.py writes, reached through
perfbench.system, the benchmark's one module that imports the port. A
traced run records spans only inside its profiled segment, so every span
recorded belongs to it. A program without a tracer gives None."""

from __future__ import annotations

from typing import Optional

from perfbench import system


def tracer():
    return getattr(system.sched_mod, "TRACER", None)


def ms_per_dispatched_tick(span: str) -> Optional[float]:
    """Host ms of the recorded spans named `span` over the decode ticks the
    recorded scheduler.dispatch spans sent."""
    tr = tracer()
    if tr is None:
        return None
    ticks = sum(s.attrs["ticks"] for s in tr.named("scheduler.dispatch"))
    return sum(s.ns for s in tr.named(span)) / 1e6 / ticks if ticks else None

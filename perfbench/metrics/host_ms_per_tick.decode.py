"""Host wall of the window's Scheduler.step() calls over the decode ticks
they dispatched (ms/tick)."""

from perfbench.readers import step_ms_per_tick


def read(run):
    return step_ms_per_tick(run.phase_steps("window"))

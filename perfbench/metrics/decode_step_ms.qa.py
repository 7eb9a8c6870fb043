"""Host wall of the window's steps that admitted nothing, over the decode
ticks they dispatched (ms/tick)."""

from perfbench.readers import step_ms_per_tick


def read(run):
    return step_ms_per_tick([s for s in run.phase_steps("window") if not s.calls.admissions])

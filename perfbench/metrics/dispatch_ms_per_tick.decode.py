"""Host time the traced segment's scheduler.dispatch spans took (the
program's span around its chained decode ticks: issue, and any wait for a
full launch queue), over the ticks they sent (ms/tick)."""

from perfbench.program_trace import ms_per_dispatched_tick


def read(run):
    return ms_per_dispatched_tick("scheduler.dispatch")

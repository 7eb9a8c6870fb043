"""Host time the traced segment's scheduler.readback_wait spans took (the
program blocked on a step's token copy), over the ticks the segment's
scheduler.dispatch spans sent (ms/tick). 0 where no step had an event to
wait on."""

from perfbench.program_trace import ms_per_dispatched_tick


def read(run):
    return ms_per_dispatched_tick("scheduler.readback_wait")

"""Device operations (kernels, copies, sets) in the traced segment over the
decode ticks dispatched in it (launches/tick)."""

from perfbench.readers import ticks


def read(run):
    n = ticks(run.phase_steps("trace"))
    return run.trace.n_ops / n if run.trace is not None and n and run.trace.n_ops else None

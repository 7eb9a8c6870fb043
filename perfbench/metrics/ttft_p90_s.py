"""90th percentile, over the requests due in the window, of the end of the
step() in which the request left the waiting queue minus its due time (s).
A request that never left it counts until the run's end."""

from perfbench.readers import percentile


def read(run):
    end = run.steps[-1].t1
    return percentile([(r.first if r.first is not None else end) - r.due for r in run.window_requests()], 90)

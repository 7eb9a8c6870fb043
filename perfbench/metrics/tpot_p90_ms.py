"""90th percentile, over the requests due in the window that finished with
two tokens or more, of (finish - first token) / (tokens - 1) (ms)."""

from perfbench.readers import percentile


def read(run):
    return percentile([1e3 * (r.finish - r.first) / (len(r.tokens) - 1) for r in run.window_requests()
                       if r.finish is not None and r.first is not None and len(r.tokens) > 1], 90)

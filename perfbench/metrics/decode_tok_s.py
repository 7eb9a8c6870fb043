"""Output tokens read back to the host in the window, over the window (tokens/s)."""


def read(run):
    return run.tokens_in_window / (run.t1 - run.t0)

"""The model's operations (its architecture's counts) for the tokens the
window's steps processed, over the window, over the bf16 peak (%)."""

from perfbench.readers import mfu_pct


def read(run):
    return mfu_pct(run)

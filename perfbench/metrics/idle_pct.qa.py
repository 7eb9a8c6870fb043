"""Share of the traced segment in which no device operation ran (%)."""

from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run)

"""The program's admission counters (admission_ns: from each admission's
page allocation until its first token is on the host; admitted_tokens)
over the thousands of tokens admitted (ms/ktok): the cache fill of the
set-up. None unless the program admitted exactly the tokens of the
harness's set-up admissions."""

from perfbench.program_trace import tracer


def read(run):
    tr = tracer()
    if tr is None:
        return None
    tokens = tr.counters.get("admitted_tokens", 0)
    setup = sum(sum(a.lens) for s in run.phase_steps("setup") for a in s.calls.admissions)
    if not tokens or tokens != setup:
        return None
    return tr.counters["admission_ns"] / 1e6 / (tokens / 1e3)

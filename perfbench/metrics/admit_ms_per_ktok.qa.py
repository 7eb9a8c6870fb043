"""Host wall of the window's steps that admitted, over the thousands of
prompt tokens they admitted (ms/ktok)."""


def read(run):
    steps = [s for s in run.phase_steps("window") if s.calls.admissions]
    tokens = sum(sum(a.lens) for s in steps for a in s.calls.admissions)
    return 1e6 * sum(s.t1 - s.t0 for s in steps) / tokens if tokens else None

"""The device wall time of the traced segment's steps, each from its begin
event to its readback event (the program's scheduler.step spans, written
when their tokens were read), over their ticks (ms/tick). A gap inside a
step in which the card waits for the host to issue counts, so this reads
max(device work, host issue), not the card's busy time (idle_pct.decode
gives that). None without events (off the card)."""

from perfbench.program_trace import tracer


def read(run):
    tr = tracer()
    if tr is None:
        return None
    timed = [s for s in tr.named("scheduler.step") if "device_ns" in s.attrs]
    ticks = sum(s.attrs["device_ticks"] for s in timed)
    return sum(s.attrs["device_ns"] for s in timed) / 1e6 / ticks if ticks else None

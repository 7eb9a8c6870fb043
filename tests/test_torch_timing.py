"""utils/timing.py: chained_bench and chained_bench_stats, the port's
counterparts of million_tpu/utils/timing.py, on the CPU (host clock).

The protocol: every call of `step` receives the previous call's output (a
real data dependency), warm-up calls first, then `repeats` chains of `iters`
calls, each from a fresh state; the result is seconds a call as p10 / p50 /
p90 and the samples."""

import numpy as np
import pytest
import torch

from million_tpu_torch.utils.timing import chained_bench, chained_bench_stats


class Recorder:
    def __init__(self):
        self.seen = []

    def __call__(self, state):
        self.seen.append(state)
        return state + 1


def test_stats_call_count_and_chaining():
    step = Recorder()
    made = []

    def factory():
        made.append(0)
        return 100 * len(made)

    stats = chained_bench_stats(step, factory, iters=7, warmup=3, repeats=4)
    assert len(step.seen) == 3 + 4 * 7 and len(made) == 1 + 4
    # warm-up from the first state, then each chain from its own fresh state, every call fed the
    # previous one's output
    assert step.seen[:3] == [100, 101, 102]
    for k in range(4):
        start = 100 * (k + 2)
        assert step.seen[3 + 7 * k: 3 + 7 * (k + 1)] == list(range(start, start + 7))
    assert sorted(stats) == ["p10", "p50", "p90", "samples"]
    assert len(stats["samples"]) == 4 and all(s > 0 for s in stats["samples"])
    assert stats["p10"] <= stats["p50"] <= stats["p90"]
    assert stats["p50"] == pytest.approx(float(np.median(stats["samples"])))


def test_tensor_state_and_plain_state_object():
    """A tensor state (the decode chain's (token, cache)) and a state given
    as an object rather than a factory."""
    x = torch.zeros(4)
    calls = []

    def step(state):
        tok, cache = state
        calls.append(int(tok[0]))
        return tok + 1, cache

    s = chained_bench_stats(step, (x, {"k": torch.ones(2)}), iters=5, warmup=2, repeats=3)
    assert calls[:2] == [0, 1] and calls[2:7] == [0, 1, 2, 3, 4] and len(calls) == 2 + 15
    assert s["p10"] <= s["p50"] <= s["p90"]


def test_chained_bench_is_one_chain():
    step = Recorder()
    t = chained_bench(step, lambda: 0, iters=10, warmup=2)
    assert t > 0 and len(step.seen) == 12 and step.seen[2:] == list(range(10))


def test_rejects_empty_chains():
    with pytest.raises(ValueError):
        chained_bench_stats(lambda s: s, 0, iters=0)

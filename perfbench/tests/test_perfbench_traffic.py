"""The generator: deterministic for a seed, independent draws from it, a
Poisson schedule and log-uniform and uniform lengths."""

from __future__ import annotations

import json
import math

import numpy as np

from perfbench import traffic
from perfbench.manifest import ROOT

DOCQA = json.loads((ROOT / "perfbench" / "traffic" / "docqa.json").read_text())
MIX = {**DOCQA, "rate_per_s": 0.8}


def gen(seed, mix=MIX, horizon=120.0, **kw):
    return traffic.generate(mix, np.random.SeedSequence(seed), 32768, horizon, **kw)


def schedule(reqs):
    return [(r.due, len(r.prompt), r.max_new) for r in reqs]


def test_deterministic_for_a_seed():
    a, b = gen(2**31 + 11), gen(2**31 + 11)
    assert schedule(a) == schedule(b)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_another_seed_draws_another_schedule():
    a, b = gen(2**31 + 1), gen(2**31 + 2)
    assert sorted(len(r.prompt) for r in a) != sorted(len(r.prompt) for r in b)
    assert sorted(np.diff([0.0] + [r.due for r in a])) != sorted(np.diff([0.0] + [r.due for r in b]))


def test_a_longer_horizon_extends_the_same_arrivals():
    a, b = gen(2**31 + 4, horizon=60.0), gen(2**31 + 4, horizon=120.0)
    assert [r.due for r in a] == [r.due for r in b][:len(a)]
    assert a[-1].due > 60.0 and b[-1].due > 120.0 >= b[-2].due


def test_log_uniform_lengths():
    reqs = gen(5, horizon=3000.0)
    n = np.array([len(r.prompt) for r in reqs])
    p = MIX["prompt"]
    assert n.min() >= p["min"] and n.max() <= p["max"] and (n % p["multiple"] == 0).all()
    geo = math.sqrt(p["min"] * p["max"])
    assert abs((n < geo).mean() - 0.5) < 0.04
    # equal shares in each quarter of the log range
    q = np.log(n / p["min"]) / math.log(p["max"] / p["min"])
    assert np.histogram(q, bins=4, range=(0, 1))[0].min() > 0.2 * len(n)
    out = np.array([r.max_new for r in reqs])
    assert out.min() >= 32 and out.max() <= 128 and abs(out.mean() - 80) < 2


def test_poisson_schedule():
    reqs = gen(7, horizon=3000.0)
    gaps = np.diff([0.0] + [r.due for r in reqs])
    assert (gaps > 0).all()
    assert abs(gaps.mean() * MIX["rate_per_s"] - 1) < 0.06
    # an exponential law: 1 - 1/e of the gaps below the mean, and no memory from one gap to the next
    assert abs((gaps < 1 / MIX["rate_per_s"]).mean() - (1 - math.exp(-1))) < 0.03
    assert abs(np.corrcoef(gaps[:-1], gaps[1:])[0, 1]) < 0.1
    # nor between one prompt's length and the next
    n = np.log([len(r.prompt) for r in reqs])
    assert abs(np.corrcoef(n[:-1], n[1:])[0, 1]) < 0.1


def test_rate_override_and_closed_mix():
    assert len(gen(3, rate=2.0)) > len(gen(3))
    closed = json.loads((ROOT / "perfbench" / "traffic" / "decode-32k.json").read_text())
    reqs = traffic.generate(closed, np.random.SeedSequence(3), 32768, 30.0)
    assert len(reqs) == 16 and all(r.due is None for r in reqs)
    assert {len(r.prompt) for r in reqs} == {32640} and {r.max_new for r in reqs} == {4096}

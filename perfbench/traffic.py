"""The one traffic generator: a mix file's parameters and a seed -> the
requests of a run.

Every draw is independent and comes from the run's seed: the gaps between
arrivals are exponential (a Poisson process at the mix's rate), prompt and
answer lengths are drawn one by one from their distributions, token ids are
uniform over the vocabulary. A seed gives the same requests every time;
another seed gives another schedule, with its own bursts and its own runs
of long prompts, as users send them.

Mix keys: "kind" "closed" (every request submitted and admitted in set-up;
the window is their steady decode) or "open" (arrivals at "rate_per_s",
"arrivals": {"dist": "poisson"}); "requests" (closed); "prompt" and
"output": {"dist": "fixed", "tokens"} | {"dist": "loguniform" | "uniform",
"min", "max", "multiple"}.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RequestSpec:
    rid: int
    due: Optional[float]  # seconds after the window opens; None: submitted in set-up
    prompt: np.ndarray  # int64 token ids
    max_new: int


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n lengths drawn independently from the distribution `spec`."""
    dist = spec["dist"]
    if dist == "fixed":
        return np.full(n, int(spec["tokens"]), np.int64)
    lo, hi, mult = int(spec["min"]), int(spec["max"]), int(spec.get("multiple", 1))
    if dist == "loguniform":
        x = np.exp(rng.uniform(math.log(lo), math.log(hi), n))
    elif dist == "uniform":
        x = rng.uniform(lo, hi, n)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    top = hi // mult * mult  # the longest multiple of `multiple` within the range
    return np.clip(np.round(x / mult).astype(np.int64) * mult, lo, top)


def arrival_gaps(spec: dict, rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """n gaps between arrivals (s) of a Poisson process at `rate` per second."""
    if spec["dist"] != "poisson":
        raise ValueError(f"unknown arrival process {spec['dist']!r}")
    return rng.exponential(1.0 / rate, n)


def generate(mix: dict, seed_seq: np.random.SeedSequence, vocab: int, horizon_s: float,
             rate: Optional[float] = None) -> List[RequestSpec]:
    """The requests of one run. An open mix covers arrivals up to horizon_s
    after the window opens; `rate` overrides the mix's (the knee sweep)."""
    s_len, s_gap, s_ids = seed_seq.spawn(3)
    rng_len, rng_gap = np.random.default_rng(s_len), np.random.default_rng(s_gap)
    if mix["kind"] == "closed":
        n = int(mix["requests"])
        due = [None] * n
    elif mix["kind"] == "open":
        rate = float(rate if rate is not None else mix["rate_per_s"])
        due = []
        t = 0.0
        while t <= horizon_s:  # one gap at a time, so a longer horizon extends the same schedule
            t += float(arrival_gaps(mix["arrivals"], rate, 1, rng_gap)[0])
            due.append(t)
        n = len(due)
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    p_len = lengths(mix["prompt"], n, rng_len)
    o_len = lengths(mix["output"], n, rng_len)
    rng_ids = np.random.default_rng(s_ids)
    return [RequestSpec(i, due[i], rng_ids.integers(0, vocab, int(p_len[i]), dtype=np.int64),
                        int(o_len[i])) for i in range(n)]

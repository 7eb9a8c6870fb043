"""Helpers the metric readers share: percentiles, the steps of a phase,
and the model's operations over steps, counted by the cell's architecture."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from perfbench import roofline


def percentile(values, q: float) -> Optional[float]:
    """numpy's linear-interpolation percentile, or None without values."""
    values = list(values)
    return float(np.percentile(np.asarray(values, np.float64), q)) if values else None


def ticks(steps) -> int:
    return sum(len(s.calls.ticks) for s in steps)


def step_flops(plain, m: dict, steps) -> int:
    """The model's operations (the architecture's counts, `plain` its
    reference module) for the decode tokens and admitted prompts of these
    steps: a decode token at position p attends p + 1 keys and its logits are
    computed; a prompt is prompt_flops."""
    total = 0
    for s in steps:
        for t in s.calls.ticks:
            total += sum(plain.token_flops(m, int(p) + 1, True) for p in t.positions)
        for a in s.calls.admissions:
            total += sum(plain.prompt_flops(m, n) for n in a.lens)
    return total


def mfu_pct(run) -> Optional[float]:
    steps = run.phase_steps("window")
    if not steps:
        return None
    return 100.0 * step_flops(run.plain, run.config, steps) / (run.t1 - run.t0) / roofline.BF16_OPS_PER_S


def step_ms_per_tick(steps: List) -> Optional[float]:
    n = ticks(steps)
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / n if n else None


def idle_pct(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0 or t.n_ops == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

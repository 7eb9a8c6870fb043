"""Faults planted under the timed path, for the tests that see `correct`
come out false: each replaces a name the scheduler module calls, for the
length of a `with` block."""

from __future__ import annotations

import contextlib

import torch

from million_tpu_torch.runtime import scheduler as sched_mod


@contextlib.contextmanager
def _replaced(name, make):
    orig = getattr(sched_mod, name)
    setattr(sched_mod, name, make(orig))
    try:
        yield
    finally:
        setattr(sched_mod, name, orig)


def state_unchanged():
    """The window flush advances the counters but leaves the pools as they
    were: the flushed window's codes are never written."""
    def make(orig):
        def flush(pcfg, state, tables, mask, mesh=None):
            mask = torch.as_tensor(mask, dtype=torch.bool).to(state["seq_r"].device)
            state["seq_n_codes"] += torch.where(mask, pcfg.Lt, 0).to(torch.int32)
            state["seq_r"].copy_(torch.where(mask, 0, state["seq_r"]))
            return state
        return flush
    return _replaced("flush_paged_slots", make)


def half_batch():
    """The decode step computes the first half of the slots only; the other
    half are given the first half's logits."""
    def make(orig):
        def step(*a, **k):
            logits = orig(*a, **k)
            h = logits.shape[0] // 2
            logits[h:] = logits[:logits.shape[0] - h].clone()
            return logits
        return step
    return _replaced("paged_decode_step", make)


def token_altered():
    """Every fifth sampling call returns the next token id instead of the
    one sampled."""
    def make(orig):
        calls = [0]

        def sample(logits, *a, **k):
            tok = orig(logits, *a, **k)
            calls[0] += 1
            return (tok + 1) % logits.shape[-1] if calls[0] % 5 == 0 else tok
        return sample
    return _replaced("sample_on_mesh", make)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch, "token_altered": token_altered}

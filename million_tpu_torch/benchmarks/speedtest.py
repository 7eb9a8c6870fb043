"""End-to-end latency harness: TTFT and TPOT per prefill length.

Counterpart of million_tpu/benchmarks/speedtest.py, with its protocol:
random prompts drawn with numpy from the seed (the same ids in both
packages), greedy decode of `decode_length` tokens through the port's
runtime/generate.py, one row per prefill length. On the card TTFT and TPOT
are CUDA-event times (generate's clock), on the CPU host times.

An out-of-memory error at one length gives an {"oom": true} row and the
sweep goes on (the reference's IgnoreOOM): only torch.cuda.OutOfMemoryError
is caught, and the card's cache is freed. Any other error, a kernel's build
or launch failure among them, propagates.
"""

from __future__ import annotations

import functools
import gc
from typing import Any, Dict, List

import numpy as np
import torch

from million_tpu_torch.models import llama
from million_tpu_torch.runtime.generate import generate
from million_tpu_torch.runtime.sampling import SamplingConfig


def is_oom_error(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError)


def oom_guard(fn):
    """Run fn; on an out-of-memory error return {"oom": True, "error": ...}
    instead, after dropping the Python references and freeing the card's
    cache. Every other exception propagates."""

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        try:
            return fn(*a, **kw)
        except torch.cuda.OutOfMemoryError as e:
            msg = (str(e).splitlines() or ["out of memory"])[0][:200]
        # outside the handler, so that the traceback's frames no longer pin tensors
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return {"oom": True, "error": msg}

    return wrapped


def speedtest(
    params,
    cfg: llama.ModelConfig,
    make_cache,  # (prefill_len) -> fresh cache on the parameters' device
    cents,
    *,
    mode: str = "pq_kernel",
    prefill_lengths: List[int] = (1024, 4096),
    decode_length: int = 64,
    seed: int = 0,
    breakdown: bool = False,
) -> Dict[str, Any]:
    dev = params["embed"].device
    rng = np.random.default_rng(seed)
    rows = []
    for pl in prefill_lengths:
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, pl))).to(dev)

        def run():
            return generate(params, cfg, ids, make_cache(pl), cents, mode=mode,
                            max_new_tokens=decode_length, sampling=SamplingConfig(), device=dev)

        guarded = oom_guard(run)()
        if isinstance(guarded, dict):
            rows.append({"prefill_length": pl, **guarded})  # the sweep goes on past it
            continue
        res, _ = guarded
        row = {
            "prefill_length": pl,
            "decode_length": decode_length,
            "ttft_s": res.ttft_s,
            "tpot_s": res.tpot_s,
            "tokens_per_s": 1.0 / res.tpot_s if res.tpot_s > 0 else None,
        }
        if breakdown:
            # a second generate over the same shapes, profiled: time per
            # kernel (on the card) or per op (on the CPU)
            from million_tpu_torch.utils.profiling import trace_op_breakdown

            row["breakdown_ms"] = trace_op_breakdown(lambda: run()[0].tokens, device=dev)
        rows.append(row)
    return {"mode": mode, "results": rows}

"""Multiple-choice / loglikelihood accuracy evaluation.

Counterpart of million_tpu/benchmarks/lm_eval_adapter.py. Two paths:

  * `make_lm_eval_model` - an lm-eval `LM` subclass when the `lm_eval`
    package is installed (an optional import that raises a clear error);
  * `loglikelihood` / `evaluate_multiple_choice` - a self-contained
    evaluator of (context, continuation) pairs: one teacher-forced prefill
    on a fresh cache, the sum of the continuation's log-probabilities. In PQ
    modes the prefill runs with distort_recent, so the scores see a
    quantized history.

Only the continuation's positions go through the head (the prefill returns
hidden states), so no (n, V) logit tensor of the whole context is made.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from million_tpu_torch.models import llama


@torch.no_grad()
def loglikelihood(
    params,
    cfg: llama.ModelConfig,
    make_cache: Callable[[], object],
    cents,
    context_ids: Sequence[int],
    continuation_ids: Sequence[int],
    mode: str = "pq",
) -> float:
    """Sum log P(continuation | context) from one teacher-forced prefill."""
    dev = params["embed"].device
    ids = torch.tensor(list(context_ids) + list(continuation_ids), dtype=torch.long, device=dev)[None]
    pq = mode != "dense"
    x = llama.prefill(params, cfg, ids, make_cache(), cents, mode="pq" if pq else "dense",
                      distort_recent=pq, return_hidden=True)
    start = len(context_ids) - 1  # position whose logits predict the first continuation token
    n = len(continuation_ids)
    logp = F.log_softmax(llama._logits(params, cfg, x[0, start:start + n]).to(torch.float32), dim=-1)
    return float(logp.gather(-1, ids[0, start + 1:start + 1 + n, None]).sum())


def evaluate_multiple_choice(
    params,
    cfg: llama.ModelConfig,
    make_cache,
    cents,
    examples: List[Dict],
    mode: str = "pq",
) -> Dict[str, float]:
    """examples: [{"context_ids": [...], "choices_ids": [[...], ...],
    "label": int}] -> accuracy (argmax of the summed continuation log-prob,
    lm-eval's 'acc')."""
    correct = 0
    for ex in examples:
        scores = [loglikelihood(params, cfg, make_cache, cents, ex["context_ids"], ch, mode)
                  for ch in ex["choices_ids"]]
        correct += int(int(np.argmax(scores)) == ex["label"])
    return {"acc": correct / max(len(examples), 1), "n": len(examples)}


def make_lm_eval_model(params, cfg, make_cache, cents, tokenizer, mode="pq"):
    """An lm_eval.api.model.LM implementation over the port, where lm_eval
    is installed."""
    try:
        from lm_eval.api.model import LM
    except ImportError as e:
        raise RuntimeError(
            "lm_eval is not installed; use evaluate_multiple_choice for hermetic "
            "loglikelihood accuracy evaluation"
        ) from e

    class MillionLM(LM):
        def loglikelihood(self, requests):
            out = []
            for req in requests:
                ctx, cont = req.args
                ctx_ids = tokenizer(ctx)["input_ids"]
                cont_ids = tokenizer(cont, add_special_tokens=False)["input_ids"]
                out.append((loglikelihood(params, cfg, make_cache, cents, ctx_ids, cont_ids, mode), False))
            return out

        def loglikelihood_rolling(self, requests):
            raise NotImplementedError

        def generate_until(self, requests):
            raise NotImplementedError

    return MillionLM()

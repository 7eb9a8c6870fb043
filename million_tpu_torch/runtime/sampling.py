"""Token sampling for the decode loop (greedy / temperature / top-k).
Counterpart of million_tpu/runtime/sampling.py, with an explicit
torch.Generator in place of a JAX key."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filtering


def sample(
    logits: torch.Tensor,  # (bs, V) f32
    generator: Optional[torch.Generator] = None,
    cfg: SamplingConfig = SamplingConfig(),
) -> torch.Tensor:
    """Return (bs,) int64 token ids. Greedy takes the first maximum, as
    jnp.argmax does; sampling draws from `generator` (on logits' device)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]

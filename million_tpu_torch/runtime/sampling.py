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


def sample_on_mesh(logits: torch.Tensor, generator: Optional[torch.Generator],
                   cfg: SamplingConfig, mesh, gather_dp: bool = True) -> torch.Tensor:
    """`sample` on a mesh: the ranks' dp slices of the logits are gathered
    (gather_dp; False where every rank holds the whole batch), global rank 0
    samples the whole batch and broadcasts it, so that every rank emits the
    same tokens (the reference's single controller samples once). Returns
    the whole batch's (bs,) int64 tokens on every rank."""
    if mesh is None:
        return sample(logits, generator, cfg)
    full = mesh.all_gather(logits.contiguous(), "dp", dim=0) if gather_dp else logits
    if mesh.rank == 0:
        tok = sample(full, generator, cfg).to(torch.int64)
    else:
        tok = torch.empty(full.shape[0], dtype=torch.int64, device=full.device)
    return mesh.broadcast(tok, "world", 0)


def dp_slice(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's dp slice of a whole-batch tensor (dim 0)."""
    if mesh is None:
        return tokens
    n = mesh.size("dp")
    w = tokens.shape[0] // n
    return tokens[mesh.index("dp") * w:(mesh.index("dp") + 1) * w]

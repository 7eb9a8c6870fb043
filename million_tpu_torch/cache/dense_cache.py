"""Dense (uncompressed) KV cache, the bf16 baseline the PQ path is measured
against. Counterpart of million_tpu/cache/dense_cache.py; updated IN PLACE,
with the fill level `length` a host integer shared by all layers."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from million_tpu_torch import resolve_device

DenseCache = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DenseCacheConfig:
    bs: int
    nh_k: int
    d: int
    N_max: int = 32768
    dtype: Any = torch.bfloat16


def init_dense_state(cfg: DenseCacheConfig, num_layers: int, device="cuda") -> DenseCache:
    dev = resolve_device(device)
    shape = (num_layers, cfg.bs, cfg.nh_k, cfg.N_max, cfg.d)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "length": 0,
    }


def dense_write(state: DenseCache, layer: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k/v (bs, nh_k, n, d) of one layer at position `length`, in
    place; the caller advances `length` once after every layer."""
    s, n = state["length"], k.shape[2]
    if s + n > state["k"].shape[3]:
        raise ValueError(f"{n} tokens overflow the dense cache at {s}")
    state["k"][layer, :, :, s:s + n] = k
    state["v"][layer, :, :, s:s + n] = v

"""The inputs a run hands to both the program and the plain reference,
made on the device from the seed, in plain PyTorch: the codebooks here, the
weights by the architecture's reference/<architecture>.py. Codebooks are
standard normal (PQ layers, M, C, d_m), one table pair for each layer the
architecture keeps in the PQ pool; an outlier geometry keeps O exact
channels a side, whose centroid components are 0.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_seed(ss: np.random.SeedSequence) -> int:
    """A 63-bit seed for a torch.Generator from a numpy SeedSequence."""
    a, b = (int(x) for x in ss.generate_state(2, np.uint32))
    return ((a << 32) | b) & ((1 << 63) - 1)


def make_codebooks(m: dict, layers: Sequence[int], ss: np.random.SeedSequence,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """{"key", "value": (L, M, C, d_m) f32[, "k_outlier_idx", "v_outlier_idx":
    (L, O) int32]} of the configuration's "pq" geometry, L = len(layers) (the
    architecture's pq_layers: entry i is layer layers[i]'s), with M = head_dim
    / d_m (subspace m owns dims m, m + M, ...)."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(ss))
    L, d = len(layers), m["head_dim"]
    d_m, C, O = m["pq"]["d_m"], m["pq"]["C"], m["pq"]["outliers"]
    M = d // d_m
    tables = {side: torch.randn((L, M, C, d_m), generator=gen, device=device)
              for side in ("key", "value")}
    if O:
        for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")):
            idx = torch.sort(torch.randperm(d, generator=gen, device=device)[:O]).values
            tables[side][:, idx % M, :, idx // M] = 0.0
            tables[name] = idx.to(torch.int32)[None].expand(L, O).contiguous()
    return tables

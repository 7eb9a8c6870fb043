"""The inputs a run hands to both the program and the plain reference:
weights and codebooks made on the device from the seed, in plain PyTorch.

Weights follow the published widths of the configuration, in the layout the
port's model takes (a dict; per-layer weights stacked on a leading layer
axis, attention projections stored (out, in), MLP weights (in, out)): normal
with std sqrt(2 / (fan_in + fan_out)) over the last two axes, norms at 1,
drawn in the served type in one call per stacked tensor. Codebooks are
standard normal (layers, M, C, d_m); an outlier geometry keeps O exact
channels a side, whose centroid components are 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_seed(ss: np.random.SeedSequence) -> int:
    """A 63-bit seed for a torch.Generator from a numpy SeedSequence."""
    a, b = (int(x) for x in ss.generate_state(2, np.uint32))
    return ((a << 32) | b) & ((1 << 63) - 1)


def make_weights(m: dict, ss: np.random.SeedSequence, device: torch.device) -> Dict:
    gen = torch.Generator(device=device).manual_seed(torch_seed(ss))
    dt = DTYPES[m["torch_dtype"]]
    L, D, I, V = m["num_hidden_layers"], m["hidden_size"], m["intermediate_size"], m["vocab_size"]
    nh, nk, dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]

    def w(*shape):
        std = (2.0 / (shape[-2] + shape[-1])) ** 0.5
        return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(std)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dt)

    params = {
        "embed": w(V, D),
        "final_norm": ones(D),
        "layers": {
            "attn_norm": ones(L, D), "mlp_norm": ones(L, D),
            "wq": w(L, nh * dh, D), "wk": w(L, nk * dh, D), "wv": w(L, nk * dh, D),
            "wo": w(L, D, nh * dh),
            "w_gate": w(L, D, I), "w_up": w(L, D, I), "w_down": w(L, I, D),
        },
    }
    if m.get("attention_bias"):
        params["layers"].update(bq=w(L, nh * dh), bk=w(L, nk * dh), bv=w(L, nk * dh))
    if not m["tie_word_embeddings"]:
        params["lm_head"] = w(D, V)
    return params


def make_codebooks(m: dict, ss: np.random.SeedSequence, device: torch.device) -> Dict[str, torch.Tensor]:
    """{"key", "value": (L, M, C, d_m) f32[, "k_outlier_idx", "v_outlier_idx":
    (L, O) int32]} of the configuration's "pq" geometry, with M = head_dim /
    d_m (subspace m owns dims m, m + M, ...)."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(ss))
    L, d = m["num_hidden_layers"], m["head_dim"]
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

"""Plain PyTorch attention pieces: the softmax partials and their LSE
merges that the kernels' plain versions are built from, exact decode
attention, and prefill's causal attention.

Counterpart of million_tpu/ops/pq_attention_ref.py. The port's at-rest
layouts are token-major: codes (bs, nh_k, N, M) uint8 and exact outlier
channels (bs, nh_k, N, O) bf16 (million_tpu keeps codes subspace-major in
packed int32 words and outliers in byte planes; million_tpu_torch.convert
translates). GQA: query head h reads KV head h // (nh // nh_k).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def merge_partials(outs: torch.Tensor, lses: torch.Tensor, dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSE-merge partials stacked along `dim`: outs (..., S, ..., d) each
    normalised within its split, lses (..., S, ...). Returns (out, lse)."""
    lse_max = lses.amax(dim=dim, keepdim=True)
    w = torch.exp(lses - lse_max)
    denom = w.sum(dim)
    merged = (outs * w.unsqueeze(-1)).sum(dim) / denom.unsqueeze(-1)
    return merged, lse_max.squeeze(dim) + torch.log(denom)


def merge_two_partials(out_a, lse_a, out_b, lse_b):
    """merge_partials for exactly two partials, without a stack axis."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    denom = wa + wb
    merged = (out_a * wa[..., None] + out_b * wb[..., None]) / denom[..., None]
    return merged, m + torch.log(denom)


def _gqa_expand(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(bs, nh_k, ...) -> (bs, nh, ...) repeating each KV head nh/nh_k times."""
    rep = nh // x.shape[1]
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def _softmax_partial(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor, eq: str):
    """Masked softmax partial: s (..., n) f32 scores, mask broadcastable to s,
    v values; returns (out normalised within the partial, lse), with
    lse = -1e30 and out = 0 when nothing is valid."""
    s = torch.where(mask, s, NEG_INF)
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF / 2)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    den = p.sum(-1, keepdim=True)
    out = torch.einsum(eq, p, v) / torch.clamp(den, min=1e-30)
    lse = torch.where(
        den[..., 0] > 0, m[..., 0] + torch.log(torch.clamp(den[..., 0], min=1e-30)),
        torch.full_like(den[..., 0], NEG_INF),
    )
    return out, lse


def dense_decode_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Exact decode attention over a dense KV: q (bs, nh, d), k/v (bs, nh_k, n, d)."""
    bs, nh, d = q.shape
    if scale is None:
        scale = 1.0 / d**0.5
    k = _gqa_expand(k, nh).to(torch.float32)
    v = _gqa_expand(v, nh).to(torch.float32)
    s = torch.einsum("bhk,bhnk->bhn", q.to(torch.float32), k) * scale
    return torch.einsum("bhn,bhnk->bhk", torch.softmax(s, -1), v).to(q.dtype)


def causal_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """Causal attention for prefill: q (bs, nh, n, d), k/v (bs, nh_k, n, d).

    Calls torch's scaled_dot_product_attention (a library kernel, as the
    reference package calls JAX's stock flash kernel on the TPU). On the CPU
    the inputs are promoted to f32 first."""
    nh = q.shape[1]
    kf, vf = _gqa_expand(k, nh), _gqa_expand(v, nh)
    if q.device.type == "cpu":
        out = F.scaled_dot_product_attention(
            q.float(), kf.float(), vf.float(), is_causal=True, scale=scale)
        return out.to(q.dtype)
    return F.scaled_dot_product_attention(q, kf.to(q.dtype), vf.to(q.dtype), is_causal=True, scale=scale)


def masked_partial_attention(
    q: torch.Tensor,  # (..., G, d)
    k: torch.Tensor,  # (..., n, d)
    v: torch.Tensor,
    valid,  # int count of valid leading rows, or (n,) bool mask
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact partial attention over the valid rows -> (out f32, lse). With an
    int count the rows are sliced rather than masked (same values, fewer
    kernels on the decode path)."""
    qf = q.to(torch.float32)
    if isinstance(valid, torch.Tensor):
        s = torch.einsum("...gk,...nk->...gn", qf, k.to(torch.float32)) * scale
        return _softmax_partial(s, valid, v.to(torch.float32), "...gn,...nk->...gk")
    n = int(valid)
    if n <= 0:
        return (torch.zeros((*q.shape[:-1], v.shape[-1]), dtype=torch.float32, device=q.device),
                torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device))
    s = torch.einsum("...gk,...nk->...gn", qf, k[..., :n, :].to(torch.float32))
    if scale != 1.0:
        s = s * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("...gn,...nk->...gk", p, v[..., :n, :].to(torch.float32)) / den
    return out, (m + torch.log(den))[..., 0]

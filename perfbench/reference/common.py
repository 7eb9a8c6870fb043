"""The plain pieces every architecture's reference is built from, in plain
PyTorch and float32: weight products (exact, or with fp8 inputs for the
control), RMSNorm, rotary tables and rotation, the PQ round trip of a key or
value, and which keys a query block attends quantized.

Products with the weights, which are bf16 values, are exact f32 products:
on the card the f32 activation is split into three bf16 parts, exactly, and
each part is multiplied by the bf16 weight with f32 accumulation (TF32 off).
`precision="fp8"` is the control: every weight product takes e4m3 inputs
(per-row activation and per-column weight scales), as an fp8 serving path
would.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

ROW_BLOCK = 8192  # rows of the MLP and of the encode at a time
FP8_MAX = 448.0


def _split3(x: torch.Tensor):
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """x (R, K) f32 @ w (K, N) -> (R, N) f32."""
    if precision == "fp8":
        sx = x.abs().amax(dim=1, keepdim=True).clamp(min=1e-30) / FP8_MAX
        wf = w.float()
        sw = wf.abs().amax(dim=0, keepdim=True).clamp(min=1e-30) / FP8_MAX
        xq = (x / sx).to(torch.float8_e4m3fn)
        wq = (wf / sw).to(torch.float8_e4m3fn)
        if x.is_cuda:  # e4m3 values are exact in bf16; the products accumulate in f32
            y = torch.mm(xq.to(torch.bfloat16), wq.to(torch.bfloat16), out_dtype=torch.float32)
        else:
            y = xq.float() @ wq.float()
        return y * sx * sw
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    if x.is_cuda and w.dtype == torch.bfloat16:
        return sum(torch.mm(p, w, out_dtype=torch.float32) for p in _split3(x))
    return x @ w.float()


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rope_cos_sin(theta: float, d: int, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF's rotary tables in f32: (n, d/2) cos and sin of position x inverse
    frequency."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64, device=device).float() / d))
    ang = torch.arange(n, device=device).float()[:, None] * inv[None, :]
    return ang.cos(), ang.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (n, heads, d)."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def pq_roundtrip(x: torch.Tensor, cents: torch.Tensor, oidx: Optional[torch.Tensor]) -> torch.Tensor:
    """x (..., d) f32 -> its reconstruction from the nearest centroid of each
    subspace (cents (M, C, d_m), strided subspaces), outlier channels exact."""
    M, C, dm = cents.shape
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    out = torch.empty_like(flat)
    c = cents.float()
    c_sq = (c * c).sum(-1)  # (M, C)
    ar = torch.arange(M, device=x.device)[None, :]
    for s in range(0, flat.shape[0], ROW_BLOCK):
        xs = flat[s:s + ROW_BLOCK].reshape(-1, dm, M).transpose(1, 2)  # (r, M, dm)
        dist = torch.baddbmm(c_sq[:, None, :], xs.transpose(0, 1), c.transpose(1, 2), alpha=-2.0)
        codes = dist.argmin(-1).t()  # (r, M)
        out[s:s + ROW_BLOCK] = c[ar, codes].transpose(1, 2).reshape(-1, d)
    if oidx is not None:
        i = oidx.long()
        out[:, i] = flat[:, i]
    return out.reshape(x.shape)


def attention_blocks(n: int, N: int, chunk: Optional[int], Lt: int) -> List[Tuple[int, int, int]]:
    """(first query, end, b): query blocks [first, end) whose keys before b
    are quantized and from b on exact (causal)."""
    if chunk is None:
        blocks = [(0, n, 0)]
    else:
        blocks = [(s, min(s + chunk, n), s) for s in range(0, n, chunk)]
    n4 = n - n % 4
    t = n
    while t < N:
        b = n4 + Lt * ((t - n4) // Lt)
        end = min(b + Lt, N)
        blocks.append((t, end, b))
        t = end
    return blocks

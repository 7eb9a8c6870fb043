"""Core product-quantization ops: encode, decode, LUT construction.

PyTorch counterpart of million_tpu/pq/ops.py, with the same shape vocabulary:
  d    head dim; M subspaces; d_m = d // M; C codebook size;
  cents: (M, C, d_m) codebook tensor, one C-entry codebook per subspace.

`pq_encode` is a batched matmul plus argmin, as XLA computes it in the
reference package: the oracle, and the plain version of the fused encode
kernel (ops/pq_encode_kernel.py) that `runtime_encode` launches for CUDA
tensors. Codes are uint8 for C <= 256 and int16 for 256 < C <= 65,536 (the
reference package's wide codes, million_tpu/cache/pq_cache.py:65-68): a code
above 32,767 is stored as its bit pattern, and every reader takes
`code_index(codes)`, which reads it back unsigned.
"""

from __future__ import annotations

import torch

# Runtime encode precision (prefill and flush). "fast" rounds the encode's
# inputs to bf16 and accumulates in f32, the reference package's default;
# "exact" keeps f32 inputs.
RUNTIME_ENCODE_PRECISION = "fast"

# Runtime encode implementation: the fused kernel, which never writes the
# (rows, M, C) distances. The reference package keeps its fused TPU kernel
# off because a k = d_m contraction wastes the MXU; on CUDA cores that reason
# does not exist. CPU tensors take the kernel's plain version either way.
RUNTIME_FUSED_ENCODE = True

MAX_C = 1 << 16  # the widest codebook an int16 code indexes


def code_dtype(C: int) -> torch.dtype:
    """Storage type of a code of a C-entry codebook: uint8 up to 256, int16
    (the bit pattern of an unsigned 16-bit index) up to MAX_C."""
    if not 1 <= C <= MAX_C:
        raise ValueError(f"codebook size {C} is outside 1..{MAX_C}")
    return torch.uint8 if C <= 256 else torch.int16


def code_index(codes: torch.Tensor) -> torch.Tensor:
    """Codes of either storage type -> int64 centroid indices (int16 codes
    read back unsigned, as the reference's take wraps a negative index)."""
    return codes.long() & 0xFFFF


def subspace_view(x: torch.Tensor, M: int, layout: str = "contiguous") -> torch.Tensor:
    """Reshape (..., d) -> (..., M, d_m); the PQ subspace split.

    "contiguous": subspace m owns dims [m*d_m, (m+1)*d_m).
    "strided": subspace m owns dims {m, m+M, m+2M, ...} (the model's split).
    Returns a view where the layout allows one."""
    d = x.shape[-1]
    if d % M != 0:
        raise ValueError(f"head dim {d} not divisible by M={M}")
    d_m = d // M
    if layout == "contiguous":
        return x.reshape(*x.shape[:-1], M, d_m)
    if layout == "strided":
        return x.reshape(*x.shape[:-1], d_m, M).transpose(-1, -2)
    raise ValueError(f"unknown subspace layout {layout!r}")


def merge_subspaces(xs: torch.Tensor, layout: str = "contiguous") -> torch.Tensor:
    """Inverse of subspace_view: (..., M, d_m) -> (..., d)."""
    M, d_m = xs.shape[-2], xs.shape[-1]
    if layout == "contiguous":
        return xs.reshape(*xs.shape[:-2], M * d_m)
    if layout == "strided":
        return xs.transpose(-1, -2).reshape(*xs.shape[:-2], M * d_m)
    raise ValueError(f"unknown subspace layout {layout!r}")


def _cast_inputs(x: torch.Tensor, c: torch.Tensor, precision: str):
    if precision == "fast":
        return (x.to(torch.bfloat16).to(torch.float32),
                c.to(torch.bfloat16).to(torch.float32))
    if precision == "exact":
        return x.to(torch.float32), c.to(torch.float32)
    raise ValueError(f"unknown encode precision {precision!r}")


def pq_encode(
    x: torch.Tensor,
    cents: torch.Tensor,
    layout: str = "contiguous",
    batched_cents: bool = False,
    precision: str = "exact",
) -> torch.Tensor:
    """Nearest-centroid encode. x (..., d), cents (M, C, d_m) -> (..., M)
    codes of code_dtype(C).

    argmin_c ||c_mc||^2 - 2 <x_m, c_mc>, computed in f32 (ties go to the
    lowest index, as jnp.argmin). precision "fast" rounds x and the centroids
    to bf16 first (products of bf16 values are exact in f32), and ||c||^2
    comes from the same rounded centroids.

    batched_cents=True: cents (X, M, C, d_m) with x's leading axis a
    multiple of X, pairing x[i] with cents[i * X // x.shape[0]] (one encode
    for every layer of a flush)."""
    M, C = cents.shape[-3], cents.shape[-2]
    out_dtype = code_dtype(C)
    xs = subspace_view(x, M, layout)  # (..., M, d_m)
    xs, c = _cast_inputs(xs, cents, precision)
    c_sq = (c * c).sum(-1)  # (..., M, C)
    if batched_cents:
        X = c.shape[0]
        rows = xs.reshape(X, -1, M, xs.shape[-1]).permute(0, 2, 1, 3)  # (X, M, R, d_m)
        R = rows.shape[2]
        # ||c||^2 - 2 <x, c> in one batched GEMM epilogue: (X*M, R, C)
        dist = torch.baddbmm(c_sq.reshape(X * M, 1, C), rows.reshape(X * M, R, -1),
                             c.reshape(X * M, C, -1).transpose(1, 2), alpha=-2.0)
        codes = torch.argmin(dist, dim=-1).reshape(X, M, R)
        codes = codes.permute(0, 2, 1).reshape(*x.shape[:-1], M)
    else:
        rows = xs.reshape(-1, M, xs.shape[-1]).permute(1, 0, 2)  # (M, R, d_m)
        dist = torch.baddbmm(c_sq[:, None, :], rows, c.transpose(-1, -2), alpha=-2.0)  # (M, R, C)
        codes = torch.argmin(dist, dim=-1)  # (M, R)
        codes = codes.t().reshape(*x.shape[:-1], M)
    return codes.to(out_dtype)


def pq_encode_chunked(
    x: torch.Tensor,  # (..., n, d), tokens on axis -2
    cents: torch.Tensor,
    layout: str = "contiguous",
    chunk: int = 1024,
    precision: str = "exact",
) -> torch.Tensor:
    """pq_encode over the token axis in chunks, bounding the (rows, M, C) f32
    distance transient."""
    n = x.shape[-2]
    if n <= chunk:
        return pq_encode(x, cents, layout, precision=precision)
    parts = [
        pq_encode(x[..., s:s + chunk, :], cents, layout, precision=precision)
        for s in range(0, n, chunk)
    ]
    return torch.cat(parts, dim=-2)


def runtime_encode(x: torch.Tensor, cents: torch.Tensor, layout: str = "contiguous") -> torch.Tensor:
    """Encode of the prefill, flush and admission call sites, at
    RUNTIME_ENCODE_PRECISION: x (..., d), cents (M, C, d_m) -> (..., M) codes
    of code_dtype(C).
    With RUNTIME_FUSED_ENCODE a CUDA tensor goes through the fused kernel; a
    CPU tensor, or the switch off, through the chunked batched-GEMM encode."""
    if RUNTIME_FUSED_ENCODE and x.device.type != "cpu":
        from million_tpu_torch.ops.pq_encode_kernel import pq_encode_fused

        return pq_encode_fused(x, cents, layout, precision=RUNTIME_ENCODE_PRECISION)
    return pq_encode_chunked(x, cents, layout, precision=RUNTIME_ENCODE_PRECISION)


def pq_decode(codes: torch.Tensor, cents: torch.Tensor, layout: str = "contiguous") -> torch.Tensor:
    """Reconstruct vectors: codes (..., M), cents (M, C, d_m) -> (..., d)."""
    M, C, d_m = cents.shape
    idx = code_index(codes).reshape(-1, M)  # (B, M)
    gathered = cents[torch.arange(M, device=cents.device)[None, :], idx]  # (B, M, d_m)
    return merge_subspaces(gathered, layout).reshape(*codes.shape[:-1], M * d_m)


def build_lut(q: torch.Tensor, cents: torch.Tensor, layout: str = "contiguous") -> torch.Tensor:
    """lut[..., m, c] = <q_m, cents[m, c]>: q (..., d) -> (..., M, C) f32."""
    M = cents.shape[0]
    qs = subspace_view(q.to(torch.float32), M, layout)
    return torch.einsum("...mk,mck->...mc", qs, cents.to(torch.float32))


def lut_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (..., M, C), codes (..., n, M) -> s[..., n] = sum_m lut[m, codes[n, m]]."""
    M, C = lut.shape[-2], lut.shape[-1]
    n = codes.shape[-2]
    batch = torch.broadcast_shapes(lut.shape[:-2], codes.shape[:-2])
    flat = lut.reshape(*lut.shape[:-2], 1, M * C).expand(*batch, n, M * C)
    idx = (code_index(codes) + torch.arange(M, device=codes.device) * C).expand(*batch, n, M)
    g = torch.gather(flat, -1, idx)
    return g.sum(-1)


# Outlier channels: channels excluded from PQ (zeroed before training and
# encoding) and stored exactly beside the codes.

def select_outlier_channels(samples: torch.Tensor, k: int) -> torch.Tensor:
    """The k channels of largest mean square: samples (n, d) -> (k,) int32,
    sorted ascending."""
    energy = samples.to(torch.float32).square().mean(0)
    _, idx = torch.topk(energy, k)
    return torch.sort(idx.to(torch.int32)).values


def _channel_mask(d: int, idx: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros(d, dtype=torch.bool, device=idx.device)
    mask[idx.long()] = True
    return mask


def zero_channels(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., d) with channels idx set to 0."""
    return torch.where(_channel_mask(x.shape[-1], idx), torch.zeros((), dtype=x.dtype, device=x.device), x)


def restore_channels(x_hat: torch.Tensor, x_exact: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x_hat with channels idx replaced by x_exact's."""
    return torch.where(_channel_mask(x_hat.shape[-1], idx), x_exact.to(x_hat.dtype), x_hat)

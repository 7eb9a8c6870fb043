"""Fused PQ encode: the hand-written CUDA kernel (csrc/pq_encode.cu) and its
plain PyTorch version.

Counterpart of million_tpu/ops/pq_encode_pallas.py::pq_encode_fused_stacked
and pq_encode_fused, without their `tb` and `interpret` arguments. Contract:
x (S, ..., d) any float, cents (S, M, C, d_m) f32 -> codes (S, ..., M),
code = argmin_c ||x_m - c||^2 with ties to the lowest index; "fast" rounds x
and the centroids to bf16 and sums in f32, "exact" keeps f32. Codes are uint8
for C <= 256 and int16 above (C up to 65,536, pq/ops.code_dtype; a code
above 32,767 is its bit pattern). The kernel never writes the (rows, M, C)
distances; the plain version (pq/ops.pq_encode, a batched GEMM plus argmin
over row chunks) does.

`pq_encode_fused_stacked` runs the plain version for CPU tensors, launches
a kernel for CUDA tensors, and raises otherwise; it counts kernel launches
in `pq_encode_fused_stacked.launches`. On the card `encode_route` picks the
kernel: for C <= 256 the tiled one built for d_m in KERNEL_DM, or the generic
one for every other width (32, 64, 128 and widths that are not powers of
two); for C > 256 the wide build, which streams the codebook through shared
memory (its own entry, pq_encode_wide, with a tiled and a generic kernel of
its own).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from million_tpu_torch.pq.ops import MAX_C, code_dtype, pq_encode

TILE = 256  # the larger of the kernel's two row tiles (TB_MAX in the .cu source)
MAX_ROWS = (1 << 31) - 1  # rows per bank the kernel indexes in 32 bits
KERNEL_DM = (1, 2, 4, 8, 16)  # subspace widths the tiled kernel is built for
GENERIC_SMEM_MAX = 232448  # the generic kernel's codebook, norms and x tile must fit (sm_90)
GENERIC_ROWS = 128  # rows of the generic kernel's tile (GT in the .cu source)
# the wide build's generic kernel: an x tile of GENERIC_ROWS rows and two chunks of WIDE_GENERIC_CHUNK
# centroids in tiles of 4 (GCC, GCT in the .cu source) must fit in shared memory
WIDE_GENERIC_CHUNK = 64
PLAIN_MAX_DIST = 1 << 28  # f32 distances the plain version holds at a time

_lib = None


def _library():
    """Build (first call) and bind csrc/pq_encode.cu."""
    global _lib
    if _lib is None:
        from million_tpu_torch.ops.cuda_build import build

        lib = build("pq_encode").lib
        lib.pq_encode.restype = ctypes.c_int
        lib.pq_encode.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_long] * 7
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.pq_encode_wide.restype = ctypes.c_int
        lib.pq_encode_wide.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_long] * 7
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        lib.pq_encode_wide_scratch.restype = ctypes.c_long
        lib.pq_encode_wide_scratch.argtypes = [ctypes.c_int] * 3
        lib.pq_encode_tile.restype = ctypes.c_int
        if lib.pq_encode_tile() != TILE:
            raise RuntimeError("TILE differs between the Python wrapper and the CUDA source")
        _lib = lib
    return _lib


def encode_route(d_m: int, C: int) -> str:
    """Which kernel of csrc/pq_encode.cu encodes this geometry on the card:
    for C <= 256 "tiled" (the max-first kernel, built for d_m in KERNEL_DM)
    or "generic" (any width whose codebook, norms and a 128-row x tile fit in
    shared memory: d_m up to 128 at C = 256); for 256 < C <= 65,536 "wide"
    (the streamed build: its tiled kernel for d_m in KERNEL_DM, its generic
    one for every other width whose x tile and two chunks fit, d_m up to 226).
    The one place that decides it, needing no card; raises ValueError for
    what none takes."""
    if not 1 <= C <= MAX_C or d_m < 1:
        raise ValueError(f"unsupported encode geometry C={C} d_m={d_m}")
    if C > 256:
        need = 4 * (d_m * GENERIC_ROWS + 2 * WIDE_GENERIC_CHUNK * (d_m + 1))
        if d_m not in KERNEL_DM and need > GENERIC_SMEM_MAX:
            raise ValueError(f"d_m={d_m} does not fit the wide generic kernel's shared memory")
        return "wide"
    if d_m in KERNEL_DM:
        return "tiled"
    Cp = -(-C // 4) * 4
    if 4 * (Cp * d_m + Cp + d_m * GENERIC_ROWS) > GENERIC_SMEM_MAX:
        raise ValueError(f"d_m={d_m} at C={C} does not fit the generic kernel's shared memory")
    return "generic"


def pq_encode_fused_plain(
    x: torch.Tensor,  # (S, ..., d)
    cents: torch.Tensor,  # (S, M, C, d_m)
    layout: str = "contiguous",
    precision: str = "fast",
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: pq_encode with one codebook bank
    per leading index of x, over row chunks that bound the (rows, M, C) f32
    distance transient (fewer rows a chunk the wider the codebook)."""
    S, M, C, _ = cents.shape
    if x.shape[0] != S:
        raise ValueError(f"x banks {x.shape[0]} != cents banks {S}")
    d = x.shape[-1]
    rows = x.reshape(S, -1, d)
    R = rows.shape[1]
    step = max(1, PLAIN_MAX_DIST // max(S * M * C, 1))
    parts = [
        pq_encode(rows[:, r0:r0 + step], cents, layout, batched_cents=True, precision=precision)
        for r0 in range(0, R, step)
    ]
    codes = torch.cat(parts, dim=1) if parts else rows.new_zeros((S, 0, M), dtype=code_dtype(C))
    return codes.reshape(*x.shape[:-1], M)


def _collapse(shape: Tuple[int, ...], strides: Tuple[int, ...]) -> List[Tuple[int, int]]:
    """Merge neighbouring dims that one stride can walk: [(size, stride), ...]
    over the same elements in the same order."""
    dims: List[Tuple[int, int]] = []
    for n, s in zip(shape, strides):
        if n == 1:
            continue
        if dims and dims[-1][1] == n * s:
            dims[-1] = (dims[-1][0] * n, s)
        else:
            dims.append((n, s))
    return dims


def _launch(x, cents, layout, precision):
    if layout not in ("contiguous", "strided"):
        raise ValueError(f"unknown subspace layout {layout!r}")
    if precision not in ("fast", "exact"):
        raise ValueError(f"unknown encode precision {precision!r}")
    dev = x.device
    if cents.device != dev or cents.dtype != torch.float32 or cents.dim() != 4 \
            or not cents.is_contiguous():
        raise ValueError(
            f"cents: want a contiguous (S, M, C, d_m) float32 tensor on {dev}, got "
            f"{tuple(cents.shape)} {cents.dtype} on {cents.device}")
    S, M, C, d_m = cents.shape
    d = x.shape[-1]
    if x.dim() < 2 or x.shape[0] != S:
        raise ValueError(f"x banks {tuple(x.shape)} != cents banks {S}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bfloat16 or float32, got {x.dtype}")
    if d != M * d_m:
        raise ValueError(f"unsupported geometry d={d} M={M} C={C} d_m={d_m}")
    route = encode_route(d_m, C)  # raises for what no kernel takes
    codes = torch.empty((*x.shape[:-1], M), dtype=code_dtype(C), device=dev)
    if codes.numel() == 0:
        return codes, False
    if x.stride(-1) != 1:
        x = x.contiguous()
    dims = _collapse(tuple(x.shape[1:-1]), tuple(x.stride()[1:-1]))
    if len(dims) > 3:
        x = x.contiguous()
        dims = _collapse(tuple(x.shape[1:-1]), tuple(x.stride()[1:-1]))
    dims = [(1, 0)] * (3 - len(dims)) + dims
    (n0, s0), (n1, s1), (n2, s2) = dims
    if n0 * n1 * n2 > MAX_ROWS:
        raise ValueError(f"{n0 * n1 * n2} rows per bank; the kernel takes at most {MAX_ROWS}")
    lib = _library()
    flags = (int(x.dtype == torch.bfloat16), int(layout == "strided"), int(precision == "fast"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "wide":
        scratch = torch.empty(S * lib.pq_encode_wide_scratch(M, C, d_m), dtype=torch.float32, device=dev)
        err = lib.pq_encode_wide(
            x.data_ptr(), cents.data_ptr(), codes.data_ptr(), scratch.data_ptr(), S, n0, n1, n2,
            x.stride(0), s0, s1, s2, M, C, d_m, *flags, stream)
    else:
        err = lib.pq_encode(
            x.data_ptr(), cents.data_ptr(), codes.data_ptr(), S, n0, n1, n2,
            x.stride(0), s0, s1, s2, M, C, d_m, *flags, int(route == "generic"), stream)
    if err != 0:
        raise RuntimeError(f"pq_encode launch failed: CUDA error {err}")
    return codes, True


def pq_encode_fused_stacked(
    x: torch.Tensor,  # (S, ..., d), one codebook bank per leading index
    cents: torch.Tensor,  # (S, M, C, d_m) f32
    layout: str = "contiguous",
    precision: str = "fast",
) -> torch.Tensor:
    """Encode S banks in one launch -> (S, ..., M) codes (uint8, or int16
    for C > 256). The flush uses S = num_layers (every layer's residual
    window, one launch per side), prefill S = 1. x may be a strided view
    with a dense last dim. On the card encode_route picks the kernel."""
    if x.device.type == "cpu":
        return pq_encode_fused_plain(x, cents, layout, precision)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    codes, launched = _launch(x, cents, layout, precision)
    if launched:
        pq_encode_fused_stacked.launches += 1
    return codes


pq_encode_fused_stacked.launches = 0


def pq_encode_fused(
    x: torch.Tensor,  # (..., d)
    cents: torch.Tensor,  # (M, C, d_m)
    layout: str = "contiguous",
    precision: str = "fast",
) -> torch.Tensor:
    """Single-codebook fused encode: (..., d) -> (..., M) codes of code_dtype(C)."""
    return pq_encode_fused_stacked(x[None], cents[None], layout, precision)[0]


def encode_bytes(rows: int, d: int, M: int, x_itemsize: int, code_itemsize: int = 1) -> int:
    """Bytes one call must move at least: x read once, codes written once
    (1 B, or 2 B for int16 codes; the codebooks are not counted)."""
    return rows * (d * x_itemsize + M * code_itemsize)


def encode_ops(rows: int, M: int, C: int, d_m: int) -> int:
    """Operations of one call: per (row, subspace, centroid) d_m FMAs counted
    as 2 each and one compare."""
    return rows * M * C * (2 * d_m + 1)

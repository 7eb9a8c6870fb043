"""Chunk-history attention over the flat code arena: the hand-written CUDA
kernel (csrc/pq_chunk_attention.cu) and its plain PyTorch version.

Counterpart of million_tpu/ops/pq_attention_pallas.py::pq_chunk_attention and
its GQA wrapper pq_chunk_history_attention: the queries of a prefill chunk
attend over the quantized history [0, n_codes) that earlier chunks wrote, all
rows over the same span, no causal mask; the result (out normalised, lse) is
LSE-merged with the chunk's own causal partial. The TPU kernel's tiling and
table arguments (`q_block`, `block`, `n_bucket`, `direct`, `v_direct`,
`DecodeTable`) and its third output `co` are gone: one layer of the port's
arena is uint8 token-major (bs, nh_k, N_max, M), exact outlier channels are
bf16 (bs, nh_k, N_max, O), the kernel computes with the codebooks themselves
(no int8 tables), takes `n_codes` as a host integer and writes the exact V
outlier channels in place.

Two precisions, one function. "f32": every product in f32, for f32 models and
as the reference of the other. "bf16": q, the decoded K and V and the softmax
weights rounded to bf16, f32 accumulation, on the tensor cores (wgmma, with
producer warpgroups decoding the next tile of the history while consumer
warpgroups multiply this one): how a 16-bit model's own attention products run on the
card, and what pq_chunk_history_attention picks for 16-bit queries wherever
the geometry is one it is built for (mma_geometry; the others take "f32"). The plain
version takes the same argument and rounds at the same places, so it stays
the kernel's arithmetic in PyTorch on either setting.

`pq_chunk_attention` runs the plain version for CPU tensors, launches the
kernel for CUDA tensors, and raises otherwise; it counts kernel launches in
`pq_chunk_attention.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from million_tpu_torch.ops.pq_attention_ref import NEG_INF
from million_tpu_torch.pq.ops import pq_decode

Q_BLOCK = 128  # query rows per block (BQ in the .cu source)
MAX_D = 128
PRECISIONS = ("f32", "bf16")
MMA_HEAD_DIMS = (16, 64, 128)  # head dims the tensor-core version is built for
MMA_MAX_OK = MMA_MAX_OV = 16  # and its most exact channels a side
# the tensor-core version's shared-memory plan (mma_plan in the .cu source)
MMA_TILE = 64  # history tokens per tile (NT)
MMA_MAX_STAGES = 4
SMEM_HEAD = 256  # mbarriers and the V position map
SMEM_OPTIN = 232448  # shared memory a block may opt in to on an H100

_lib = None


def _library():
    """Build (first call) and bind csrc/pq_chunk_attention.cu."""
    global _lib
    if _lib is None:
        from million_tpu_torch.ops.cuda_build import build

        lib = build("pq_chunk_attention").lib
        lib.pq_chunk_attention.restype = ctypes.c_int
        lib.pq_chunk_attention.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        )
        lib.pq_chunk_attention_smem.restype = ctypes.c_long
        lib.pq_chunk_attention_smem.argtypes = [ctypes.c_int] * 8
        for fn in (lib.pq_chunk_attention_stages, lib.pq_chunk_attention_slots):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 7
        lib.pq_chunk_attention_q_block.restype = ctypes.c_int
        if lib.pq_chunk_attention_q_block() != Q_BLOCK:
            raise RuntimeError("Q_BLOCK differs between the Python wrapper and the CUDA source")
        _lib = lib
    return _lib


def _row_stride(rb: int, pad: bool) -> int:
    """Bytes between two staged rows of rb bytes (row_stride in the .cu source)."""
    if not pad:
        return (rb + 3) // 4 * 4
    return rb + 16 if rb % 16 == 0 else (rb + 3) // 4 * 4 + 4


def mma_smem_plan(d: int, OK: int, C_k: int, C_v: int, M: int, M_v: int, OV: int) -> Tuple[int, int, int]:
    """(stages, slots, bytes) of the tensor-core version's shared memory, the
    mirror of mma_plan in csrc/pq_chunk_attention.cu. Beside a 256-byte head
    and both codebooks in bf16 it holds `slots` slots of a 64-token tile's
    staged code and exact-channel rows and `stages` decoded tiles: K_hat
    (d + op positions), V_hat (d) and the exact V channels (op), 64 tokens in
    bf16, where op = 16 when either side has exact channels or d = 64, else
    0. It takes the first of (three slots, padded rows), (two, padded), (two,
    unpadded) beside which two stages fit in 232,448 bytes (_row_stride says
    how rows are padded), then as many stages as fit, at most 4. Past the
    limit, the bytes at two unpadded slots and 2 stages (which the wrapper
    refuses)."""
    op = 16 if OK or OV or d == 64 else 0
    stage = 2 * MMA_TILE * (2 * d + 2 * op)
    base = SMEM_HEAD + 2 * (C_k + C_v) * d
    for slots, pad in ((3, True), (2, True), (2, False)):
        slot = MMA_TILE * (_row_stride(M, pad) + _row_stride(M_v, pad)
                           + (_row_stride(2 * OK, pad) if OK else 0) + (_row_stride(2 * OV, pad) if OV else 0))
        n = (SMEM_OPTIN - base - slots * slot) // stage
        if n >= 2:
            break
    n = min(MMA_MAX_STAGES, max(2, n))
    return n, slots, base + slots * slot + n * stage


def pq_chunk_attention_plain(
    q: torch.Tensor,  # (bs, nh_k, QR, d), pre-scaled by 1/sqrt(d)
    key_codes: torch.Tensor,  # (bs, nh_k, N_max, M) uint8
    value_codes: torch.Tensor,  # (bs, nh_k, N_max, M_v) uint8
    key_cents: torch.Tensor,  # (M, C, d_m) f32
    value_cents: torch.Tensor,  # (M_v, C_v, d_m_v) f32
    n_codes: int,
    *,
    koidx: Optional[torch.Tensor] = None,  # (OK,) int32
    k_outliers: Optional[torch.Tensor] = None,  # (bs, nh_k, N_max, OK) bf16
    voidx: Optional[torch.Tensor] = None,  # (OV,) int32
    v_outliers: Optional[torch.Tensor] = None,  # (bs, nh_k, N_max, OV) bf16
    hist_block: int = 1024,
    precision: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the history is decoded one
    hist_block of tokens at a time (the dense history K/V is never whole in
    memory) under an f32 online softmax. With precision "bf16", q, the
    codebooks and the weights of the P V product are rounded to bf16 first,
    as the tensor-core kernel rounds them; sums stay f32. Returns
    (out (bs, nh_k, QR, d) f32 normalised, lse (bs, nh_k, QR) f32); out = 0
    and lse = -1e30 when n_codes == 0."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    rnd = (lambda t: t.to(torch.bfloat16).to(torch.float32)) if precision == "bf16" else (lambda t: t)
    bs, nh_k, QR, d = q.shape
    qf = rnd(q.to(torch.float32))
    kcent, vcent = rnd(key_cents.float()), rnd(value_cents.float())
    qo = qf[..., koidx.long()] if k_outliers is not None else None
    m = torch.full((bs, nh_k, QR, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((bs, nh_k, QR, d), dtype=torch.float32, device=q.device)
    for lo in range(0, n_codes, hist_block):
        hi = min(lo + hist_block, n_codes)
        khat = pq_decode(key_codes[:, :, lo:hi], kcent, "strided")  # (bs, nh_k, n, d)
        s = torch.einsum("bhqd,bhnd->bhqn", qf, khat)
        if k_outliers is not None:
            s = s + torch.einsum("bhqo,bhno->bhqn", qo, k_outliers[:, :, lo:hi].float())
        vhat = pq_decode(value_codes[:, :, lo:hi], vcent, "strided")
        if v_outliers is not None:
            vhat[..., voidx.long()] = v_outliers[:, :, lo:hi].float()
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqn,bhnd->bhqd", rnd(p), vhat)
        m = m_new
    safe_l = torch.clamp(l, min=1e-30)
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(safe_l[..., 0]),
                      torch.full_like(l[..., 0], NEG_INF))
    return acc / safe_l, lse


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, device):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{name}: want a contiguous {ndim}-d {dtype} tensor on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _launch(q, key_codes, value_codes, key_cents, value_cents, n_codes,
            koidx, k_outliers, voidx, v_outliers, precision):
    dev = q.device
    bs, nh_k, QR, d = q.shape
    N, M = key_codes.shape[2], key_codes.shape[3]
    M_v = value_codes.shape[3]
    C_k, C_v = key_cents.shape[1], value_cents.shape[1]
    _check(q, "q", torch.float32, 4, dev)
    _check(key_codes, "key_codes", torch.uint8, 4, dev)
    _check(value_codes, "value_codes", torch.uint8, 4, dev)
    _check(key_cents, "key_cents", torch.float32, 3, dev)
    _check(value_cents, "value_cents", torch.float32, 3, dev)
    if key_codes.shape[:3] != (bs, nh_k, N) or value_codes.shape[:3] != (bs, nh_k, N):
        raise ValueError("q, key_codes and value_codes disagree on (bs, nh_k, N_max)")
    if key_cents.shape[0] != M or value_cents.shape[0] != M_v:
        raise ValueError("codebook subspace counts differ from the code arenas'")
    for m, c, cents in ((M, C_k, key_cents), (M_v, C_v, value_cents)):
        if d % m or cents.shape[2] != d // m or c > 256:
            raise ValueError(f"unsupported geometry M={m} C={c} for d={d}")
    if d > MAX_D or d % 4:
        raise ValueError(f"kernel needs d <= {MAX_D} and d % 4 == 0")
    if not 0 <= n_codes <= N:
        raise ValueError(f"n_codes={n_codes} outside the arena of {N} tokens")
    OK = OV = 0
    null = ctypes.c_void_p(0)
    ko_p = vo_p = kidx_p = vidx_p = null
    if k_outliers is not None:
        _check(k_outliers, "k_outliers", torch.bfloat16, 4, dev)
        _check(koidx, "koidx", torch.int32, 1, dev)
        OK = k_outliers.shape[-1]
        if k_outliers.shape[:3] != (bs, nh_k, N) or koidx.shape[0] != OK:
            raise ValueError("k_outliers / koidx shapes")
        ko_p, kidx_p = k_outliers.data_ptr(), koidx.data_ptr()
    if v_outliers is not None:
        _check(v_outliers, "v_outliers", torch.bfloat16, 4, dev)
        _check(voidx, "voidx", torch.int32, 1, dev)
        OV = v_outliers.shape[-1]
        if v_outliers.shape[:3] != (bs, nh_k, N) or voidx.shape[0] != OV:
            raise ValueError("v_outliers / voidx shapes")
        vo_p, vidx_p = v_outliers.data_ptr(), voidx.data_ptr()
    mma = int(precision == "bf16")
    if mma and not mma_geometry(d, M_v, OK, OV, M):
        raise ValueError(f"the bf16 kernel is built for d in {MMA_HEAD_DIMS}, even OK <= "
                         f"{MMA_MAX_OK}, even OV <= {MMA_MAX_OV} and M % 4 == M_v % 4 == 0, "
                         f"got d={d}, OK={OK}, OV={OV}, M={M}, M_v={M_v}")
    lib = _library()
    need = lib.pq_chunk_attention_smem(d, OK, C_k, C_v, mma, M, M_v, OV)
    if mma:
        geom = (d, OK, C_k, C_v, M, M_v, OV)
        plan = (lib.pq_chunk_attention_stages(*geom), lib.pq_chunk_attention_slots(*geom), need)
        if plan != mma_smem_plan(*geom):
            raise RuntimeError("the shared-memory plan differs between the Python wrapper and the CUDA source")
    limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", 232448)
    if need > limit:
        raise ValueError(f"d={d}, OK={OK}, C={C_k}/{C_v} at precision {precision} needs {need} B "
                         f"of shared memory, the card has {limit}")
    out = torch.empty((bs, nh_k, QR, d), dtype=torch.float32, device=dev)
    lse = torch.empty((bs, nh_k, QR), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse, False
    err = lib.pq_chunk_attention(
        q.data_ptr(), key_codes.data_ptr(), value_codes.data_ptr(),
        key_cents.data_ptr(), value_cents.data_ptr(), ko_p, vo_p, kidx_p, vidx_p,
        out.data_ptr(), lse.data_ptr(),
        bs, nh_k, QR, d, M, C_k, M_v, C_v, OK, OV, N, n_codes, mma,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pq_chunk_attention launch failed: CUDA error {err}")
    return out, lse, True


def pq_chunk_attention(
    q: torch.Tensor,  # (bs, nh_k, QR, d) f32, pre-scaled by 1/sqrt(d)
    key_codes: torch.Tensor,  # (bs, nh_k, N_max, M) uint8: one layer of the arena
    value_codes: torch.Tensor,
    key_cents: torch.Tensor,  # (M, C, d_m) f32
    value_cents: torch.Tensor,
    n_codes: int,  # host integer: valid history tokens
    *,
    koidx: Optional[torch.Tensor] = None,
    k_outliers: Optional[torch.Tensor] = None,
    voidx: Optional[torch.Tensor] = None,
    v_outliers: Optional[torch.Tensor] = None,
    precision: str = "f32",
    hist_block: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Many-query partial attention over the first n_codes quantized tokens.
    Rows are a chunk's (q_pos, GQA group) pairs of one KV head and all see
    the same span. precision "f32" or "bf16" as in the module note.
    hist_block is the history block of the plain version, which CPU tensors
    take; the kernel walks the history in its own tiles. Returns
    (out (bs, nh_k, QR, d) f32 normalised, with the exact V outlier channels
    in place; lse (bs, nh_k, QR) f32)."""
    if (k_outliers is None) != (koidx is None) or (v_outliers is None) != (voidx is None):
        raise ValueError("outlier slabs and their channel indices go together")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if q.device.type == "cpu":
        return pq_chunk_attention_plain(
            q, key_codes, value_codes, key_cents, value_cents, n_codes, koidx=koidx,
            k_outliers=k_outliers, voidx=voidx, v_outliers=v_outliers, precision=precision,
            hist_block=hist_block)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out, lse, launched = _launch(q, key_codes, value_codes, key_cents, value_cents, n_codes,
                                 koidx, k_outliers, voidx, v_outliers, precision)
    if launched:
        pq_chunk_attention.launches += 1
    return out, lse


pq_chunk_attention.launches = 0


def mma_geometry(d: int, M_v: int, OK: int = 0, OV: int = 0, M: Optional[int] = None) -> bool:
    """Whether the tensor-core version is built for this geometry: head dim
    d, M_v value subspaces (and M key subspaces, when given: its staged code
    rows are copied in 4-byte pieces), OK and OV exact channels. Any d_m its
    bf16 codebooks hold is decoded (d_m 16 and 32 at d = 128 included)."""
    return (d in MMA_HEAD_DIMS and OK <= MMA_MAX_OK and OV <= MMA_MAX_OV and OK % 2 == 0
            and OV % 2 == 0 and M_v % 4 == 0 and (M is None or M % 4 == 0))


def history_precision(q: torch.Tensor, value_codes: Optional[torch.Tensor] = None,
                      k_outliers: Optional[torch.Tensor] = None,
                      v_outliers: Optional[torch.Tensor] = None,
                      key_codes: Optional[torch.Tensor] = None) -> str:
    """The precision of the history partial for a model whose queries are q
    (..., d), over an arena whose value codes are (..., M_v) and key codes
    (..., M) (not checked when None) with these exact-channel slabs (..., OK)
    and (..., OV): 16-bit models take the tensor-core product where it is
    built for the geometry (mma_geometry), f32 models and the other
    geometries (fewer than four wide subspaces a side, more than 16 exact
    channels) the f32 one, on the card and in the plain version alike. This
    is B3's route: every geometry goes to one of its two kernels."""
    if q.dtype not in (torch.bfloat16, torch.float16):
        return "f32"
    M_v = 4 if value_codes is None else value_codes.shape[-1]
    M = None if key_codes is None else key_codes.shape[-1]
    OK, OV = (0 if t is None else t.shape[-1] for t in (k_outliers, v_outliers))
    return "bf16" if mma_geometry(q.shape[-1], M_v, OK, OV, M) else "f32"


def group_rows(q: torch.Tensor, nh_k: int, scale: float) -> torch.Tensor:
    """(bs, nh, nc, d) raw queries -> (bs, nh_k, nc * G, d) f32 scaled rows of
    each KV head, row = q_pos * G + g."""
    bs, nh, nc, d = q.shape
    G = nh // nh_k
    qs = (q.to(torch.float32) * scale).reshape(bs, nh_k, G, nc, d)
    return qs.transpose(2, 3).reshape(bs, nh_k, nc * G, d)


def ungroup_rows(out: torch.Tensor, lse: torch.Tensor, nh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of group_rows on a partial: (bs, nh_k, nc * G, d) and
    (bs, nh_k, nc * G) -> (bs, nh, nc, d) and (bs, nh, nc)."""
    bs, nh_k, QR, d = out.shape
    G = nh // nh_k
    nc = QR // G
    out = out.reshape(bs, nh_k, nc, G, d).transpose(2, 3).reshape(bs, nh, nc, d)
    lse = lse.reshape(bs, nh_k, nc, G).transpose(2, 3).reshape(bs, nh, nc)
    return out, lse


def pq_chunk_history_attention(
    q: torch.Tensor,  # (bs, nh, nc, d) raw queries (not yet scaled)
    key_codes: torch.Tensor,  # (bs, nh_k, N_max, M) uint8
    value_codes: torch.Tensor,
    key_cents: torch.Tensor,
    value_cents: torch.Tensor,
    n_prev: int,  # quantized history length
    scale: float,
    *,
    koidx: Optional[torch.Tensor] = None,
    k_outliers: Optional[torch.Tensor] = None,
    voidx: Optional[torch.Tensor] = None,
    v_outliers: Optional[torch.Tensor] = None,
    precision: Optional[str] = None,
    hist_block: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GQA wrapper of pq_chunk_attention for the chunked-prefill call site:
    regroups the chunk's queries by KV head, rows ordered (q_pos, group), and
    undoes it on the way out. precision None picks "bf16" for 16-bit queries
    where the tensor-core version is built for the geometry and "f32"
    otherwise (history_precision); hist_block as in
    pq_chunk_attention. Returns (out (bs, nh, nc, d) f32
    normalised, lse (bs, nh, nc) f32)."""
    nh = q.shape[1]
    out, lse = pq_chunk_attention(
        group_rows(q, key_codes.shape[1], scale), key_codes, value_codes, key_cents,
        value_cents, n_prev, koidx=koidx, k_outliers=k_outliers, voidx=voidx,
        v_outliers=v_outliers,
        precision=precision or history_precision(q, value_codes, k_outliers, v_outliers, key_codes),
        hist_block=hist_block)
    return ungroup_rows(out, lse, nh)


def chunk_bytes(bs: int, nh_k: int, QR: int, d: int, n_codes: int, M: int, M_v: int,
                OK: int = 0, OV: int = 0) -> int:
    """Bytes one call must move at least: q read, out and lse written, the
    codes and outlier slabs of n_codes tokens read once."""
    return bs * nh_k * (QR * (2 * d + 1) * 4 + n_codes * (M + M_v + 2 * (OK + OV)))


def chunk_ops(bs: int, nh_k: int, QR: int, d: int, n_codes: int, OK: int = 0) -> int:
    """Multiply-adds of one call counted as 2 operations: the score product
    over d + OK and the P @ V product over d, per query row and token."""
    return 2 * bs * nh_k * QR * n_codes * (2 * d + OK)

"""PQ decode attention over the flat code arena: the hand-written CUDA kernel
(csrc/pq_decode_attention.cu) and its plain PyTorch version.

Counterpart of million_tpu/ops/pq_attention_pallas.py::
pq_codes_attention_stacked (the main-path TPU kernel) and
pq_codes_attention (its single-layer twin, here the same kernel on a one-layer
view). The TPU kernel's storage workarounds are gone: codes are uint8
token-major (L, bs, nh_k, N_max, M), exact outlier channels bf16
(L, bs, nh_k, N_max, O), the kernel computes with the f32 codebook itself (no
int8 tables, no int8 q) and takes any GQA group up to 8 without padding.

Both versions take the same arguments, cut the token axis into the same
splits and LSE-merge the per-split partials, so the plain version is the
kernel's arithmetic in PyTorch. `pq_codes_attention_stacked` runs the plain
version for CPU tensors, launches the kernel for CUDA tensors, and raises
otherwise; it counts kernel launches in `pq_codes_attention_stacked.launches`.
`decode_route` decides which build of the passes computes a geometry (this
kernel's and the paged kernel's): d_m <= 8 with M % 4 == 0, or any other
subspace width and count.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from million_tpu_torch.ops.pq_attention_ref import (
    NEG_INF,
    _softmax_partial,
    masked_partial_attention,
    merge_partials,
    merge_two_partials,
)
from million_tpu_torch.pq.ops import pq_decode

TILE = 256  # tokens per tile (TILE in the .cu source)
MAX_GROUP = 8
NARROW_MAX_DM = 8  # the widest subspace of the passes' d_m <= 8 builds
SM_COUNT_DEFAULT = 132  # H100 SXM; the CPU path plans splits as the card would

_lib = None


def _library():
    """Build (first call) and bind csrc/pq_decode_attention.cu."""
    global _lib
    if _lib is None:
        from million_tpu_torch.ops.cuda_build import build

        lib = build("pq_decode_attention").lib
        lib.pq_decode_attention.restype = ctypes.c_int
        lib.pq_decode_attention.argtypes = (
            [ctypes.c_void_p] * 17 + [ctypes.c_int] * 19 + [ctypes.c_void_p]
        )
        lib.pq_decode_attention_tile.restype = ctypes.c_int
        if lib.pq_decode_attention_tile() != TILE:
            raise RuntimeError("TILE differs between the Python wrapper and the CUDA source")
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class DecodeRoute:
    """The builds of the decode passes (csrc/pq_attention_passes.cuh) that
    compute one geometry, shared by B1 / B2 and the paged B4-B6.

    score: "narrow" (d_m <= 8 and M % 4 == 0: every main path) or "wide"
      (any d_m and M: code rows read byte by byte where M % 4 != 0).
    value: "dm8" (one column per subspace, 8 registers a query row; d_m <= 8
      and M_v % 4 == 0) or "dm16" (a column is a slice of `slice_width` dims
      of a subspace, `slices` of them: 16 for G <= 3, else 8)."""
    score: str
    value: str
    slice_width: int
    slices: int

    @property
    def kwide(self) -> int:
        return int(self.score == "wide")

    @property
    def vwide(self) -> int:
        return int(self.value == "dm16")

    @property
    def name(self) -> str:
        return f"score[{self.score}]+value[{self.value}x{self.slices}]"


def decode_route(d: int, M: int, M_v: int, C_k: int, C_v: int, G: int, OK: int = 0,
                 OV: int = 0) -> DecodeRoute:
    """Which build of the decode passes computes this geometry on the card:
    the one place that decides it, needing no card. Raises ValueError for
    what no build takes (C > 256, G > 8, d % 4, M_v subspace slices and
    exact V channels over one tile of columns)."""
    for m, c in ((M, C_k), (M_v, C_v)):
        if m < 1 or d % m or not 1 <= c <= 256:
            raise ValueError(f"unsupported geometry M={m} C={c} for d={d}")
    if not 1 <= G <= MAX_GROUP or d % 4:
        raise ValueError(f"kernel needs 1 <= G <= {MAX_GROUP} and d % 4 == 0, got G={G}, d={d}")
    narrow = lambda m: d // m <= NARROW_MAX_DM and m % 4 == 0  # noqa: E731
    score = "narrow" if narrow(M) else "wide"
    if narrow(M_v):
        value, width, slices = "dm8", NARROW_MAX_DM, 1
    else:
        width = 16 if G <= 3 else 8
        value, slices = "dm16", -(-(d // M_v) // width)
    if M_v * slices + OV > TILE:
        raise ValueError(f"kernel needs M_v * slices + OV <= {TILE} (got {M_v} x {slices} + {OV})")
    return DecodeRoute(score, value, width, slices)


def plan_splits(n_codes: int, pairs: int, n_sm: int = SM_COUNT_DEFAULT,
                n_split: Optional[int] = None) -> Tuple[int, int]:
    """Split the first n_codes tokens over (S, chunk): about one wave of
    blocks over the card's SMs for `pairs` = bs * nh_k, each chunk a
    multiple of TILE. Returns (S, chunk) with S * chunk >= n_codes."""
    if n_codes <= 0:
        return 1, TILE
    S = n_split if n_split else max(1, n_sm // max(pairs, 1))
    S = max(1, min(S, -(-n_codes // TILE)))
    chunk = -(-(-(-n_codes // S)) // TILE) * TILE
    return -(-n_codes // chunk), chunk


def pq_codes_attention_plain(
    q: torch.Tensor,  # (bs, nh_k, G, d) f32, pre-scaled by 1/sqrt(d)
    key_codes: torch.Tensor,  # (L, bs, nh_k, N_max, M) uint8
    value_codes: torch.Tensor,  # (L, bs, nh_k, N_max, M_v) uint8
    key_cents: torch.Tensor,  # (L, M, C, d_m) f32
    value_cents: torch.Tensor,  # (L, M_v, C_v, d_m_v) f32
    layer: int,
    n_codes: int,
    *,
    k_outliers: Optional[torch.Tensor] = None,  # (L, bs, nh_k, N_max, OK) bf16
    v_outliers: Optional[torch.Tensor] = None,  # (L, bs, nh_k, N_max, OV) bf16
    k_oidx: Optional[torch.Tensor] = None,  # (L, OK) int32
    v_oidx: Optional[torch.Tensor] = None,  # (L, OV) int32
    k_residual: Optional[torch.Tensor] = None,  # (L, bs, nh_k, Lt, d) bf16 or f32
    v_residual: Optional[torch.Tensor] = None,
    r: int = 0,  # valid residual rows
    n_split: Optional[int] = None,
    n_sm: int = SM_COUNT_DEFAULT,
    chunk: Optional[int] = None,  # tokens per split, in place of the planner's
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (out (bs, nh_k, G, d) f32, lse
    (bs, nh_k, G) f32); lse = -1e30 and out = 0 when n_codes == 0. With the
    residual window given, the exact partial over its first r rows is
    LSE-merged in."""
    bs, nh_k, G, d = q.shape
    qf = q.to(torch.float32)
    kc, vc = key_codes[layer], value_codes[layer]
    kcent, vcent = key_cents[layer].float(), value_cents[layer].float()
    if chunk:
        S = max(1, -(-n_codes // chunk))
    else:
        S, chunk = plan_splits(n_codes, bs * nh_k, n_sm, n_split)
    outs, lses = [], []
    for s in range(S):
        lo, hi = s * chunk, min((s + 1) * chunk, n_codes)
        if lo >= hi:
            outs.append(torch.zeros_like(qf))
            lses.append(torch.full((bs, nh_k, G), NEG_INF, device=q.device))
            continue
        khat = pq_decode(kc[:, :, lo:hi], kcent, "strided").float()  # (bs, nh_k, n, d)
        sc = torch.einsum("bhgd,bhnd->bhgn", qf, khat)
        if k_outliers is not None:
            qo = qf[..., k_oidx[layer].long()]
            sc = sc + torch.einsum("bhgo,bhno->bhgn", qo, k_outliers[layer, :, :, lo:hi].float())
        vhat = pq_decode(vc[:, :, lo:hi], vcent, "strided").float()
        if v_outliers is not None:
            vhat[..., v_oidx[layer].long()] = v_outliers[layer, :, :, lo:hi].float()
        ones = torch.ones(hi - lo, dtype=torch.bool, device=q.device)
        out, lse = _softmax_partial(sc, ones, vhat, "bhgn,bhnd->bhgd")
        outs.append(out)
        lses.append(lse)
    out, lse = merge_partials(torch.stack(outs, 2), torch.stack(lses, 2), dim=2)
    if k_residual is None:
        return out, lse
    out_r, lse_r = masked_partial_attention(qf, k_residual[layer], v_residual[layer], r, scale=1.0)
    return merge_two_partials(out, lse, out_r, lse_r)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int, device):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{name}: want a contiguous {ndim}-d {dtype} tensor on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _launch(q, key_codes, value_codes, key_cents, value_cents, layer, n_codes,
            k_outliers, v_outliers, k_oidx, v_oidx, k_residual, v_residual, r, n_split):
    dev = q.device
    bs, nh_k, G, d = q.shape
    L, _, _, N, M = key_codes.shape
    M_v = value_codes.shape[-1]
    C_k, C_v = key_cents.shape[2], value_cents.shape[2]
    _check(q, "q", torch.float32, 4, dev)
    _check(key_codes, "key_codes", torch.uint8, 5, dev)
    _check(value_codes, "value_codes", torch.uint8, 5, dev)
    _check(key_cents, "key_cents", torch.float32, 4, dev)
    _check(value_cents, "value_cents", torch.float32, 4, dev)
    if value_codes.shape[:4] != key_codes.shape[:4] or key_codes.shape[1:3] != (bs, nh_k):
        raise ValueError("q, key_codes and value_codes disagree on (bs, nh_k, N_max)")
    if key_cents.shape[1] != M or value_cents.shape[1] != M_v:
        raise ValueError("codebook subspace counts differ from the code arenas'")
    for m, cents in ((M, key_cents), (M_v, value_cents)):
        if d % m or cents.shape[3] != d // m:
            raise ValueError(f"codebook width {cents.shape[3]} for M={m} at d={d}")
    if not 0 <= n_codes <= N or not 0 <= layer < L:
        raise ValueError(f"n_codes={n_codes} / layer={layer} out of range")
    OK = OV = 0
    null = ctypes.c_void_p(0)
    ko_p = vo_p = kidx_p = vidx_p = null
    if k_outliers is not None:
        _check(k_outliers, "k_outliers", torch.bfloat16, 5, dev)
        _check(k_oidx, "k_oidx", torch.int32, 2, dev)
        OK = k_outliers.shape[-1]
        ko_p, kidx_p = k_outliers[layer].data_ptr(), k_oidx[layer].data_ptr()
    if v_outliers is not None:
        _check(v_outliers, "v_outliers", torch.bfloat16, 5, dev)
        _check(v_oidx, "v_oidx", torch.int32, 2, dev)
        OV = v_outliers.shape[-1]
        vo_p, vidx_p = v_outliers[layer].data_ptr(), v_oidx[layer].data_ptr()
    route = decode_route(d, M, M_v, C_k, C_v, G, OK, OV)
    Lt, res_bf16 = 0, 0
    kr_p = vr_p = null
    if k_residual is not None:
        rdt = k_residual.dtype
        if rdt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"residual window must be bf16 or f32, got {rdt}")
        _check(k_residual, "k_residual", rdt, 5, dev)
        _check(v_residual, "v_residual", rdt, 5, dev)
        Lt = k_residual.shape[3]
        if k_residual.shape != (L, bs, nh_k, Lt, d) or v_residual.shape != k_residual.shape:
            raise ValueError(f"residual window shape {tuple(k_residual.shape)}")
        if Lt > 1024 or not 0 <= r <= Lt:
            raise ValueError(f"residual window of {Lt} rows with r={r}")
        kr_p, vr_p = k_residual[layer].data_ptr(), v_residual[layer].data_ptr()
        res_bf16 = int(rdt == torch.bfloat16)
    else:
        r = 0
    n_sm = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    S, chunk = plan_splits(n_codes, bs * nh_k, n_sm, n_split)
    scores = torch.empty((bs, nh_k, S * chunk, G), dtype=torch.float32, device=dev)
    ml_part = torch.empty((bs, nh_k, S, G, 2), dtype=torch.float32, device=dev)
    out_part = torch.empty((bs, nh_k, S, G, d), dtype=torch.float32, device=dev)
    lse_part = torch.empty((bs, nh_k, S, G), dtype=torch.float32, device=dev)
    out = torch.empty((bs, nh_k, G, d), dtype=torch.float32, device=dev)
    lse = torch.empty((bs, nh_k, G), dtype=torch.float32, device=dev)
    err = _library().pq_decode_attention(
        q.data_ptr(), key_codes[layer].data_ptr(), value_codes[layer].data_ptr(),
        key_cents[layer].data_ptr(), value_cents[layer].data_ptr(),
        ko_p, vo_p, kidx_p, vidx_p, kr_p, vr_p, scores.data_ptr(), ml_part.data_ptr(),
        out_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(), lse.data_ptr(),
        bs, nh_k, G, d, M, C_k, M_v, C_v, OK, OV, N, n_codes, S, chunk, r, Lt, res_bf16,
        route.kwide, route.vwide, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pq_decode_attention launch failed: CUDA error {err}")
    return out, lse


def pq_codes_attention_stacked(
    q: torch.Tensor,
    key_codes: torch.Tensor,
    value_codes: torch.Tensor,
    key_cents: torch.Tensor,
    value_cents: torch.Tensor,
    layer: int,
    n_codes: int,
    *,
    k_outliers: Optional[torch.Tensor] = None,
    v_outliers: Optional[torch.Tensor] = None,
    k_oidx: Optional[torch.Tensor] = None,
    v_oidx: Optional[torch.Tensor] = None,
    k_residual: Optional[torch.Tensor] = None,
    v_residual: Optional[torch.Tensor] = None,
    r: int = 0,
    n_split: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial attention over layer `layer` of the stacked code arena.

    q (bs, nh_k, G, d) f32 pre-scaled by 1/sqrt(d); arguments as in
    pq_codes_attention_plain. `n_codes` is a host integer (the caller's
    counter), so no device sync is needed to size the launch. Returns
    (out (bs, nh_k, G, d) f32 in natural head order, with the exact V
    outlier channels in place; lse (bs, nh_k, G) f32). With k_residual /
    v_residual (L, bs, nh_k, Lt, d), the exact partial over their first r
    rows is merged in (the decode step's whole attention)."""
    if (k_outliers is None) != (k_oidx is None) or (v_outliers is None) != (v_oidx is None):
        raise ValueError("outlier slabs and their channel indices go together")
    if (k_residual is None) != (v_residual is None):
        raise ValueError("k_residual and v_residual go together")
    if q.device.type == "cpu":
        return pq_codes_attention_plain(
            q, key_codes, value_codes, key_cents, value_cents, layer, n_codes,
            k_outliers=k_outliers, v_outliers=v_outliers, k_oidx=k_oidx,
            v_oidx=v_oidx, k_residual=k_residual, v_residual=v_residual, r=r,
            n_split=n_split,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    res = _launch(q, key_codes, value_codes, key_cents, value_cents, layer, n_codes,
                  k_outliers, v_outliers, k_oidx, v_oidx, k_residual, v_residual, r, n_split)
    pq_codes_attention_stacked.launches += 1
    return res


pq_codes_attention_stacked.launches = 0


def pq_codes_attention(
    q: torch.Tensor,  # (bs, nh_k, G, d)
    key_codes: torch.Tensor,  # (bs, nh_k, N_max, M) uint8
    value_codes: torch.Tensor,
    key_cents: torch.Tensor,  # (M, C, d_m)
    value_cents: torch.Tensor,
    n_codes: int,
    *,
    k_outliers: Optional[torch.Tensor] = None,  # (bs, nh_k, N_max, OK)
    v_outliers: Optional[torch.Tensor] = None,
    k_oidx: Optional[torch.Tensor] = None,  # (OK,)
    v_oidx: Optional[torch.Tensor] = None,
    k_residual: Optional[torch.Tensor] = None,  # (bs, nh_k, Lt, d)
    v_residual: Optional[torch.Tensor] = None,
    r: int = 0,
    n_split: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-layer entry (counterpart of pq_codes_attention): the stacked
    kernel on a one-layer view of each argument. Its own launches (B2's, on
    CUDA tensors) are counted in `pq_codes_attention.launches` as well."""
    one = lambda t: None if t is None else t.unsqueeze(0)  # noqa: E731
    res = pq_codes_attention_stacked(
        q, one(key_codes), one(value_codes), one(key_cents), one(value_cents), 0, n_codes,
        k_outliers=one(k_outliers), v_outliers=one(v_outliers), k_oidx=one(k_oidx),
        v_oidx=one(v_oidx), k_residual=one(k_residual), v_residual=one(v_residual), r=r,
        n_split=n_split,
    )
    if q.device.type == "cuda":
        pq_codes_attention.launches += 1
    return res


pq_codes_attention.launches = 0


def decode_bytes(bs: int, nh_k: int, n_codes: int, M: int, M_v: int, OK: int = 0,
                 OV: int = 0) -> int:
    """Bytes one call must move at least: codes and outlier slabs of the
    n_codes tokens read once (the bound in the kernel's source note)."""
    return bs * nh_k * n_codes * (M + M_v + 2 * (OK + OV))


def decode_row_ops(n: int, d: int, OK: int = 0, OV: int = 0, M: Optional[int] = None,
                   M_v: Optional[int] = None, C: Optional[int] = None,
                   C_v: Optional[int] = None) -> int:
    """Operations for one query row over n tokens, an f32 FMA counted as 2:
    the score dot over d and OK exact channels and the P @ V product over d.
    Given a side's M and C, that side counts the fewer of this direct decode
    and the table route the function equally allows: q against every
    centroid (the value side: the weights summed per centroid, then the
    centroids scaled), 2 C d, plus one add per subspace and token, the
    value side's OV exact channels still 2 a token."""
    key = val = 2 * n * d
    if M is not None:
        key = min(key, 2 * C * d + n * M)
    if M_v is not None:
        val = min(val, 2 * C_v * (d - OV) + n * (M_v + 2 * OV))
    return key + 2 * n * OK + val


def decode_flops(bs: int, nh_k: int, G: int, d: int, n_codes: int, OK: int = 0, **tables) -> int:
    """Operations of one call: decode_row_ops for each query row (tables:
    OV, M, M_v, C, C_v, as there)."""
    return bs * nh_k * G * decode_row_ops(n_codes, d, OK, **tables)


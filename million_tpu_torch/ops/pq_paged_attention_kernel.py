"""PQ decode attention over paged code pools: the hand-written CUDA kernel
(csrc/pq_paged_attention.cu) and its plain PyTorch version.

Counterpart of million_tpu/ops/pq_attention_pallas.py::
pq_paged_attention_stacked (the serving tick's TPU kernel), pq_paged_attention
(its single-layer twin, here the same kernel on a one-layer view) and
pq_paged_attention_stacked_mp (several pages per grid step, here the `kpp`
mode of the same kernel: a block's split is `kpp` pages long).

The TPU kernels' storage workarounds are gone. Pools are token-major like the
flat arena: codes (L, n_pages + 1, nh_k, page_size, M | M_v) uint8, exact
outlier channels (L, n_pages + 1, nh_k, page_size, OK | OV) bf16; the last
page is the write-only scratch page. There is no GROUP_PAD, no int8 table, no
int8 q and no third output `co` (the exact V channels are written in place),
and `p_bucket` became `n_bound`, a host bound on the longest sequence that
sizes the grid. Each sequence's length `n_codes[b]` and live residual rows
`r[b]` are device integers that the kernel reads itself, so a decode tick
reads nothing back.

Both versions cut every sequence's tokens into the same splits and LSE-merge
the per-split partials, so the plain version is the kernel's arithmetic in
PyTorch. `pq_paged_attention_stacked` runs the plain version for CPU tensors,
launches the kernel for CUDA tensors, and raises otherwise; it counts kernel
launches in `pq_paged_attention_stacked.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from million_tpu_torch.ops.pq_attention_kernel import (
    MAX_DM,
    MAX_GROUP,
    SM_COUNT_DEFAULT,
    TILE,
    _check,
    _sm_count,
    pq_codes_attention_plain,
)

# What a block costs before its first tile (it stages a codebook into shared
# memory), in tokens of scoring time, and the most splits the planner tries.
# From a sweep of n_split at 1, 2 and 6 slots of 2K to 34K tokens on an H100,
# where the kernel's time followed waves x (split length + this).
SPLIT_OVERHEAD_TOKENS = 170
MAX_SPLITS = 32

_lib = None


def _library():
    """Build (first call) and bind csrc/pq_paged_attention.cu."""
    global _lib
    if _lib is None:
        from million_tpu_torch.ops.cuda_build import build

        lib = build("pq_paged_attention").lib
        lib.pq_paged_attention.restype = ctypes.c_int
        lib.pq_paged_attention.argtypes = (
            [ctypes.c_void_p] * 20 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
        )
        lib.pq_paged_attention_tile.restype = ctypes.c_int
        if lib.pq_paged_attention_tile() != TILE:
            raise RuntimeError("TILE differs between the Python wrapper and the CUDA source")
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def plan_paged_splits(n_bound: int, pairs: int, page_size: int, n_sm: int = SM_COUNT_DEFAULT,
                      n_split: Optional[int] = None, kpp: Optional[int] = None) -> Tuple[int, int]:
    """(S, fixed_chunk) for sequences of at most n_bound tokens, `pairs` =
    slots * nh_k. Default: the S that needs the least time for the longest
    sequence when blocks run one per SM in waves, waves x (split length +
    SPLIT_OVERHEAD_TOKENS); fixed_chunk = 0: every sequence cuts its own
    length into S splits (seq_chunk). With kpp, a split is kpp pages long for
    every sequence."""
    if kpp:
        fixed = kpp * page_size
        return max(1, -(-n_bound // fixed)), fixed
    most = max(1, min(MAX_SPLITS, -(-max(n_bound, 1) // TILE)))
    if n_split:
        return min(n_split, most), 0
    cost = lambda S: -(-pairs * S // n_sm) * (seq_chunk(n_bound, S) + SPLIT_OVERHEAD_TOKENS)  # noqa: E731
    return min(range(1, most + 1), key=lambda S: (cost(S), S)), 0


def seq_chunk(n_codes: int, S: int, fixed_chunk: int = 0) -> int:
    """Tokens per split of a sequence of n_codes tokens: whole tiles."""
    if fixed_chunk:
        return fixed_chunk
    return max(TILE, -(-(-(-n_codes // S)) // TILE) * TILE)


def _n_bound(page_table: torch.Tensor, page_size: int, n_bound: Optional[int]) -> int:
    cap = page_table.shape[1] * page_size
    if n_bound is None:
        return cap
    if not 0 <= n_bound <= cap:
        raise ValueError(f"n_bound={n_bound} outside the table's {cap} tokens")
    return n_bound


def pq_paged_attention_plain(
    q: torch.Tensor,  # (S, nh_k, G, d) f32, pre-scaled by 1/sqrt(d)
    key_pool: torch.Tensor,  # (L, n_pages + 1, nh_k, page_size, M) uint8
    value_pool: torch.Tensor,  # (L, n_pages + 1, nh_k, page_size, M_v) uint8
    key_cents: torch.Tensor,  # (L, M, C, d_m) f32
    value_cents: torch.Tensor,  # (L, M_v, C_v, d_m_v) f32
    layer: int,
    page_table: torch.Tensor,  # (S, P_max) int32, -1 = unallocated
    n_codes: torch.Tensor,  # (S,) int32
    *,
    n_bound: Optional[int] = None,  # host bound on n_codes (None: the whole table)
    k_outliers: Optional[torch.Tensor] = None,  # (L, n_pages + 1, nh_k, page_size, OK) bf16
    v_outliers: Optional[torch.Tensor] = None,
    k_oidx: Optional[torch.Tensor] = None,  # (L, OK) int32
    v_oidx: Optional[torch.Tensor] = None,
    k_residual: Optional[torch.Tensor] = None,  # (L, S, nh_k, Lt, d) bf16 or f32
    v_residual: Optional[torch.Tensor] = None,
    r: Optional[torch.Tensor] = None,  # (S,) int32 live residual rows per sequence
    n_split: Optional[int] = None,
    kpp: Optional[int] = None,
    n_sm: int = SM_COUNT_DEFAULT,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: sequence by sequence, the pages
    of its table laid out contiguously and handed to the flat kernel's plain
    version with the split length the CUDA block would choose. It reads the
    lengths back to the host, which the kernel never does. Returns (out
    (S, nh_k, G, d) f32, lse (S, nh_k, G) f32)."""
    S_seq, nh_k = q.shape[:2]
    page_size = key_pool.shape[3]
    bound = _n_bound(page_table, page_size, n_bound)
    S, fixed = plan_paged_splits(bound, S_seq * nh_k, page_size, n_sm, n_split, kpp)
    lens = [min(int(n), bound) for n in n_codes.tolist()]
    rows = [0] * S_seq if r is None else [int(x) for x in r.tolist()]
    one = lambda t: None if t is None else t[layer][None]  # noqa: E731
    outs, lses = [], []
    for b in range(S_seq):
        n_b = lens[b]
        pages = page_table[b, : max(1, -(-n_b // page_size))].clamp(min=0).long()

        def flat(pool):  # (pages, nh_k, page_size, X) -> (1, 1, nh_k, tokens, X)
            return pool[layer, pages].transpose(0, 1).reshape(1, 1, nh_k, -1, pool.shape[-1])

        kw = {}
        if k_outliers is not None:
            kw.update(k_outliers=flat(k_outliers), k_oidx=one(k_oidx))
        if v_outliers is not None:
            kw.update(v_outliers=flat(v_outliers), v_oidx=one(v_oidx))
        if k_residual is not None:
            kw.update(k_residual=k_residual[layer, b][None, None],
                      v_residual=v_residual[layer, b][None, None], r=rows[b])
        out, lse = pq_codes_attention_plain(
            q[b:b + 1], flat(key_pool), flat(value_pool), one(key_cents), one(value_cents), 0,
            n_b, chunk=seq_chunk(n_b, S, fixed), **kw)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses)


def _launch(q, key_pool, value_pool, key_cents, value_cents, layer, page_table, n_codes, n_bound,
            k_outliers, v_outliers, k_oidx, v_oidx, k_residual, v_residual, r, n_split, kpp):
    dev = q.device
    S_seq, nh_k, G, d = q.shape
    L, n_slabs, _, page_size, M = key_pool.shape
    M_v = value_pool.shape[-1]
    C_k, C_v = key_cents.shape[2], value_cents.shape[2]
    _check(q, "q", torch.float32, 4, dev)
    _check(key_pool, "key_pool", torch.uint8, 5, dev)
    _check(value_pool, "value_pool", torch.uint8, 5, dev)
    _check(key_cents, "key_cents", torch.float32, 4, dev)
    _check(value_cents, "value_cents", torch.float32, 4, dev)
    _check(page_table, "page_table", torch.int32, 2, dev)
    _check(n_codes, "n_codes", torch.int32, 1, dev)
    if value_pool.shape[:4] != key_pool.shape[:4] or key_pool.shape[2] != nh_k:
        raise ValueError("q, key_pool and value_pool disagree on (L, pages, nh_k, page_size)")
    if page_table.shape[0] != S_seq or n_codes.shape[0] != S_seq:
        raise ValueError("page_table and n_codes must have one row per sequence of q")
    if page_size % TILE:
        raise ValueError(f"the kernel needs page_size % {TILE} == 0 (a tile must not straddle a "
                         f"page), got {page_size}")
    if key_cents.shape[1] != M or value_cents.shape[1] != M_v:
        raise ValueError("codebook subspace counts differ from the pools'")
    for m, c, cents in ((M, C_k, key_cents), (M_v, C_v, value_cents)):
        if d % m or d // m > MAX_DM or cents.shape[3] != d // m or c > 256:
            raise ValueError(f"unsupported geometry M={m} C={c} for d={d}")
    if G > MAX_GROUP or d % 4 or M % 4:
        raise ValueError(f"kernel needs G <= {MAX_GROUP}, d % 4 == 0, M % 4 == 0")
    if not 0 <= layer < L:
        raise ValueError(f"layer={layer} out of range")
    if kpp is not None and kpp < 1:
        raise ValueError(f"kpp={kpp} must be at least one page")
    bound = _n_bound(page_table, page_size, n_bound)
    OK = OV = 0
    null = ctypes.c_void_p(0)
    ko_p = vo_p = kidx_p = vidx_p = null
    if k_outliers is not None:
        _check(k_outliers, "k_outliers", torch.bfloat16, 5, dev)
        _check(k_oidx, "k_oidx", torch.int32, 2, dev)
        OK = k_outliers.shape[-1]
        if k_outliers.shape[:4] != key_pool.shape[:4]:
            raise ValueError("k_outliers must be a pool beside key_pool")
        ko_p, kidx_p = k_outliers[layer].data_ptr(), k_oidx[layer].data_ptr()
    if v_outliers is not None:
        _check(v_outliers, "v_outliers", torch.bfloat16, 5, dev)
        _check(v_oidx, "v_oidx", torch.int32, 2, dev)
        OV = v_outliers.shape[-1]
        if v_outliers.shape[:4] != key_pool.shape[:4]:
            raise ValueError("v_outliers must be a pool beside value_pool")
        vo_p, vidx_p = v_outliers[layer].data_ptr(), v_oidx[layer].data_ptr()
    if M_v + OV > TILE:
        raise ValueError(f"kernel needs M_v + OV <= {TILE} (got {M_v} + {OV})")
    Lt, res_bf16 = 0, 0
    kr_p = vr_p = r_p = null
    if k_residual is not None:
        rdt = k_residual.dtype
        if rdt not in (torch.bfloat16, torch.float32):
            raise ValueError(f"residual window must be bf16 or f32, got {rdt}")
        _check(k_residual, "k_residual", rdt, 5, dev)
        _check(v_residual, "v_residual", rdt, 5, dev)
        _check(r, "r", torch.int32, 1, dev)
        Lt = k_residual.shape[3]
        if k_residual.shape != (L, S_seq, nh_k, Lt, d) or v_residual.shape != k_residual.shape:
            raise ValueError(f"residual window shape {tuple(k_residual.shape)}")
        if Lt > 1024 or r.shape[0] != S_seq:
            raise ValueError(f"residual window of {Lt} rows with r of shape {tuple(r.shape)}")
        kr_p, vr_p, r_p = k_residual[layer].data_ptr(), v_residual[layer].data_ptr(), r.data_ptr()
        res_bf16 = int(rdt == torch.bfloat16)
    n_sm = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    S, fixed = plan_paged_splits(bound, S_seq * nh_k, page_size, n_sm, n_split, kpp)
    scores = torch.empty((S_seq, nh_k, max(bound, 1), G), dtype=torch.float32, device=dev)
    ml_part = torch.empty((S_seq, nh_k, S, G, 2), dtype=torch.float32, device=dev)
    out_part = torch.empty((S_seq, nh_k, S, G, d), dtype=torch.float32, device=dev)
    lse_part = torch.empty((S_seq, nh_k, S, G), dtype=torch.float32, device=dev)
    out = torch.empty((S_seq, nh_k, G, d), dtype=torch.float32, device=dev)
    lse = torch.empty((S_seq, nh_k, G), dtype=torch.float32, device=dev)
    err = _library().pq_paged_attention(
        q.data_ptr(), key_pool[layer].data_ptr(), value_pool[layer].data_ptr(),
        key_cents[layer].data_ptr(), value_cents[layer].data_ptr(),
        ko_p, vo_p, kidx_p, vidx_p, kr_p, vr_p,
        page_table.data_ptr(), n_codes.data_ptr(), r_p,
        scores.data_ptr(), ml_part.data_ptr(), out_part.data_ptr(), lse_part.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        S_seq, nh_k, G, d, M, C_k, M_v, C_v, OK, OV, page_table.shape[1], page_size, bound, S,
        fixed, Lt, res_bf16, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pq_paged_attention launch failed: CUDA error {err}")
    return out, lse


def pq_paged_attention_stacked(
    q: torch.Tensor,
    key_pool: torch.Tensor,
    value_pool: torch.Tensor,
    key_cents: torch.Tensor,
    value_cents: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,
    n_codes: torch.Tensor,
    *,
    n_bound: Optional[int] = None,
    k_outliers: Optional[torch.Tensor] = None,
    v_outliers: Optional[torch.Tensor] = None,
    k_oidx: Optional[torch.Tensor] = None,
    v_oidx: Optional[torch.Tensor] = None,
    k_residual: Optional[torch.Tensor] = None,
    v_residual: Optional[torch.Tensor] = None,
    r: Optional[torch.Tensor] = None,
    n_split: Optional[int] = None,
    kpp: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial attention of every sequence slot over its own pages of layer
    `layer` of the stacked pools.

    q (S, nh_k, G, d) f32 pre-scaled by 1/sqrt(d); arguments as in
    pq_paged_attention_plain. `page_table`, `n_codes` and `r` stay on the
    device; `n_bound` is the caller's host bound on the longest sequence
    (the scheduler's page mirror x page_size) and only sizes the launch.
    `kpp` (pages per block) fixes the split length; None lets each block
    cut its own sequence. Returns (out (S, nh_k, G, d) f32 in natural head
    order, with the exact V outlier channels in place; lse (S, nh_k, G) f32).
    With k_residual / v_residual (L, S, nh_k, Lt, d) and r, the exact partial
    over the first r[b] rows of each window is merged in (the decode tick's
    whole attention). A sequence with n_codes[b] == 0 and no residual rows
    gives out = 0, lse = -1e30."""
    if (k_outliers is None) != (k_oidx is None) or (v_outliers is None) != (v_oidx is None):
        raise ValueError("outlier pools and their channel indices go together")
    if (k_residual is None) != (v_residual is None) or (k_residual is None) != (r is None):
        raise ValueError("k_residual, v_residual and r go together")
    args = (q, key_pool, value_pool, key_cents, value_cents, layer, page_table, n_codes)
    if q.device.type == "cpu":
        return pq_paged_attention_plain(
            *args, n_bound=n_bound, k_outliers=k_outliers, v_outliers=v_outliers, k_oidx=k_oidx,
            v_oidx=v_oidx, k_residual=k_residual, v_residual=v_residual, r=r, n_split=n_split,
            kpp=kpp)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    res = _launch(*args, n_bound, k_outliers, v_outliers, k_oidx, v_oidx, k_residual, v_residual,
                  r, n_split, kpp)
    pq_paged_attention_stacked.launches += 1
    return res


pq_paged_attention_stacked.launches = 0


def pq_paged_attention_stacked_mp(q, key_pool, value_pool, key_cents, value_cents, layer,
                                  page_table, n_codes, *, kpp: Optional[int] = None, **kw):
    """Several pages per block (counterpart of pq_paged_attention_stacked_mp):
    the same kernel with a fixed split of `kpp` pages; None covers 16,384
    tokens per block as the original does."""
    page_size = key_pool.shape[3]
    if kpp is None:
        kpp = max(16384 // page_size, 1)
    return pq_paged_attention_stacked(q, key_pool, value_pool, key_cents, value_cents, layer,
                                      page_table, n_codes, kpp=min(kpp, page_table.shape[1]), **kw)


def pq_paged_attention(
    q: torch.Tensor,  # (S, nh_k, G, d)
    key_pool: torch.Tensor,  # (n_pages, nh_k, page_size, M) uint8: one layer
    value_pool: torch.Tensor,
    key_cents: torch.Tensor,  # (M, C, d_m)
    value_cents: torch.Tensor,
    page_table: torch.Tensor,
    n_codes: torch.Tensor,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-layer entry (counterpart of pq_paged_attention): the stacked
    kernel on a one-layer view of each per-layer argument."""
    layered = ("k_outliers", "v_outliers", "k_oidx", "v_oidx", "k_residual", "v_residual")
    kw = {k: (v[None] if k in layered and v is not None else v) for k, v in kw.items()}
    return pq_paged_attention_stacked(q, key_pool[None], value_pool[None], key_cents[None],
                                      value_cents[None], 0, page_table, n_codes, **kw)


def paged_bytes(n_codes, nh_k: int, M: int, M_v: int, OK: int = 0, OV: int = 0) -> int:
    """Bytes one call must move at least: the codes and outlier channels of
    each sequence's own n_codes[b] tokens, read once. n_codes: host ints."""
    return sum(int(n) for n in n_codes) * nh_k * (M + M_v + 2 * (OK + OV))


def paged_flops(n_codes, nh_k: int, G: int, d: int, OK: int = 0) -> int:
    """f32 FMAs of one call counted as 2 operations: the score dot over d and
    OK outlier channels and the P @ V product over d, per query row and live
    token."""
    return 2 * sum(int(n) for n in n_codes) * nh_k * G * (2 * d + OK)

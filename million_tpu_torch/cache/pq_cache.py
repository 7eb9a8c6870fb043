"""PQ KV-cache state, updated in place.

Counterpart of million_tpu/cache/pq_cache.py. The reference package's cache
is a functional pytree that every step returns anew; here it is a dict of
preallocated tensors that prefill, decode and flush update IN PLACE, plus two
host integers:

  key_codes / value_codes : (L, bs, nh_k, N_max, M | M_v) token-major code
      arena (the kernel reads token rows; no word packing): uint8 for
      C <= 256, int16 for wider codebooks (wide_codes; the reference's int16
      arenas, one code an entry), each side by its own codebook size.
  key_outliers / value_outliers : (L, bs, nh_k, N_max, OK | OV) bf16 exact
      outlier channels (only with OK / OV > 0).
  key_residual / value_residual : (L, bs, nh_k, Lt, d) exact recent tokens in
      the model dtype.
  n_codes, r : Python ints, the quantized-token and residual counts. They
      evolve identically in every layer, so one host counter each replaces
      the reference's per-layer (L,) arrays, and no step reads them back from
      the card.

Invariants: visible tokens = n_codes + r; n_codes is a multiple of 4 (prefill
routes a ragged tail into the residual window and flushes move multiples of
4 tokens).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from million_tpu_torch import resolve_device
from million_tpu_torch.pq.ops import code_dtype

WORD = 4  # n_codes granularity, kept from the reference's word packing

PQCache = Dict[str, Any]


def wide_codes(C: int) -> bool:
    """Whether a C-entry codebook's codes need int16 storage (C > 256); the
    reference package's rule (million_tpu/cache/pq_cache.py:65-68). Raises
    ValueError above 65,536."""
    return code_dtype(C) == torch.int16


@dataclasses.dataclass(frozen=True)
class PQCacheConfig:
    bs: int
    nh_k: int
    d: int
    M: int
    C: int = 256  # the wider side's codebook size: int16 arenas above 256
    Lt: int = 128  # residual window capacity
    N_max: int = 32768  # code arena capacity (quantized tokens)
    dtype: Any = torch.bfloat16
    M_v: Optional[int] = None  # V-side subspace count (None -> M)
    OK: int = 0  # exact K outlier channels per head vector
    OV: int = 0  # exact V outlier channels

    def __post_init__(self):
        if self.N_max % WORD or self.Lt % WORD:
            raise ValueError("N_max and Lt must be multiples of 4")
        wide_codes(self.C)

    @property
    def code_dtype(self) -> torch.dtype:
        """Both arenas' storage type, from the wider side's C, as the
        reference's init_layer_state takes it."""
        return code_dtype(self.C)

    @property
    def m_v(self) -> int:
        return self.M_v or self.M

    @property
    def max_tokens(self) -> int:
        return self.N_max + self.Lt


def init_state(cfg: PQCacheConfig, num_layers: int, device="cuda") -> PQCache:
    """Empty stacked (num_layers, ...) cache on `device`: int16 code arenas
    when cfg.C > 256, else uint8."""
    dev = resolve_device(device)
    L = num_layers
    cdt = cfg.code_dtype
    st: PQCache = {
        "key_codes": torch.zeros((L, cfg.bs, cfg.nh_k, cfg.N_max, cfg.M), dtype=cdt, device=dev),
        "value_codes": torch.zeros((L, cfg.bs, cfg.nh_k, cfg.N_max, cfg.m_v), dtype=cdt, device=dev),
        "key_residual": torch.zeros((L, cfg.bs, cfg.nh_k, cfg.Lt, cfg.d), dtype=cfg.dtype, device=dev),
        "value_residual": torch.zeros((L, cfg.bs, cfg.nh_k, cfg.Lt, cfg.d), dtype=cfg.dtype, device=dev),
        "n_codes": 0,
        "r": 0,
    }
    if cfg.OK:
        st["key_outliers"] = torch.zeros(
            (L, cfg.bs, cfg.nh_k, cfg.N_max, cfg.OK), dtype=torch.bfloat16, device=dev)
    if cfg.OV:
        st["value_outliers"] = torch.zeros(
            (L, cfg.bs, cfg.nh_k, cfg.N_max, cfg.OV), dtype=torch.bfloat16, device=dev)
    return st


def arena_tokens(arena: torch.Tensor) -> int:
    """Token capacity of a code arena (..., N_max, M)."""
    return arena.shape[-2]


def cache_memory_bytes(cfg: PQCacheConfig, num_layers: int) -> Dict[str, float]:
    """Bytes held by the cache, beside its dense bf16 equivalent (a code is
    1 B, or 2 B in an int16 arena)."""
    per = cfg.bs * cfg.nh_k * num_layers
    code_bytes = per * cfg.N_max * (cfg.M + cfg.m_v) * cfg.code_dtype.itemsize
    out_bytes = per * cfg.N_max * (cfg.OK + cfg.OV) * 2
    res_bytes = 2 * per * cfg.Lt * cfg.d * torch.tensor([], dtype=cfg.dtype).element_size()
    dense_bytes = 2 * per * cfg.max_tokens * cfg.d * 2
    total = code_bytes + out_bytes + res_bytes
    return {
        "codes": code_bytes,
        "outliers": out_bytes,
        "residual": res_bytes,
        "total": total,
        "dense_equivalent": dense_bytes,
        "compression": dense_bytes / max(total, 1),
    }


def stacked_prefix_write(
    cache: PQCache,
    li: int,
    kc: torch.Tensor,  # (bs, nh_k, n4, M) codes of the arena's dtype, n4 % 4 == 0
    vc: torch.Tensor,  # (bs, nh_k, n4, M_v)
    k_tail: Optional[torch.Tensor],  # (bs, nh_k, tail, d) exact tail or None
    v_tail: Optional[torch.Tensor],
    k_out: Optional[torch.Tensor] = None,  # (bs, nh_k, n4, OK) exact channels
    v_out: Optional[torch.Tensor] = None,
    at: Optional[int] = None,  # arena position of the codes (None: n_codes)
) -> None:
    """Write one layer's prefill chunk in place: codes and outlier channels
    at token n_codes (or `at`: a sequence shard's local position), the
    ragged tail into the residual window at r.

    The counters are NOT advanced here: they are shared by all layers, so
    the caller advances them once after writing every layer."""
    n4 = kc.shape[2]
    s = cache["n_codes"] if at is None else at
    if s + n4 > cache["key_codes"].shape[3]:
        raise ValueError(f"prefix of {n4} codes overflows the arena at {s}")
    if n4:
        cache["key_codes"][li, :, :, s:s + n4] = kc
        cache["value_codes"][li, :, :, s:s + n4] = vc
        if k_out is not None:
            cache["key_outliers"][li, :, :, s:s + n4] = k_out.to(torch.bfloat16)
        if v_out is not None:
            cache["value_outliers"][li, :, :, s:s + n4] = v_out.to(torch.bfloat16)
    if k_tail is not None and k_tail.shape[2]:
        r0, t = cache["r"], k_tail.shape[2]
        cache["key_residual"][li, :, :, r0:r0 + t] = k_tail
        cache["value_residual"][li, :, :, r0:r0 + t] = v_tail


# --------------------------------------------------------------------------
# single-layer helpers (million_tpu/cache/pq_cache.py:165,194,239)
# --------------------------------------------------------------------------
# One layer's cache is the stacked cache without its leading L axis:
# key_codes / value_codes (bs, nh_k, N_max, M | M_v) uint8 or int16, key_residual /
# value_residual (bs, nh_k, Lt, d), and the host counters n_codes and r. The
# helpers update it in place and return it. They encode through
# pq/ops.runtime_encode, so a CUDA cache runs the fused encode kernel.


def init_layer_state(cfg: PQCacheConfig, device="cuda") -> PQCache:
    """One layer's empty cache (the stacked cache's layer view, owned)."""
    st = init_state(dataclasses.replace(cfg, OK=0, OV=0), 1, device)
    return {k: (v[0].clone() if torch.is_tensor(v) else v) for k, v in st.items()}


def flush_window(state: PQCache, key_cents: torch.Tensor, value_cents: torch.Tensor,
                 layout: str = "strided") -> PQCache:
    """Encode the FULL residual window into the arena at n_codes, then
    n_codes += Lt and r = 0. The window's rows stay in place; new tokens
    overwrite them and r masks them out of attention."""
    from million_tpu_torch.pq.ops import runtime_encode

    Lt = state["key_residual"].shape[2]
    s = state["n_codes"]
    if s + Lt > state["key_codes"].shape[2]:
        raise ValueError(f"a flush of {Lt} codes overflows the arena at {s}")
    for side, cents in (("key", key_cents), ("value", value_cents)):
        state[side + "_codes"][:, :, s:s + Lt] = runtime_encode(state[side + "_residual"], cents, layout)
    state["n_codes"] = s + Lt
    state["r"] = 0
    return state


def prefill_update(state: PQCache, k: torch.Tensor, v: torch.Tensor, key_cents: torch.Tensor,
                   value_cents: torch.Tensor, layout: str = "strided") -> PQCache:
    """Quantize-on-append of a prefill chunk k / v (bs, nh_k, n, d): the
    4-aligned prefix is encoded into the arena at n_codes, a ragged tail of
    n % 4 tokens goes into the exact residual window at r (the reference's
    numerics: those tokens stay exact)."""
    from million_tpu_torch.pq.ops import runtime_encode

    n = k.shape[2]
    n4 = n // WORD * WORD
    tail = n - n4
    s, r0 = state["n_codes"], state["r"]
    if s + n4 > state["key_codes"].shape[2] or r0 + tail > state["key_residual"].shape[2]:
        raise ValueError(f"a prefill of {n} tokens overflows the cache at n_codes={s}, r={r0}")
    if n4:
        state["key_codes"][:, :, s:s + n4] = runtime_encode(k[:, :, :n4], key_cents, layout)
        state["value_codes"][:, :, s:s + n4] = runtime_encode(v[:, :, :n4], value_cents, layout)
        state["n_codes"] = s + n4
    if tail:
        state["key_residual"][:, :, r0:r0 + tail] = k[:, :, n4:]
        state["value_residual"][:, :, r0:r0 + tail] = v[:, :, n4:]
        state["r"] = r0 + tail
    return state


def decode_update(state: PQCache, k: torch.Tensor, v: torch.Tensor, key_cents: torch.Tensor,
                  value_cents: torch.Tensor, layout: str = "strided") -> PQCache:
    """Append one decode token k / v (bs, nh_k, 1, d) to the residual window,
    flushing a full window first (a host test on the counter where the
    reference takes a lax.cond)."""
    if state["r"] >= state["key_residual"].shape[2]:
        flush_window(state, key_cents, value_cents, layout)
    r = state["r"]
    state["key_residual"][:, :, r:r + 1] = k
    state["value_residual"][:, :, r:r + 1] = v
    state["r"] = r + 1
    return state

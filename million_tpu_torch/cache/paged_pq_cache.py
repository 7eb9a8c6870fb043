"""Paged PQ KV cache: a fixed page pool and per-sequence page tables, updated
in place.

Counterpart of million_tpu/cache/paged_pq_cache.py. The reference package's
state is a functional pytree that every call returns anew; here it is a dict
of preallocated tensors on one device that allocate, free, write and the
decode tick update IN PLACE (each function returns the same dict):

  key_pool / value_pool : (L, n_pages + 1, nh_k, page_size, M | M_v) uint8,
      token-major like the flat arena (the paged kernel reads token rows; the
      reference's subspace-major int32 word packing is a TPU workaround).
      Page index n_pages is a reserved SCRATCH page: masked-out writes
      (inactive slots, unallocated table entries, padding) are routed there.
  key_outlier_pool / value_outlier_pool : (L, n_pages + 1, nh_k, page_size,
      OK | OV) bf16 exact outlier channels (only with OK / OV > 0; the
      reference stores byte planes).
  used : (n_pages,) int32, 0 free / 1 used.
  page_table : (max_seqs, pages_per_seq) int32, -1 = unallocated. All layers
      of a sequence share one table and index their own slab of the pool.
  seq_n_codes, seq_n_pages, seq_r, seq_active : (max_seqs,) int32.
  key_residual / value_residual : (L, max_seqs, nh_k, Lt, d) exact recent
      tokens per slot in the model dtype.

The bookkeeping arrays live on the device beside the pools, and nothing here
reads them back (only paged_cache_stats does): the scheduler mirrors what it
needs on the host, as the reference's does. Allocation takes the
lowest-numbered free pages (a stable argsort of `used`) and fails soft with
-1 entries, exactly as the reference, so page tables can be compared page by
page. seq_n_codes stays a multiple of 4 (WORD), the reference's packing
granularity, so that the counters of the two packages agree: a ragged tail
of n % 4 tokens goes to the residual window.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from million_tpu_torch import resolve_device
from million_tpu_torch.cache.pq_cache import WORD
from million_tpu_torch.ops.pq_encode_kernel import pq_encode_fused_stacked
from million_tpu_torch.pq.ops import RUNTIME_ENCODE_PRECISION

PagedState = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PagedPQCacheConfig:
    num_layers: int
    nh_k: int
    d: int
    M: int
    C: int = 256
    Lt: int = 128
    page_size: int = 512  # tokens per page
    n_pages: int = 512  # pool capacity per layer
    max_seqs: int = 8
    pages_per_seq: int = 64
    dtype: Any = torch.bfloat16
    M_v: Optional[int] = None  # V-side subspace count (None -> M)
    OK: int = 0  # exact K outlier channels per head vector
    OV: int = 0  # exact V outlier channels

    def __post_init__(self):
        if self.page_size % WORD or self.Lt % WORD:
            raise ValueError("page_size and Lt must be multiples of 4")
        if self.C > 256:  # a code of 256 or more would spill into its neighbour's byte
            raise NotImplementedError(
                "page pools hold 8-bit codes in both packages (the reference's int32 words of four "
                "codes); wide int16 codes (C > 256) take the flat cache")

    @property
    def m_v(self) -> int:
        return self.M_v or self.M

    @property
    def tokens_capacity(self) -> int:
        return self.n_pages * self.page_size


def init_paged_state(cfg: PagedPQCacheConfig, device="cuda") -> PagedState:
    """Empty pools, tables and residual windows on `device`."""
    dev = resolve_device(device)
    L, P = cfg.num_layers, cfg.n_pages + 1

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    st: PagedState = {
        "key_pool": zeros((L, P, cfg.nh_k, cfg.page_size, cfg.M), torch.uint8),
        "value_pool": zeros((L, P, cfg.nh_k, cfg.page_size, cfg.m_v), torch.uint8),
        "used": zeros((cfg.n_pages,), torch.int32),
        "page_table": torch.full((cfg.max_seqs, cfg.pages_per_seq), -1, dtype=torch.int32, device=dev),
        "seq_n_codes": zeros((cfg.max_seqs,), torch.int32),
        "seq_n_pages": zeros((cfg.max_seqs,), torch.int32),
        "key_residual": zeros((L, cfg.max_seqs, cfg.nh_k, cfg.Lt, cfg.d), cfg.dtype),
        "value_residual": zeros((L, cfg.max_seqs, cfg.nh_k, cfg.Lt, cfg.d), cfg.dtype),
        "seq_r": zeros((cfg.max_seqs,), torch.int32),
        "seq_active": zeros((cfg.max_seqs,), torch.int32),
    }
    if cfg.OK:
        st["key_outlier_pool"] = zeros((L, P, cfg.nh_k, cfg.page_size, cfg.OK), torch.bfloat16)
    if cfg.OV:
        st["value_outlier_pool"] = zeros((L, P, cfg.nh_k, cfg.page_size, cfg.OV), torch.bfloat16)
    return st


def allocate_pages(state: PagedState, seq_id: int, k: int) -> PagedState:
    """Assign k fresh pages to seq_id's table, at positions seq_n_pages ..
    + k. The free pages are the first entries of a stable argsort of `used`,
    so the lowest-numbered free pages are taken; nothing is read back. Fails
    soft: if the pool cannot give k pages, the k entries become -1 and
    `used` / seq_n_pages stay as they were (callers detect it through
    paged_cache_stats' page_table_errors)."""
    used, table = state["used"], state["page_table"]
    if k > used.numel():
        raise ValueError(f"{k} pages asked of a pool of {used.numel()}")
    new_pages = torch.argsort(used, stable=True)[:k]  # free (0) pages first
    ok = used[new_pages].sum() == 0
    used[new_pages] = torch.where(ok, 1, used[new_pages]).to(used.dtype)
    start = state["seq_n_pages"][seq_id]
    # entries past the end of the row are dropped, not written elsewhere
    row = torch.cat([table[seq_id], table.new_empty(k)])
    row[(start + torch.arange(k, device=table.device)).long()] = torch.where(ok, new_pages, -1).to(table.dtype)
    table[seq_id] = row[: table.shape[1]]
    state["seq_n_pages"][seq_id] += torch.where(ok, k, 0).to(torch.int32)
    return state


def free_sequence(state: PagedState, seq_id: int) -> PagedState:
    """Release all of seq_id's pages back to the pool and zero its counters."""
    row = state["page_table"][seq_id]
    valid = row >= 0
    state["used"].index_put_((torch.where(valid, row, 0).long(),),
                             torch.where(valid, -1, 0).to(torch.int32), accumulate=True)
    state["used"].clamp_(0, 1)
    # fill_ on views: assigning a Python number would copy it from the host and wait
    state["page_table"][seq_id].fill_(-1)
    for k in ("seq_n_pages", "seq_n_codes", "seq_r", "seq_active"):
        state[k][seq_id].fill_(0)
    return state


def scatter_tokens(pool: torch.Tensor, layer: Optional[int], pages: torch.Tensor,
                   offs: torch.Tensor, vals: torch.Tensor) -> None:
    """pool[layer, pages[i], :, offs[i]] = vals[i] for index tensors pages /
    offs of one shape (...); vals (..., nh_k, X), or (..., L, nh_k, X) with
    layer None (every layer at once). In place, no readback."""
    pages, offs = pages.long(), offs.long()
    if layer is None:
        pool[:, pages, :, offs] = vals.to(pool.dtype)
    else:
        pool[layer][pages, :, offs] = vals.to(pool.dtype)


def token_pages(state: PagedState, seq_ids: torch.Tensor, t: torch.Tensor,
                real: torch.Tensor):
    """(pages, offs) of token positions t (S, n) of slots seq_ids (S,):
    the slot's table entry for t // page_size where `real` holds and the
    entry is allocated, else the scratch page."""
    page_size = state["key_pool"].shape[3]
    scratch = state["key_pool"].shape[1] - 1
    table = state["page_table"]
    tpos = torch.clamp(t // page_size, 0, table.shape[1] - 1)
    raw = table[seq_ids.long()[:, None], tpos.long()]
    return torch.where(real & (raw >= 0), raw, scratch), t % page_size


def write_codes_to_pages(
    state: PagedState,
    seq_id: int,
    kc: torch.Tensor,  # (L, nh_k, n, M) uint8 token-major codes
    vc: torch.Tensor,  # (L, nh_k, n, M_v)
    cfg: PagedPQCacheConfig,
) -> PagedState:
    """Append n tokens of codes to seq_id's pages at seq_n_codes, each token
    routed through the page table, so an append may straddle pages. n must
    be a multiple of 4 (the counters' granularity). Tokens whose table entry
    is unallocated go to the scratch page: allocate first."""
    n = kc.shape[2]
    if n % WORD:
        raise ValueError(f"paged code append must be 4-aligned (n={n})")
    dev = kc.device
    t = (state["seq_n_codes"][seq_id] + torch.arange(n, device=dev))[None, :]
    pages, offs = token_pages(state, torch.tensor([seq_id], device=dev), t, torch.ones_like(t, dtype=torch.bool))
    scatter_tokens(state["key_pool"], None, pages[0], offs[0], kc.permute(2, 0, 1, 3))
    scatter_tokens(state["value_pool"], None, pages[0], offs[0], vc.permute(2, 0, 1, 3))
    state["seq_n_codes"][seq_id] += n
    return state


def paged_prefill(
    state: PagedState,
    seq_id: int,
    k: torch.Tensor,  # (L, nh_k, n, d)
    v: torch.Tensor,
    key_cents: torch.Tensor,  # (L, M, C, d_m)
    value_cents: torch.Tensor,
    cfg: PagedPQCacheConfig,
    layout: str = "strided",
) -> PagedState:
    """Encode a prefill chunk for all layers (one fused encode per side, a
    codebook bank per layer) and write it into pages, which must already be
    allocated. The 4-aligned prefix goes to pages; a ragged tail of n % 4
    tokens goes into the slot's exact residual window."""
    n = k.shape[2]
    n4 = (n // WORD) * WORD
    kc = pq_encode_fused_stacked(k[:, :, :n4], key_cents, layout, precision=RUNTIME_ENCODE_PRECISION)
    vc = pq_encode_fused_stacked(v[:, :, :n4], value_cents, layout, precision=RUNTIME_ENCODE_PRECISION)
    write_codes_to_pages(state, seq_id, kc, vc, cfg)
    if n > n4:
        state["key_residual"][:, seq_id, :, : n - n4] = k[:, :, n4:].to(state["key_residual"].dtype)
        state["value_residual"][:, seq_id, :, : n - n4] = v[:, :, n4:].to(state["value_residual"].dtype)
        state["seq_r"][seq_id].fill_(n - n4)
    state["seq_active"][seq_id].fill_(1)
    return state


def paged_cache_stats(state: PagedState, cfg: PagedPQCacheConfig) -> Dict[str, Any]:
    """Pool observability: one host readback of the small bookkeeping arrays
    (this waits for the device; the pools are never touched). Returns pool
    occupancy, per-sequence pages / codes / residual counts, the byte
    accounting of the compression, and page_table_errors: -1 entries inside
    an active sequence's allocated range mean that the pool was exhausted
    behind the caller's accounting and codes went to the scratch page."""
    used = state["used"].cpu().numpy()
    active = state["seq_active"].cpu().numpy()
    n_codes = state["seq_n_codes"].cpu().numpy()
    n_pages_seq = state["seq_n_pages"].cpu().numpy()
    seq_r = state["seq_r"].cpu().numpy()
    table = state["page_table"].cpu().numpy()
    L = state["key_pool"].shape[0]

    pages_used = int(used.sum())
    table_errors = sum(int((table[i, : n_pages_seq[i]] < 0).sum())
                       for i in range(cfg.max_seqs) if active[i])
    bytes_per_token_codes = L * cfg.nh_k * (cfg.M + cfg.m_v)
    dtype_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    bytes_per_token_dense = L * cfg.nh_k * 2 * cfg.d * dtype_bytes
    live_tokens = int((n_codes * active).sum())
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    return {
        "pages_total": cfg.n_pages,
        "pages_used": pages_used,
        "pages_free": cfg.n_pages - pages_used,
        "pool_utilization": pages_used / max(cfg.n_pages, 1),
        "tokens_capacity": cfg.tokens_capacity,
        "active_seqs": int(active.sum()),
        "per_seq": [
            {"slot": i, "active": bool(active[i]), "n_codes": int(n_codes[i]),
             "n_pages": int(n_pages_seq[i]), "residual_len": int(seq_r[i])}
            for i in range(cfg.max_seqs)
        ],
        "live_code_bytes": live_tokens * bytes_per_token_codes,
        "dense_kv_bytes_replaced": live_tokens * bytes_per_token_dense,
        "compression_x": (bytes_per_token_dense / bytes_per_token_codes
                          if bytes_per_token_codes else float("nan")),
        "pool_reserved_bytes": nbytes(state["key_pool"]) + nbytes(state["value_pool"]),
        "residual_reserved_bytes": nbytes(state["key_residual"]) + nbytes(state["value_residual"]),
        "page_table_errors": table_errors,
    }

"""Sequence- and head-sharded PAGED PQ serving over a mesh.

Counterpart of million_tpu/parallel/paged_sharded.py. The layout is the
reference's:

  * every sequence shard s owns a contiguous token range of every slot:
    table positions [s pps_l, (s + 1) pps_l) of each slot's page table
    (pps_l = pages_per_seq / n_sp), tokens [s cap_l, (s + 1) cap_l). Shards
    fill in order as a slot grows, so a shard's valid count is
    clip(n_codes - s cap_l, 0, cap_l), computed on the device from the
    replicated counters;
  * each shard has its own slab of P_l = n_pages / n_sp pages plus its own
    scratch page (local index P_l); heads split over tp. A rank holds the
    state of its slab only: pools (L, P_l + 1, nh_k / tp, page_size, M),
    `used` (P_l,), and its columns (S, pps_l) of the page table, whose
    entries are LOCAL page ids; counters and residual windows (its heads)
    are replicated;
  * decode attention: each shard runs the paged kernel (B4) over its slab
    and the shards LSE-merge (sharded_decode.merge_over); the residual
    window is folded by shard 0 only;
  * writes (flushes, admission) go through the page table per shard: a token
    whose table position another shard owns lands on this shard's scratch
    page (models/paged_decode.py, `token_pages(shard=...)`);
  * chunked admission's history partial runs B3 over each shard's own pages
    and merges;
  * page allocation is host-side (runtime/scheduler.ShardedScheduler).

The global layout (pools (L, n_sp (P_l + 1), nh_k, page_size, M) in shard
order, `used` (n_sp, P_l), the page table (S, pages_per_seq) of local ids) is
the one a session snapshot holds: `gather_paged_state` builds it from the
ranks' slabs and `slice_paged_state` cuts a rank's slab out of it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig, PagedState, init_paged_state
from million_tpu_torch.ops.pq_paged_attention_kernel import (
    pq_paged_attention_plain,
    pq_paged_attention_stacked,
)
from million_tpu_torch.parallel.mesh import Mesh, seq_shard
from million_tpu_torch.parallel.sharded_decode import FOLDING_SHARD, empty_partial, merge_over

# the pools: their page axis splits over the sequence shards, their head axis over tp
_POOLS = ("key_pool", "value_pool", "key_outlier_pool", "value_outlier_pool")


def paged_shard_info(pcfg: PagedPQCacheConfig, mesh: Optional[Mesh]) -> Tuple[int, int, int, int]:
    """(n_sp, P_l, pps_l, cap_l): sequence-shard count, local pool pages,
    local table width, local token capacity per slot (one shard of the
    whole pool without a mesh)."""
    n_sp = seq_shard(mesh)[1]
    tp = 1 if mesh is None else mesh.size("tp")
    if pcfg.n_pages % n_sp:
        raise ValueError(f"n_pages={pcfg.n_pages} not divisible by sp={n_sp}")
    if pcfg.pages_per_seq % n_sp:
        raise ValueError(f"pages_per_seq={pcfg.pages_per_seq} not divisible by sp={n_sp}")
    if pcfg.nh_k % tp:
        raise ValueError(f"nh_k={pcfg.nh_k} not divisible by tp={tp}")
    P_l = pcfg.n_pages // n_sp
    pps_l = pcfg.pages_per_seq // n_sp
    return n_sp, P_l, pps_l, pps_l * pcfg.page_size


def local_config(pcfg: PagedPQCacheConfig, mesh: Mesh) -> PagedPQCacheConfig:
    """The config of this rank's slab: its pages, table columns and heads."""
    _, P_l, pps_l, _ = paged_shard_info(pcfg, mesh)
    return dataclasses.replace(pcfg, n_pages=P_l, pages_per_seq=pps_l,
                               nh_k=pcfg.nh_k // mesh.size("tp"))


def init_sharded_paged_state(pcfg: PagedPQCacheConfig, mesh: Mesh) -> PagedState:
    """This rank's empty slab: pools with their own scratch page at local
    index P_l, its `used` map and its page-table columns (local ids)."""
    return init_paged_state(local_config(pcfg, mesh), device=mesh.device)


def shard_of(pcfg: PagedPQCacheConfig, mesh: Optional[Mesh]) -> Optional[Tuple[int, int]]:
    """(s, pps_l) for token_pages' routing, None off a mesh."""
    if mesh is None:
        return None
    return mesh.seq_index, paged_shard_info(pcfg, mesh)[2]


def sharded_paged_attention_stacked(
    mesh: Optional[Mesh],
    pcfg: PagedPQCacheConfig,
    q: torch.Tensor,  # (S, nh_k_l, G, d) f32 pre-scaled
    key_pool: torch.Tensor,  # this rank's slab (L, P_l + 1, nh_k_l, page_size, M)
    value_pool: torch.Tensor,
    key_cents: torch.Tensor,
    value_cents: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # (S, pps_l) local ids
    n_codes: torch.Tensor,  # (S,) GLOBAL counts, replicated
    *,
    n_bound: Optional[int] = None,  # host bound on the GLOBAL counts
    k_residual: Optional[torch.Tensor] = None,
    v_residual: Optional[torch.Tensor] = None,
    r: Optional[torch.Tensor] = None,
    use_kernel: Optional[bool] = None,  # False: the plain version on any device
    **outliers,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """pq_paged_attention_stacked with the pool sequence-sharded: each shard
    runs the kernel over its slab with nc_local = clip(n_codes - s cap_l, 0,
    cap_l), shard 0 folds the residual window, and the shards LSE-merge.
    Returns the merged (out, lse), the same on every sequence shard; one
    launch over the whole pool without a mesh."""
    n_sp, P_l, pps_l, cap_l = paged_shard_info(pcfg, mesh)
    s = seq_shard(mesh)[0]
    # one shard owns every token: no device arithmetic on the counts
    nc_local = n_codes if n_sp == 1 else torch.clamp(n_codes - s * cap_l, 0, cap_l).to(torch.int32)
    bound = None if n_bound is None else min(max(n_bound - s * cap_l, 0), cap_l)
    fold = k_residual is not None and s == FOLDING_SHARD
    if bound == 0 and not fold:
        out, lse = empty_partial(q)
    else:
        attn = pq_paged_attention_plain if use_kernel is False else pq_paged_attention_stacked
        rkw = dict(k_residual=k_residual, v_residual=v_residual, r=r) if fold else {}
        out, lse = attn(q, key_pool, value_pool, key_cents, value_cents, layer, page_table,
                        nc_local, n_bound=bound, **rkw, **outliers)
    return merge_over(out, lse, mesh)


def sharded_history(mesh: Optional[Mesh], pcfg: PagedPQCacheConfig, q: torch.Tensor, n_prev: int,
                    partial) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked admission's history partial with the pool sharded: each
    shard runs `partial(n_prev_local)` (the chunk-history kernel, B3, over
    its own pages of the first n_prev_local tokens) with n_prev_local =
    clip(n_prev - s cap_l, 0, cap_l), and the shards LSE-merge."""
    n_sp, P_l, pps_l, cap_l = paged_shard_info(pcfg, mesh)
    nv = min(max(n_prev - seq_shard(mesh)[0] * cap_l, 0), cap_l)
    out, lse = partial(nv) if nv else empty_partial(q)
    return merge_over(out, lse, mesh)


# --------------------------------------------------------------------------
# the global (snapshot) layout
# --------------------------------------------------------------------------

def _seq_dim(key: str) -> Optional[int]:
    if key in _POOLS:
        return 1
    return {"page_table": 1, "used": 0}.get(key)


def _tp_dim(key: str) -> Optional[int]:
    if key in _POOLS or key in ("key_residual", "value_residual"):
        return 2
    return None


def gather_paged_state(state: PagedState, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The ranks' slabs joined into the global layout (every rank calls it;
    every rank gets the whole state)."""
    out = {}
    for k, v in state.items():
        if _tp_dim(k) is not None:
            v = mesh.all_gather(v, "tp", _tp_dim(k))
        if _seq_dim(k) is not None:
            v = v[None] if k == "used" else v
            v = mesh.all_gather(v, "seq", _seq_dim(k))
        out[k] = v
    return out


def slice_paged_state(state: Dict[str, torch.Tensor], pcfg: PagedPQCacheConfig,
                      mesh: Mesh) -> PagedState:
    """This rank's slab of a global-layout state, on the mesh's device."""
    n_sp, P_l, pps_l, _ = paged_shard_info(pcfg, mesh)
    s, t, tp = mesh.seq_index, mesh.index("tp"), mesh.size("tp")
    out = {}
    for k, v in state.items():
        if k in _POOLS:
            v = v[:, s * (P_l + 1):(s + 1) * (P_l + 1)]
        elif k == "page_table":
            v = v[:, s * pps_l:(s + 1) * pps_l]
        elif k == "used":
            v = v.reshape(n_sp, P_l)[s]
        if _tp_dim(k) is not None:
            h = v.shape[2] // tp
            v = v[:, :, t * h:(t + 1) * h]
        out[k] = v.contiguous().to(mesh.device)
    return out

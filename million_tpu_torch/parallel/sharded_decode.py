"""Sequence-sharded PQ decode attention over a mesh.

Counterpart of million_tpu/parallel/sharded_decode.py. Each sequence shard
owns a contiguous slice of the code arena, runs the decode kernel (B1, or B2
on one layer) over its slice with

    local_valid = clip(n_codes - i * n_local, 0, n_local),

and the shards combine their (out, lse) with the associative LSE merge in
two collectives: a MAX all-reduce of the lse, then ONE SUM all-reduce of the
concatenated (num, den). The exact V outlier channels are part of `out` here
(the kernel writes them in place), so they ride the same merge.

The residual window is replicated over the sequence axes; the kernel folds
it into the same launch, so exactly one shard (shard 0) is given it, or the
merge would count it once per shard. A shard that holds no valid token and
no window launches nothing and contributes lse = -1e30 with out = 0 (finite),
which the merge weights by exp(-1e30 - max) = 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from million_tpu_torch.ops.pq_attention_kernel import (
    pq_codes_attention_plain,
    pq_codes_attention_stacked,
)
from million_tpu_torch.ops.pq_attention_ref import NEG_INF
from million_tpu_torch.parallel.mesh import Mesh, seq_shard

FOLDING_SHARD = 0  # the sequence shard that folds the replicated residual window


def merge_over(out: torch.Tensor, lse: torch.Tensor, mesh: Optional[Mesh],
               axis: str = "seq") -> Tuple[torch.Tensor, torch.Tensor]:
    """LSE merge of the shards' partials (out (..., X) f32, lse (...) f32)
    in two collectives over `axis` (none over an axis of one shard, where
    the merge is the identity). Returns the merged (out, lse)."""
    if mesh is None or mesh.size(axis) == 1:
        return out, lse
    mx = mesh.all_reduce(lse.clone(), axis, "max")
    w = torch.exp(lse - mx)
    tot = mesh.all_reduce(torch.cat([out * w[..., None], w[..., None]], dim=-1), axis, "sum")
    den = torch.clamp(tot[..., -1], min=1e-30)
    return tot[..., :-1] / den[..., None], mx + torch.log(den)


def local_valid(mesh: Optional[Mesh], n_codes: int, n_local: int) -> int:
    i = seq_shard(mesh)[0]
    return min(max(n_codes - i * n_local, 0), n_local)


def empty_partial(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of a shard with nothing to attend: zeros and -1e30."""
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device))


def sharded_pq_codes_attention_stacked(
    mesh: Optional[Mesh],
    q: torch.Tensor,  # (bs_l, nh_k_l, G, d) f32 pre-scaled, this rank's batch and heads
    key_codes: torch.Tensor,  # (L, bs_l, nh_k_l, n_local, M): this rank's arena shard
    value_codes: torch.Tensor,
    key_cents: torch.Tensor,  # (L, M, C, d_m), replicated
    value_cents: torch.Tensor,
    layer: int,
    n_codes: int,  # GLOBAL valid token count
    *,
    k_outliers: Optional[torch.Tensor] = None,  # (L, bs_l, nh_k_l, n_local, OK)
    v_outliers: Optional[torch.Tensor] = None,
    k_oidx: Optional[torch.Tensor] = None,
    v_oidx: Optional[torch.Tensor] = None,
    k_residual: Optional[torch.Tensor] = None,  # (L, bs_l, nh_k_l, Lt, d), replicated
    v_residual: Optional[torch.Tensor] = None,
    r: int = 0,
    plain: bool = False,  # the kernel's plain version on any device, in one pass over the shard
) -> Tuple[torch.Tensor, torch.Tensor]:
    """pq_codes_attention_stacked with the arena sequence-sharded: returns
    the merged (out (bs_l, nh_k_l, G, d) f32, lse (bs_l, nh_k_l, G) f32), the
    same on every shard of the sequence axes. Without a mesh the one shard
    holds the whole arena: one launch, no merge."""
    nv = local_valid(mesh, n_codes, key_codes.shape[3])
    fold = k_residual is not None and seq_shard(mesh)[0] == FOLDING_SHARD and r > 0
    if nv == 0 and not fold:
        out, lse = empty_partial(q)
    else:
        attn = pq_codes_attention_plain if plain else pq_codes_attention_stacked
        okw = dict(k_outliers=k_outliers, v_outliers=v_outliers, k_oidx=k_oidx, v_oidx=v_oidx)
        if plain:  # one split: the reference's oracle decodes the codes in one pass too
            okw["chunk"] = max(nv, 1)
        if fold:
            okw.update(k_residual=k_residual, v_residual=v_residual, r=r)
        out, lse = attn(q, key_codes, value_codes, key_cents, value_cents, layer, nv, **okw)
    return merge_over(out, lse, mesh)


def sharded_pq_codes_attention(
    mesh: Optional[Mesh],
    q: torch.Tensor,  # (bs_l, nh_k_l, G, d)
    key_codes: torch.Tensor,  # (bs_l, nh_k_l, n_local, M)
    value_codes: torch.Tensor,
    key_cents: torch.Tensor,  # (M, C, d_m)
    value_cents: torch.Tensor,
    n_codes: int,
    **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The single-layer entry (B2): the stacked form on one-layer views."""
    one = lambda t: None if t is None else t.unsqueeze(0)  # noqa: E731
    kw = {k: (one(v) if torch.is_tensor(v) else v) for k, v in kw.items()}
    return sharded_pq_codes_attention_stacked(
        mesh, q, one(key_codes), one(value_codes), one(key_cents), one(value_cents), 0, n_codes, **kw)

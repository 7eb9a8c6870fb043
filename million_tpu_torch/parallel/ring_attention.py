"""Ring causal attention: prefill attention with the sequence split over the
mesh's sequence axes.

Counterpart of million_tpu/parallel/ring_attention.py, plain PyTorch in f32
as the reference's is plain jnp. Each of the P shards holds one contiguous
block of queries and keys; over P steps the K/V blocks travel around the ring
(one batch_isend_irecv pair a step, through the host where ranks share a card
under gloo) while every shard folds the visiting block into its online-softmax
accumulator. Shard i's queries own global positions [i n, (i + 1) n): a block
from shard j is attended whole when j < i, not at all when j > i, and under
the causal mask when j == i. Step 0 folds the diagonal block, where every
query attends at least itself, so the running max is finite from then on and
the masked blocks add exp(-1e30 - m) = 0. The last block is folded without a
trailing send.

The blocks travel with their nh_k KV heads; the GQA expansion happens in the
fold (the reference expands before the ring and so sends G times the bytes).
"""

from __future__ import annotations

from typing import Optional

import torch

from million_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def ring_causal_local(
    q: torch.Tensor,  # (bs, nh, n_loc, d): this shard's query block
    k: torch.Tensor,  # (bs, nh_k, n_loc, d)
    v: torch.Tensor,
    mesh: Mesh,
    scale: float,
    axis: str = "seq",
    q_block: int = 4096,
) -> torch.Tensor:
    """This shard's block of causal attention over the whole sequence:
    (bs, nh, n_loc, d) in q's dtype, the statistics in f32. Query rows go
    q_block at a time (bounds the (rows, n_loc) score transient)."""
    bs, nh, n_loc, d = q.shape
    nk = k.shape[1]
    G = nh // nk
    P, i = mesh.size(axis), mesh.index(axis)
    qf = (q.to(torch.float32) * scale).reshape(bs, nk, G * n_loc, d)  # rows (g, pos)
    q_pos = i * n_loc + torch.arange(n_loc, device=q.device).repeat(G)[:, None]
    k_off = torch.arange(n_loc, device=q.device)[None, :]
    m = torch.full((bs, nk, G * n_loc, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((bs, nk, G * n_loc, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v]).to(torch.float32)  # one message a step
    R = G * n_loc
    for s in range(P):
        src = (i - s) % P  # owner of the visiting block
        # a block from a later shard is masked whole: folding it adds exactly 0
        for a in range(0, R, q_block) if src <= i else ():
            b = min(a + q_block, R)
            sc = qf[:, :, a:b] @ kv[0].transpose(-1, -2)
            sc = torch.where(q_pos[a:b] >= src * n_loc + k_off, sc, NEG_INF)
            m_new = torch.maximum(m[:, :, a:b], sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m[:, :, a:b] - m_new)
            l[:, :, a:b] = l[:, :, a:b] * alpha + p.sum(-1, keepdim=True)
            acc[:, :, a:b] = acc[:, :, a:b] * alpha + p @ kv[1]
            m[:, :, a:b] = m_new
        if s < P - 1:
            kv = mesh.ring_shift(kv, axis)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(bs, nh, n_loc, d).to(q.dtype)


def ring_causal_attention(
    mesh: Mesh,
    q: torch.Tensor,  # (bs, nh, n_loc, d): this rank's block of the sequence
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis: str = "sp",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention with the sequence split over `axis` ("sp", or "seq"
    for ("dcn", "sp")): each rank passes and gets back its own block."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return ring_causal_local(q, k, v, mesh, scale, axis)

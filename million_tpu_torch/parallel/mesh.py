"""The device mesh and the sharding layouts, one process per rank.

Counterpart of million_tpu/parallel/mesh.py. The mesh has the reference's
axes ("dcn", "dp", "tp", "sp"):

  dp : data parallel, splits the batch (no collectives);
  tp : tensor parallel (Megatron): wq / wk / wv and their biases split by
       heads, wo by its input rows, w_gate / w_up by columns, w_down by rows;
       an all-reduce after wo and after w_down joins the partial sums;
  sp : sequence parallel for the code arena: each shard owns a contiguous
       token range and the shards LSE-merge their partials;
  dcn: the multi-slice axis; the code sequence shards over ("dcn", "sp"),
       linearised dcn-major, as the reference's.

Global rank r sits at the row-major coordinates of r in (dcn, dp, tp, sp).
A rank holds only its own slices: `shard_params` / `shard_cache` cut them out
of the full parameters and cache (the reference package's, carried over by
convert.py, or the port's own). Codebooks and tables are replicated.

Each axis (and "seq" = ("dcn", "sp"), and "world") has a process group; when
torch.distributed is initialised every collective runs through its group,
also on an axis of size 1 (so that a 1-rank group exercises the backend),
but for the LSE merge, which is the identity over one shard and is skipped
there. A mesh made without torch.distributed has one rank and no groups, and
every collective is the identity.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from million_tpu_torch.parallel import distributed as D

AXES = ("dcn", "dp", "tp", "sp")
GROUP_AXES = {"dcn": ("dcn",), "dp": ("dp",), "tp": ("tp",), "sp": ("sp",),
              "seq": ("dcn", "sp"), "world": AXES}


@dataclasses.dataclass
class Mesh:
    shape: Dict[str, int]  # axis -> size, in AXES order
    rank: int  # global rank
    device: torch.device
    groups: Dict[str, Any]  # "dcn" ... "sp", "seq", "world" -> ProcessGroup or None
    members: Dict[str, List[int]]  # the same keys -> this rank's group as global ranks, in order
    routes: Dict[str, str] = dataclasses.field(default_factory=dict)  # op -> route, as first taken

    @property
    def coords(self) -> Dict[str, int]:
        return dict(zip(AXES, np.unravel_index(self.rank, [self.shape[a] for a in AXES])))

    def size(self, axis: str) -> int:
        return int(np.prod([self.shape[a] for a in GROUP_AXES[axis]]))

    def index(self, axis: str) -> int:
        """This rank's index along `axis`; "seq" linearises (dcn, sp) dcn-major."""
        return self.members[axis].index(self.rank)

    @property
    def n_seq(self) -> int:
        return self.size("seq")

    @property
    def seq_index(self) -> int:
        return self.index("seq")

    # ---- collectives (identity without torch.distributed) --------------------
    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        if self.groups[axis] is None:
            return t
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return D.all_reduce(t, rop, self.groups[axis], self.routes)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        if self.groups[axis] is None:
            return t
        return D.all_gather(t, dim, self.groups[axis], self.routes)

    def broadcast(self, t: torch.Tensor, axis: str = "world", src: int = 0) -> torch.Tensor:
        """Broadcast t from the group's src-th member."""
        if self.groups[axis] is None:
            return t
        return D.broadcast(t, self.members[axis][src], self.groups[axis], self.routes)

    def ring_shift(self, t: torch.Tensor, axis: str = "seq") -> torch.Tensor:
        """Send t to the next rank of the axis's ring, return the previous
        rank's."""
        if self.groups[axis] is None:
            return t
        m, i = self.members[axis], self.index(axis)
        return D.ring_exchange(t, m[(i + 1) % len(m)], m[(i - 1) % len(m)], self.groups[axis],
                               self.routes)

    def barrier(self) -> None:
        if self.groups["world"] is not None:
            dist.barrier(group=self.groups["world"])


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, dcn: int = 1, device=None) -> Mesh:
    """The mesh over every rank of the process group (world size dcn * dp *
    tp * sp), or a one-rank mesh without one. Every rank calls it with the
    same arguments: the groups are made in one order everywhere. The mesh's
    device is the one `distributed.initialize` chose for this rank (its own
    card, the shared card or the CPU); without a process group, `device`,
    by default the card. A "cuda" without an index names this rank's card."""
    shape = dict(zip(AXES, (dcn, dp, tp, sp)))
    n = dcn * dp * tp * sp
    grid = np.arange(n).reshape(dcn, dp, tp, sp)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs torch.distributed with {n} processes "
                             "(parallel.distributed.initialize), one per rank")
        dev = torch.device(device or "cuda")
        return Mesh(shape, 0, dev, {k: None for k in GROUP_AXES}, {k: [0] for k in GROUP_AXES})
    if dist.get_world_size() != n:
        raise ValueError(f"mesh of {n} ranks in a process group of {dist.get_world_size()}")
    rank = dist.get_rank()
    dev = D.device() if device is None else D.rank_device(str(device), D.local_rank(), D.local_world())
    groups, members = {}, {}
    for key, axes in GROUP_AXES.items():
        # every set of ranks that share the coordinates off these axes, in order
        keep = [AXES.index(a) for a in axes]
        rest = [i for i in range(4) if i not in keep]
        for fixed in itertools.product(*[range(grid.shape[i]) for i in rest]):
            idx = [slice(None)] * 4
            for i, v in zip(rest, fixed):
                idx[i] = v
            ranks = grid[tuple(idx)].reshape(-1).tolist()  # row-major over `axes`: dcn-major for seq
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[key], members[key] = g, ranks
    return Mesh(shape, rank, dev, groups, members)


def seq_shard(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(this rank's index along the sequence axes, their size); (0, 1)
    without a mesh, where one shard owns the whole arena."""
    return (0, 1) if mesh is None else (mesh.seq_index, mesh.n_seq)


# --------------------------------------------------------------------------
# layouts: which axis of each tensor splits over which mesh axis
# --------------------------------------------------------------------------

def param_shardings(mesh: Mesh, attn_bias: bool = False) -> Dict[str, Any]:
    """{name: {tensor dim: mesh axis}} of the stacked-layer parameters
    (Megatron TP); empty for replicated tensors."""
    extra = {"bq": {1: "tp"}, "bk": {1: "tp"}, "bv": {1: "tp"}} if attn_bias else {}
    return {
        "embed": {}, "final_norm": {}, "lm_head": {},
        "layers": {
            "attn_norm": {}, "mlp_norm": {},
            "wq": {1: "tp"}, "wk": {1: "tp"}, "wv": {1: "tp"},  # (L, out, in)
            "wo": {2: "tp"},  # (L, D, nh*dh)
            "w_gate": {2: "tp"}, "w_up": {2: "tp"}, "w_down": {1: "tp"},
            **extra,
        },
    }


def pq_cache_shardings(mesh: Mesh) -> Dict[str, Any]:
    """The flat PQ cache: codes and exact outlier channels split over the
    sequence axes in contiguous ranges, batch over dp, KV heads over tp; the
    residual window replicated over the sequence axes."""
    arena = {1: "dp", 2: "tp", 3: "seq"}
    window = {1: "dp", 2: "tp"}
    return {"key_codes": arena, "value_codes": arena, "key_outliers": arena,
            "value_outliers": arena, "key_residual": window, "value_residual": window}


def dense_cache_shardings(mesh: Mesh) -> Dict[str, Any]:
    """The dense cache: batch over dp, KV heads over tp, the sequence
    replicated (the dense decode attends over the whole cache on every
    rank; ROADMAP section C)."""
    return {"k": {1: "dp", 2: "tp"}, "v": {1: "dp", 2: "tp"}}


def local_slice(t: torch.Tensor, dims: Dict[int, str], mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of t along each sharded dim."""
    for dim, axis in dims.items():
        n = mesh.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over {axis}={n}")
        w = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axis) * w, w)
    return t


def shard_tree(tree: Any, shardings: Any, mesh: Mesh) -> Any:
    """Cut this rank's slices out of a tree of full tensors (dicts align by
    the tree's keys; ints and tensors without a layout are kept whole), as
    contiguous copies on the mesh's device."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings.get(k, {}) if isinstance(shardings, dict) else {}, mesh)
                for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    return local_slice(tree, shardings or {}, mesh).contiguous().to(mesh.device)


def shard_params(params: Dict[str, Any], mesh: Mesh, attn_bias: bool = False) -> Dict[str, Any]:
    return shard_tree(params, param_shardings(mesh, attn_bias), mesh)


def shard_cache(cache: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's flat PQ (or dense) cache; the host counters stay global."""
    lay = dense_cache_shardings(mesh) if "k" in cache else pq_cache_shardings(mesh)
    return shard_tree(cache, lay, mesh)


def overlap(mesh: Optional[Mesh], n_local: int, start: int, n: int):
    """The part of global tokens [start, start + n) this rank's arena shard
    (global tokens [i n_local, (i + 1) n_local)) owns, as (offset into those
    n tokens, offset into the local arena, count); count 0 when it owns
    none. Raises when the tokens overflow the arena of every shard."""
    i, n_seq = seq_shard(mesh)
    if start + n > n_local * n_seq:
        raise ValueError(f"write of {n} codes overflows the arena at {start}")
    lo = i * n_local
    a, b = max(start, lo), min(start + n, lo + n_local)
    if b <= a:
        return 0, 0, 0
    return a - start, a - lo, b - a

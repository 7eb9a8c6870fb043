"""Process groups and the collectives of the mesh paths, over
torch.distributed: one process per rank.

Counterpart of million_tpu/parallel/distributed.py. The reference package
has one controller that sees every device, and GSPMD / shard_map insert its
collectives; here every rank is a process that runs the same program on its
own slices and calls each collective itself, in the same order on every rank.

`initialize()` joins the process group: under `torchrun` from its environment
(`env://`), else from an explicit rank, world size and init method (a
`file://` store in the tests, `tcp://localhost:<port>` on one machine). With
neither it stays single-process, as the reference's does.

The backend follows from the devices, decided once and printed:
  * NCCL when each rank has its own card;
  * gloo on the CPU;
  * gloo when the ranks share a card. Gloo takes CUDA tensors for
    all-reduce and broadcast only (GLOO_CUDA_OPS); the other operations
    (all-gather, the ring's send / recv) copy to the host and back,
    explicitly ("host-staged" in `Mesh.routes`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL where each of the `local_world` ranks of this machine has a card
    of its own, else gloo (the CPU, or ranks that share a card)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(device: str, local_rank: int, local_world: int) -> torch.device:
    """The device of this rank: its own card where every rank has one, else
    the one card they share, or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    return torch.device("cuda", local_rank if n >= local_world else 0)


_DEVICE: Optional[torch.device] = None  # this rank's device, as initialize chose it


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None, device: str = "cuda",
               backend: Optional[str] = None) -> Optional[torch.device]:
    """Join the process group once. Returns this rank's device (under
    torchrun its LOCAL_RANK card where every rank has one; device="cpu"
    for CPU ranks), or None when there is no launcher and no explicit rank
    (single-process)."""
    global _DEVICE
    if dist.is_initialized():
        return _DEVICE or rank_device(device, local_rank(), local_world())
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if rank is None and not env:
        return None
    if rank is None:  # a launcher's ranks; its store unless the caller names another
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if world_size is None or init_method is None:
        raise ValueError("an explicit rank needs world_size and init_method")
    lworld = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)), lworld)
    backend = backend or choose_backend(dev, lworld)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    _DEVICE = dev
    if rank == 0:
        shared = dev.type == "cuda" and backend == "gloo"
        print(f"[distributed] {world_size} ranks, backend {backend} on {dev.type}"
              f"{' (one card shared: all-gather and send / recv host-staged)' if shared else ''}",
              flush=True)
    return dev


def device() -> torch.device:
    """This rank's device: the one initialize chose, else (a process group
    that another caller made) this rank's card where there is one."""
    if _DEVICE is not None:
        return _DEVICE
    return rank_device("cuda" if torch.cuda.is_available() else "cpu", local_rank(), local_world())


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def local_world() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def shutdown() -> None:
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


# --------------------------------------------------------------------------
# collectives over one axis group of a mesh
# --------------------------------------------------------------------------

def route(op: str, t: torch.Tensor) -> str:
    """How `op` moves tensor t under the current backend: "nccl", "gloo",
    or "host-staged" (gloo on a CUDA tensor for an operation it lacks)."""
    b = backend()
    if b == "nccl":
        return "nccl"
    if t.is_cuda and op not in GLOO_CUDA_OPS:
        return "host-staged"
    return "gloo"


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """t as raw bytes on its last axis: gloo moves no int16, and a byte view
    moves every dtype bit for bit."""
    t = t.contiguous()
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def all_reduce(t: torch.Tensor, op, group, routes: dict) -> torch.Tensor:
    """In-place all-reduce of t (op: dist.ReduceOp.SUM / MAX). A strided
    view is reduced through a contiguous copy: the backends reduce the
    storage behind the data pointer."""
    r = routes.setdefault("all_reduce", route("all_reduce", t))
    if r == "host-staged" or not t.is_contiguous():
        h = t.cpu() if r == "host-staged" else t.contiguous()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group, routes: dict) -> torch.Tensor:
    """The ranks' tensors t concatenated along `dim` in group-rank order."""
    r = routes.setdefault("all_gather", route("all_gather", t))
    n = dist.get_world_size(group)
    src = _bytes(t)  # along the last axis too: each element's bytes stay together
    if r == "host-staged":
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    out = torch.cat(outs, dim=dim).to(t.device)
    return out if t.dtype == torch.uint8 else out.view(t.dtype)


def broadcast(t: torch.Tensor, src_rank: int, group, routes: dict) -> torch.Tensor:
    """In-place broadcast of t from global rank src_rank."""
    r = routes.setdefault("broadcast", route("broadcast", t))
    if r == "host-staged" or not t.is_contiguous():
        h = t.cpu() if r == "host-staged" else t.contiguous()
        dist.broadcast(h, src=src_rank, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src_rank, group=group)
    return t


def ring_exchange(t: torch.Tensor, send_to: int, recv_from: int, group, routes: dict) -> torch.Tensor:
    """Send t to global rank send_to and return what recv_from sent (one
    batch_isend_irecv pair)."""
    r = routes.setdefault("send/recv", route("send/recv", t))
    src = _bytes(t)
    if r == "host-staged":
        src = src.cpu()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, send_to, group), dist.P2POp(dist.irecv, buf, recv_from, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    buf = buf.to(t.device)
    return buf if t.dtype == torch.uint8 else buf.view(t.dtype)

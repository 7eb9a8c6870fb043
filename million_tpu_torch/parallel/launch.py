"""Start the ranks of a mesh as processes on one machine.

`run_ranks(fn, world, args)` spawns `world` processes (the "spawn" start
method: a parent that has CUDA up cannot fork), joins them in one process
group through a `file://` store in a fresh directory (no network port), calls
`fn(rank, *args)` in each and returns the ranks' results, in rank order.
`fn` must be importable (a module-level function of a module that the
children can import). A rank that raises makes run_ranks raise
(torch.multiprocessing's ProcessRaisedException); nothing catches it.

On a machine with N cards, `torchrun --nproc-per-node N script.py` starts
the ranks instead, and parallel.distributed.initialize() reads its
environment.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from million_tpu_torch.parallel import distributed


def _entry(rank: int, fn: Callable, world: int, store: str, device: str, args: Sequence[Any],
           out_dir: str, threads: int) -> None:
    if threads:
        torch.set_num_threads(threads)
    distributed.initialize(rank, world, f"file://{store}", device=device)
    try:
        res = fn(rank, *args)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), device: str = "cuda",
              work_dir: Optional[str] = None, threads: int = 1) -> List[Any]:
    """fn(rank, *args) on `world` spawned ranks; their results in rank
    order. The store and the results live in a fresh temporary directory
    (inside work_dir when given), removed on return. threads: torch's
    intra-op threads a rank (0 leaves torch's default)."""
    with tempfile.TemporaryDirectory(prefix="ranks_", dir=work_dir) as run:
        mp.start_processes(_entry, args=(fn, world, os.path.join(run, "store"), device, tuple(args), run,
                                         threads),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(run, f"rank{r}.pt"), weights_only=False) for r in range(world)]

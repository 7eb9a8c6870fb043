"""The multi-rank dry run: the port's twin of __graft_entry__.dryrun_multichip.

`dryrun_multichip(n)` factors n into (dcn, dp, tp, sp) as the reference does
(dcn = 2 when 8 divides n, then sp = 2, then tp takes the remaining powers of
two, dp the rest), starts n ranks (parallel/launch.py: spawned processes in
one process group) and runs, at tiny shapes on each rank's slices:
  * prefill and one decode step on the mesh (Megatron tp, the code arena
    sequence-sharded, the decode kernel per shard with the LSE merge);
  * the sequence-parallel prefill (ring attention, per-shard encode);
  * a ShardedScheduler: a chunked admission, a short one, ticks and a window
    flush over the sharded page pool, to completion.

    python -m million_tpu_torch.dryrun [n] [--device cpu]
    torchrun --nproc-per-node n -m million_tpu_torch.dryrun n   # n cards, NCCL

Spawned, the ranks share one card over gloo (or are CPU processes); under
torchrun each process is a rank on its own card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Tuple

import numpy as np


def factor(n: int) -> Tuple[int, int, int, int]:
    """(dcn, dp, tp, sp) of n ranks, the reference's factoring."""
    dcn = dp = tp = sp = 1
    if n % 8 == 0:
        dcn, n = 2, n // 2
    if n % 2 == 0:
        sp, n = 2, n // 2
    while n % 2 == 0:
        tp, n = tp * 2, n // 2
    dp = n
    return dcn, dp, tp, sp


def _rank(rank: int, n: int, device: str) -> Dict:
    import torch

    from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
    from million_tpu_torch.models.llama import PRESETS, decode_step, init_params, prefill
    from million_tpu_torch.parallel.mesh import make_mesh, shard_cache, shard_params
    from million_tpu_torch.parallel.sp_prefill import prefill_sp
    from million_tpu_torch.runtime.sampling import dp_slice
    from million_tpu_torch.runtime.scheduler import Request, ShardedScheduler

    dcn, dp, tp, sp = factor(n)
    mesh = make_mesh(dp=dp, tp=tp, sp=sp, dcn=dcn, device=device)
    dev = mesh.device
    cfg = dataclasses.replace(PRESETS["test-tiny"], num_layers=2, hidden_size=64, num_heads=4 * tp,
                              num_kv_heads=2 * tp, head_dim=32, intermediate_size=32 * tp,
                              vocab_size=512, dtype=torch.float32)
    rng = np.random.default_rng(0)
    full = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = shard_params(full, mesh)
    M, L, n_seq = cfg.head_dim // 2, cfg.num_layers, mesh.n_seq
    cents = {k: torch.from_numpy(rng.standard_normal((L, M, 64, 2)).astype(np.float32)).to(dev)
             for k in ("key", "value")}
    pqc = PQCacheConfig(bs=dp, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M, C=64, Lt=16,
                        N_max=512 * n_seq, dtype=torch.float32)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (dp, 32))).to(dev)
    cache = shard_cache(init_state(pqc, L, device="cpu"), mesh)
    logits = prefill(params, cfg, dp_slice(ids, mesh), cache, cents, mode="pq", mesh=mesh)
    if not torch.isfinite(logits).all():
        raise RuntimeError("prefill produced non-finite logits")
    tok = torch.zeros(dp, dtype=torch.long, device=dev)
    logits = decode_step(params, cfg, dp_slice(tok, mesh), 32, cache, cents, mode="pq_kernel", mesh=mesh)
    if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError("decode produced non-finite logits")

    ids_sp = torch.from_numpy(rng.integers(0, cfg.vocab_size, (dp, 16 * n_seq))).to(dev)
    cache_sp = shard_cache(init_state(pqc, L, device="cpu"), mesh)
    lsp = prefill_sp(params, cfg, dp_slice(ids_sp, mesh), cache_sp, cents, mesh)
    if not torch.isfinite(lsp).all():
        raise RuntimeError("sp prefill produced non-finite logits")

    # the paged kernel walks 256-token tiles inside a page on the card
    ps = 256 if dev.type == "cuda" else 64
    pcfg = PagedPQCacheConfig(num_layers=L, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M, C=64, Lt=8,
                              page_size=ps, n_pages=4 * n_seq, max_seqs=2, pages_per_seq=2 * n_seq,
                              dtype=torch.float32)
    sched = ShardedScheduler(params, cfg, pcfg, cents, mesh=mesh, admit_chunk=ps // 2)
    sched.submit(Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, ps + 6), max_new_tokens=12))
    sched.submit(Request(rid=1, prompt=rng.integers(0, cfg.vocab_size, 20), max_new_tokens=6))
    done = sched.run_to_completion(max_ticks=60)
    if sorted(f.rid for f in done) != [0, 1] or not all(np.isfinite(f.tokens).all() for f in done):
        raise RuntimeError(f"sharded serving finished {[f.rid for f in done]}")
    if sched.h_used.any():
        raise RuntimeError("sharded pool pages not recycled")
    # every rank must have emitted the same tokens: each holds the digests of all
    tokens = {f.rid: f.tokens.tolist() for f in done}
    digest = hashlib.sha256(json.dumps(tokens, sort_keys=True).encode()).digest()
    mine = torch.tensor(list(digest), dtype=torch.uint8, device=dev)[None]
    if not bool((mesh.all_gather(mine, "world", 0) == mine).all()):
        raise RuntimeError(f"rank {rank} emitted other tokens than another rank")
    return {"mesh": dict(mesh.shape), "routes": dict(mesh.routes), "tokens": tokens}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict:
    """Run the dry run on n ranks; returns this process's rank's summary
    (the mesh, the collectives' routes, the served tokens; rank 0's when it
    spawns them). Every rank checks that all of them served the same tokens
    (an all-gather of their digests) and raises if not. Under a launcher
    (torchrun: RANK and WORLD_SIZE set) this process is one of the ranks;
    else it spawns them."""
    import os

    if "RANK" in os.environ:
        from million_tpu_torch.parallel import distributed

        distributed.initialize(device=device)
        try:
            res = [_rank(int(os.environ["RANK"]), n_devices, device)]
        finally:
            distributed.shutdown()
        if int(os.environ["RANK"]):
            return res[0]
    else:
        from million_tpu_torch.parallel.launch import run_ranks

        res = run_ranks(_rank, n_devices, (n_devices, device), device=device)
    s = res[0]["mesh"]
    print(f"dryrun_multichip OK: mesh dcn={s['dcn']} dp={s['dp']} tp={s['tp']} sp={s['sp']} on {device}, "
          f"prefill+decode+sp_prefill+paged serving (chunked admission, sharded ticks, window "
          f"flush) executed with sharded params/cache/pool; collectives {res[0]['routes']}")
    return res[0]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="the multi-rank dry run")
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n, a.device)

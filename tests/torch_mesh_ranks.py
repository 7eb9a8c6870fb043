"""Rank bodies of the port's mesh tests (tests/test_torch_mesh*.py).

Each function runs in one spawned rank (million_tpu_torch.parallel.launch.
run_ranks): it builds the mesh, cuts its slices out of the full inputs the
test made with numpy (the million_tpu package's parameters and codebooks,
carried over by convert.py), runs one mesh path and returns numpy arrays.
This module imports no JAX and nothing of million_tpu, so that the spawned
children import neither."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from million_tpu_torch import convert
from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama as tl
from million_tpu_torch.models.chunked_prefill import chunked_prefill
from million_tpu_torch.parallel.mesh import local_slice, make_mesh, shard_cache, shard_params
from million_tpu_torch.parallel.ring_attention import ring_causal_attention
from million_tpu_torch.parallel.sharded_decode import sharded_pq_codes_attention_stacked
from million_tpu_torch.parallel.sp_prefill import prefill_sp
from million_tpu_torch.runtime.sampling import dp_slice


def model_cfg(p: Dict[str, Any]) -> tl.ModelConfig:
    return dataclasses.replace(tl.PRESETS[p.get("preset", "test-tiny")], **p.get("cfg", {}))


def _setup(p):
    mesh = make_mesh(**p["mesh"], device="cpu")
    cfg = model_cfg(p)
    params = shard_params(convert.params_from_numpy(p["params"], torch.float32, "cpu"), mesh,
                          cfg.attn_bias)
    cents = convert.cents_from_numpy(p["cents"], device="cpu")
    return mesh, cfg, params, cents


def _whole(t: torch.Tensor, mesh) -> np.ndarray:
    """The whole batch of a dp-split tensor."""
    return mesh.all_gather(t.contiguous(), "dp", 0).numpy()


def flat_rank(rank: int, p: Dict[str, Any]) -> Dict[str, Any]:
    """Prefill (route "flat", "sp" or "chunked") on the mesh, then
    teacher-forced decode steps over p["tokens"] (T, bs) with the host flush
    schedule of generate (window flushes of p["flush"] rows). Returns the
    whole batch's logits per step, the arena gathered over the mesh, and the
    collectives' routes."""
    mesh, cfg, params, cents = _setup(p)
    g = p["geom"]
    full = init_state(PQCacheConfig(bs=p["ids"].shape[0], nh_k=cfg.num_kv_heads, d=cfg.head_dim,
                                    Lt=p["Lt"], N_max=p["N_max"], dtype=torch.float32, **g),
                      cfg.num_layers, device="cpu")
    cache = shard_cache(full, mesh)
    ids = dp_slice(torch.from_numpy(p["ids"]), mesh)
    if p["route"] == "sp":
        last = prefill_sp(params, cfg, ids, cache, cents, mesh)
    elif p["route"] == "chunked":
        last, _ = chunked_prefill(params, cfg, ids, cache, cents, chunk=p["chunk"], mesh=mesh)
    else:
        last = tl.prefill(params, cfg, ids, cache, cents, mode="pq", last_logit_only=True,
                          mesh=mesh)[:, -1]
    logits = [_whole(last, mesh)]
    n = p["ids"].shape[1]
    for t, tok in enumerate(p["tokens"]):
        if cache["r"] >= p["Lt"]:
            tl.flush_windows(cache, cents, n=p["flush"], mesh=mesh)
        lg = tl.decode_step(params, cfg, dp_slice(torch.from_numpy(tok), mesh), n + t, cache, cents,
                            mode=p.get("mode", "pq_kernel"), mesh=mesh)
        logits.append(_whole(lg, mesh))
    arena = mesh.all_gather(mesh.all_gather(cache["key_codes"], "seq", 3), "tp", 2)
    return {"logits": np.stack(logits), "key_codes": _whole(arena.transpose(0, 1), mesh),
            "n_codes": cache["n_codes"], "r": cache["r"], "routes": dict(mesh.routes)}


def attention_rank(rank: int, p: Dict[str, Any]) -> Dict[str, Any]:
    """sharded_pq_codes_attention_stacked over each case (layer, n_codes,
    r) of p["cases"], the full arena of p cut into this rank's shard."""
    mesh = make_mesh(**p["mesh"], device="cpu")
    full = {k: torch.from_numpy(v) for k, v in p["arrays"].items()}
    lay = {"kc": {3: "seq"}, "vc": {3: "seq"}, "ko": {3: "seq"}, "vo": {3: "seq"}}
    loc = {k: local_slice(v, lay.get(k, {}), mesh).contiguous() for k, v in full.items()}
    okw = {}
    if "ko" in loc:
        okw = dict(k_outliers=loc["ko"].bfloat16(), v_outliers=loc["vo"].bfloat16(),
                   k_oidx=loc["koidx"], v_oidx=loc["voidx"])
    outs = []
    for layer, n_codes, r in p["cases"]:
        rkw = dict(k_residual=loc["kres"], v_residual=loc["vres"], r=r) if r else {}
        out, lse = sharded_pq_codes_attention_stacked(
            mesh, loc["q"], loc["kc"], loc["vc"], loc["kcent"], loc["vcent"], layer, n_codes,
            **okw, **rkw)
        outs.append((out.numpy(), lse.numpy()))
    return {"outs": outs, "n_seq": mesh.n_seq, "seq_index": mesh.seq_index}


def ring_rank(rank: int, p: Dict[str, Any]) -> np.ndarray:
    """This rank's block of ring_causal_attention over p's q, k, v."""
    mesh = make_mesh(**p["mesh"], device="cpu")
    axis = p.get("axis", "sp")
    P, i = mesh.size(axis), mesh.index(axis)
    blk = lambda x: torch.from_numpy(x).chunk(P, dim=2)[i].contiguous()  # noqa: E731
    return ring_causal_attention(mesh, blk(p["q"]), blk(p["k"]), blk(p["v"]), axis=axis).numpy()


def serving_rank(rank: int, p: Dict[str, Any]) -> Dict[str, Any]:
    """A ShardedScheduler over p["requests"]: p["save_after"] steps, a
    session saved and dropped, resumed on the mesh and run to completion;
    plus one teacher-forced decode tick after admission (the whole slots'
    logits). Returns the finished tokens by request id, the tick's logits,
    the mid-run tokens and the slab layout."""
    from million_tpu_torch.models.paged_decode import paged_decode_step
    from million_tpu_torch.runtime.checkpoint import load_session, save_session
    from million_tpu_torch.runtime.scheduler import Request, ShardedScheduler

    mesh, cfg, params, cents = _setup(p)
    pcfg = PagedPQCacheConfig(dtype=torch.float32, **p["pcfg"])
    sched = ShardedScheduler(params, cfg, pcfg, cents, mesh=mesh, admit_chunk=p["admit_chunk"],
                             tick_chain=p.get("tick_chain", 1))
    for rid, prompt, n_new in p["requests"]:
        sched.submit(Request(rid=rid, prompt=np.asarray(prompt), max_new_tokens=n_new))
    out: Dict[str, Any] = {"routes": None}
    if "tick_tokens" in p:  # one teacher-forced tick right after admission
        sched._try_admit()
        sched.drain()
        st = {k: v.clone() for k, v in sched.state.items()}
        lg = paged_decode_step(params, cfg, pcfg, torch.from_numpy(p["tick_tokens"]), None, st,
                               cents, mesh=mesh)
        out["tick_logits"] = lg.numpy()
    for _ in range(p["save_after"]):
        sched.step()
    sched.drain()
    out["mid"] = {i: list(g) for i, g in enumerate(sched.slot_generated)}
    path = p["path"]
    save_session(path, sched)
    del sched
    sched = load_session(path, params, cfg, pcfg, cents, mesh=mesh)
    done = sched.run_to_completion(max_ticks=500)
    out["tokens"] = {f.rid: np.asarray(f.tokens) for f in done}
    out["h_used"] = sched.h_used.copy()
    out["stats"] = sched.stats()
    out["routes"] = dict(mesh.routes)
    return out


def many(rank: int, tasks) -> list:
    """Several tasks in one spawn: [(function name, payload)] -> results."""
    return [globals()[name](rank, p) for name, p in tasks]


def resume_rank(rank: int, p: Dict[str, Any]) -> Dict[str, Any]:
    """Load a session snapshot another mesh saved (p["path"]) onto this
    rank's mesh and run it to completion: the finished tokens by request."""
    from million_tpu_torch.runtime.checkpoint import load_session

    mesh, cfg, params, cents = _setup(p)
    pcfg = PagedPQCacheConfig(dtype=torch.float32, **p["pcfg"])
    sched = load_session(p["path"], params, cfg, pcfg, cents, mesh=mesh)
    return {f.rid: np.asarray(f.tokens) for f in sched.run_to_completion(max_ticks=500)}

"""Session checkpoints: a serving scheduler's live state, or a flat cache, to
one `.npz` on disk and back.

Counterpart of million_tpu/runtime/checkpoint.py. A serving snapshot holds
everything a decode tick reads: the paged pools, residual windows, page
tables and device counters; the scheduler's host mirrors; the requests in
the slots with their tokens so far, the waiting queue (with the tokens a
preempted request had made) and the finished requests; and the sampling
generator's state. A scheduler restored from it continues every request
with the same tokens as one never interrupted: greedy and sampled alike,
since the torch.Generator's state is part of the snapshot. save_cache /
load_cache do the same for a flat generation's cache.

numpy has no bfloat16: bf16 tensors are stored as their int16 bits with a
dtype record and restored bit for bit. A snapshot is written to
`<path>.tmp` and renamed over `path` (os.replace), so a crash mid-save leaves
the previous snapshot readable. Weights, configs and codebooks are not part
of a snapshot: they are the caller's, and must match the saved run.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from million_tpu_torch import resolve_device
from million_tpu_torch.runtime.scheduler import FinishedRequest, Request, Scheduler

_META = "__session_meta__"
_STATE = "state."
_HOST = "host."
HOST_MIRRORS = ("slot_pos", "slot_pages", "slot_codes", "slot_r", "slot_sent")


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array, dtype name); bf16 as its int16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    elif str(t.dtype).replace("torch.", "") != dtype:
        raise ValueError(f"stored {t.dtype} for a {dtype} tensor")
    return t.to(device)


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _read_meta(z) -> dict:
    return json.loads(bytes(z[_META]).decode())


# --------------------------------------------------------------------------
# flat single-stream cache
# --------------------------------------------------------------------------

def save_cache(path: str, cache: Dict[str, Any], pos: int) -> None:
    """Snapshot a flat PQ (or dense) cache and the absolute position of the
    next token: its tensors (bf16 residuals as int16 bits) and its host
    counters (n_codes, r; the dense cache's length)."""
    arrays, dtypes, ints = {}, {}, {}
    for k, v in cache.items():
        if torch.is_tensor(v):
            arrays[_STATE + k], dtypes[k] = _to_numpy(v)
        else:
            ints[k] = int(v)
    arrays[_META] = _meta_array({"pos": int(pos), "dtypes": dtypes, "ints": ints})
    _atomic_savez(path, arrays)


def load_cache(path: str, device="cuda") -> Tuple[Dict[str, Any], int]:
    """Inverse of save_cache: (cache on `device`, next-token position)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = _read_meta(z)
        cache: Dict[str, Any] = {k: _to_tensor(z[_STATE + k], dt, dev) for k, dt in meta["dtypes"].items()}
    cache.update(meta["ints"])
    return cache, int(meta["pos"])


# --------------------------------------------------------------------------
# live scheduler session
# --------------------------------------------------------------------------

def _request(d: dict, prompt: np.ndarray) -> Request:
    return Request(rid=d["rid"], prompt=prompt, max_new_tokens=d["max_new_tokens"], eos_id=d["eos_id"])


def save_session(path: str, sched: Scheduler) -> None:
    """Snapshot a live Scheduler. It drains the token pipeline first, so
    every sampled token in flight is in its request's list before the
    snapshot is taken."""
    if getattr(sched, "mesh", None) is not None:
        raise NotImplementedError("mesh serving (ShardedScheduler) is a later slice of the port")
    sched.drain()
    arrays: Dict[str, np.ndarray] = {}
    dtypes = {}
    for k, v in sched.state.items():
        arrays[_STATE + k], dtypes[k] = _to_numpy(v)
    for k in HOST_MIRRORS:
        arrays[_HOST + k] = np.asarray(getattr(sched, k))
    arrays[_HOST + "last_token"] = sched.last_token.cpu().numpy()
    arrays[_HOST + "generator"] = sched.generator.get_state().numpy()

    def req(r: Request) -> dict:
        return {"rid": r.rid, "max_new_tokens": r.max_new_tokens, "eos_id": r.eos_id}

    slots = []
    for i, r in enumerate(sched.slot_req):
        slots.append(None if r is None else {**req(r), "generated": list(sched.slot_generated[i])})
        if r is not None:
            arrays[f"prompt.slot{i}"] = np.asarray(r.prompt, np.int64)
    for j, r in enumerate(sched.waiting):
        arrays[f"prompt.wait{j}"] = np.asarray(r.prompt, np.int64)
    for j, f in enumerate(sched.finished):
        arrays[f"tokens.fin{j}"] = np.asarray(f.tokens, np.int32)
    meta = {
        "dtypes": dtypes,
        "slots": slots,
        "waiting": [req(r) for r in sched.waiting],
        "finished": [{"rid": f.rid, "prompt_len": f.prompt_len} for f in sched.finished],
        "slot_order": list(sched.slot_order),
        "preempt_saved": {str(rid): list(t) for rid, t in sched._preempt_saved.items()},
        "preemptions": sched.preemptions,
        "ticks_dispatched": sched.ticks_dispatched,
        # the scheduler's policy: admission chunks change an admitted request's numerics
        "options": {"admit_chunk": sched.admit_chunk, "admit_batch": sched.admit_batch,
                    "tick_chain": sched.tick_chain, "pipeline": sched.pipeline,
                    "pipeline_depth": sched.pipeline_depth, "admit_skip_window": sched.admit_skip_window},
    }
    arrays[_META] = _meta_array(meta)
    _atomic_savez(path, arrays)


def load_session(path: str, params, cfg, pcfg, tables, sampling=None, device="cuda", mesh=None) -> Scheduler:
    """Restore a Scheduler saved by save_session on `device`. `params`, `cfg`,
    `pcfg` and `tables` are not part of the snapshot and must match the saved
    run's; a state whose keys or shapes differ from what `pcfg` builds is
    refused with ValueError. `sampling` is the run's (greedy when None)."""
    from million_tpu_torch.runtime.sampling import SamplingConfig

    if mesh is not None:
        raise NotImplementedError("mesh serving (ShardedScheduler) is a later slice of the port")
    with np.load(path) as z:
        meta = _read_meta(z)
        opts = meta["options"]
        sched = Scheduler(params, cfg, pcfg, tables, sampling if sampling is not None else SamplingConfig(),
                          admit_chunk=opts["admit_chunk"], admit_batch=opts["admit_batch"],
                          tick_chain=opts["tick_chain"], device=device)
        got, want = sorted(meta["dtypes"]), sorted(sched.state)
        if got != want:
            raise ValueError(f"snapshot state keys {got} do not match this configuration's {want}")
        for k in got:
            a = z[_STATE + k]
            if tuple(a.shape) != tuple(sched.state[k].shape):
                raise ValueError(f"snapshot state[{k}] shape {a.shape} != configured "
                                 f"{tuple(sched.state[k].shape)}: a pcfg mismatch")
            t = _to_tensor(a, meta["dtypes"][k], sched.device)
            if t.dtype != sched.state[k].dtype:
                raise ValueError(f"snapshot state[{k}] dtype {t.dtype} != configured {sched.state[k].dtype}")
            sched.state[k] = t
        for k in HOST_MIRRORS:
            setattr(sched, k, z[_HOST + k].copy())
        sched.last_token = torch.from_numpy(z[_HOST + "last_token"].copy()).to(sched.device)
        sched.generator.set_state(torch.from_numpy(z[_HOST + "generator"].copy()))
        for i, s in enumerate(meta["slots"]):
            if s is not None:
                sched.slot_req[i] = _request(s, z[f"prompt.slot{i}"].copy())
                sched.slot_generated[i] = list(s["generated"])
        sched.waiting = [_request(w, z[f"prompt.wait{j}"].copy()) for j, w in enumerate(meta["waiting"])]
        sched.finished = [FinishedRequest(rid=f["rid"], tokens=z[f"tokens.fin{j}"].copy(),
                                          prompt_len=f["prompt_len"]) for j, f in enumerate(meta["finished"])]
    sched.slot_order = [int(i) for i in meta["slot_order"]]
    sched._preempt_saved = {int(rid): list(t) for rid, t in meta["preempt_saved"].items()}
    sched.preemptions = int(meta["preemptions"])
    sched.ticks_dispatched = int(meta["ticks_dispatched"])
    sched.pipeline = bool(opts["pipeline"])
    sched.pipeline_depth = int(opts["pipeline_depth"])
    sched.admit_skip_window = int(opts["admit_skip_window"])
    return sched

"""runtime/checkpoint.py: session save and resume, the counterparts of
tests/test_checkpoint.py:51,95,118,133 on the port, on the CPU.

A snapshot taken mid-generation restores into a fresh Scheduler that emits
the same tokens as a run never interrupted: greedy, and sampled with a
seeded torch.Generator (its state is part of the snapshot); a restored
greedy session also equals million_tpu's uninterrupted f32 pipeline on the
same weights and tables, request by request. bf16 tensors survive the npz bit for bit (stored as
their int16 bits), and a crash between the temporary write and the rename
leaves the previous snapshot readable."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import llama as jl
from million_tpu.runtime.generate import generate as j_generate
from million_tpu_torch import convert
from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama as tl
from million_tpu_torch.runtime import checkpoint as ck
from million_tpu_torch.runtime.sampling import SamplingConfig
from million_tpu_torch.runtime.scheduler import Request, Scheduler

GEOM = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=32,
            intermediate_size=128, vocab_size=300)
JCFG = dataclasses.replace(jl.PRESETS["test-tiny"], dtype=jnp.float32, **GEOM)
CFG = dataclasses.replace(tl.PRESETS["test-tiny"], dtype=torch.float32, **GEOM)
M = 16
POOL = dict(num_layers=2, nh_k=2, d=32, M=M, C=64, Lt=8, page_size=128, n_pages=12, max_seqs=2, pages_per_seq=4)


@pytest.fixture(scope="module")
def models():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                                       torch.float32, device="cpu")
    rng = np.random.default_rng(8)
    cents = {"key": rng.standard_normal((2, M, 64, 2)).astype(np.float32),
             "value": rng.standard_normal((2, M, 64, 2)).astype(np.float32)}
    return jparams, params, cents


def pcfg(**kw):
    return PagedPQCacheConfig(**{**POOL, **kw}, dtype=torch.float32)


def prompts_for(rng):
    return [rng.integers(0, 300, n).astype(np.int32) for n in (14, 9, 11)]


def submit_all(s, prompts):
    # max_seqs=2: the third request waits behind the first two
    for rid, (p, n_new) in enumerate(zip(prompts, (16, 12, 10))):
        s.submit(Request(rid=rid, prompt=p, max_new_tokens=n_new))


def test_greedy_resume_across_a_flush_is_bit_identical(rng, models, tmp_path):
    """Interrupted after 8 steps (a request queued, windows past a flush),
    saved, dropped, restored: the token streams of an uninterrupted run, and
    those of million_tpu run uninterrupted."""
    jparams, params, cents = models
    tables = convert.cents_from_numpy(cents, device="cpu")
    prompts = prompts_for(rng)
    ref = Scheduler(params, CFG, pcfg(), tables, device="cpu")
    submit_all(ref, prompts)
    want = {f.rid: f.tokens for f in ref.run_to_completion(max_ticks=200)}
    sched = Scheduler(params, CFG, pcfg(), tables, device="cpu")
    submit_all(sched, prompts)
    for _ in range(8):
        sched.step()
    assert sched.waiting and any(r is not None for r in sched.slot_req)
    assert int(sched.slot_codes.max()) > 12  # a window has been flushed into the pages
    path = str(tmp_path / "session.npz")
    ck.save_session(path, sched)
    del sched
    resumed = ck.load_session(path, params, CFG, pcfg(), tables, device="cpu")
    got = {f.rid: f.tokens for f in resumed.run_to_completion(max_ticks=200)}
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"rid {rid}")
    assert int(resumed.state["used"].sum()) == 0
    # million_tpu uninterrupted, through its f32 oracle pipeline one request at a time (its
    # Scheduler runs a Pallas kernel on int8 tables and int8 q, where a near-tie may flip: see
    # tests/test_torch_scheduler.py)
    jcents = {k: jnp.asarray(v) for k, v in cents.items()}
    for rid, (p, n_new) in enumerate(zip(prompts, (16, 12, 10))):
        jcache = j_init_state(JPQCfg(bs=1, nh_k=2, d=32, M=M, C=64, Lt=8, N_max=128, dtype=jnp.float32), 2)
        res, _ = j_generate(jparams, JCFG, jnp.asarray(p[None]), jcache, jcents, mode="pq", max_new_tokens=n_new)
        np.testing.assert_array_equal(got[rid], np.asarray(res.tokens)[0], err_msg=f"rid {rid} against million_tpu")


def test_sampled_resume_restores_the_generator(rng, models, tmp_path):
    """temperature 0.8, top-k 20, seed 7: interrupted across the Lt = 8
    flush, resumed bit-identically; a fresh generator in its place would
    draw other tokens."""
    _, params, cents = models
    tables = convert.cents_from_numpy(cents, device="cpu")
    sampling = SamplingConfig(temperature=0.8, top_k=20)
    prompt = rng.integers(0, 300, 12).astype(np.int32)

    def fresh():
        s = Scheduler(params, CFG, pcfg(), tables, sampling, seed=7, device="cpu")
        s.submit(Request(rid=0, prompt=prompt, max_new_tokens=15))
        return s

    want = fresh().run_to_completion(max_ticks=100)[0].tokens
    sched = fresh()
    sched.tick_chain = 1  # one tick a step: step 9 crosses r: 0 -> 8 (the flush)
    for _ in range(9):
        sched.step()
    path = str(tmp_path / "flush.npz")
    ck.save_session(path, sched)
    resumed = ck.load_session(path, params, CFG, pcfg(), tables, sampling, device="cpu")
    assert resumed.tick_chain == 1
    np.testing.assert_array_equal(resumed.run_to_completion(max_ticks=100)[0].tokens, want)
    other = ck.load_session(path, params, CFG, pcfg(), tables, sampling, device="cpu")
    other.generator.manual_seed(8)
    assert not np.array_equal(other.run_to_completion(max_ticks=100)[0].tokens, want)


def test_shape_mismatch_rejected(rng, models, tmp_path):
    _, params, cents = models
    tables = convert.cents_from_numpy(cents, device="cpu")
    sched = Scheduler(params, CFG, pcfg(), tables, device="cpu")
    sched.submit(Request(rid=0, prompt=rng.integers(0, 300, 8), max_new_tokens=4))
    sched.step()
    path = str(tmp_path / "s.npz")
    ck.save_session(path, sched)
    with pytest.raises(ValueError, match="shape|mismatch"):
        ck.load_session(path, params, CFG, pcfg(n_pages=13), tables, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        ck.load_session(path, params, CFG, pcfg(OK=4), tables, device="cpu")
    with pytest.raises(NotImplementedError):
        ck.load_session(path, params, CFG, pcfg(), tables, device="cpu", mesh=object())


def test_flat_cache_roundtrip_bf16(rng, models, tmp_path):
    """A flat bf16 cache with exact channels: saved mid-generation, loaded,
    every tensor bit-equal (bf16 through its int16 bits) and the next decode
    step's logits identical to the uninterrupted cache's."""
    _, params, cents = models
    cfg16 = dataclasses.replace(CFG, dtype=torch.bfloat16)
    p16 = {k: (v.bfloat16() if torch.is_tensor(v) else {kk: vv.bfloat16() for kk, vv in v.items()})
           for k, v in params.items()}
    c = dict(cents)
    idx = np.sort(rng.choice(32, 4, replace=False)).astype(np.int32)
    for side in ("key", "value"):
        c[side] = c[side].copy()
        for ch in idx:
            c[side][:, ch % M, :, ch // M] = 0.0
    c["k_outlier_idx"] = c["v_outlier_idx"] = np.stack([idx] * 2)
    tables = convert.cents_from_numpy(c, device="cpu")
    cache = init_state(PQCacheConfig(bs=1, nh_k=2, d=32, M=M, C=64, Lt=8, N_max=128, OK=4, OV=4), 2,
                       device="cpu")
    ids = torch.from_numpy(rng.integers(0, 300, (1, 10)))
    logits = tl.prefill(p16, cfg16, ids, cache, tables, mode="pq", last_logit_only=True)[:, -1]
    tok = logits.argmax(-1)
    tl.decode_step(p16, cfg16, tok, 10, cache, tables, mode="pq")
    assert cache["key_residual"].dtype == torch.bfloat16 and cache["r"] == 3
    path = str(tmp_path / "cache.npz")
    ck.save_cache(path, cache, pos=11)
    back, pos = ck.load_cache(path, device="cpu")
    assert pos == 11 and sorted(back) == sorted(cache)
    for k, v in cache.items():
        if torch.is_tensor(v):
            assert back[k].dtype == v.dtype and torch.equal(back[k].view(torch.uint8), v.view(torch.uint8)), k
        else:
            assert back[k] == v
    la = tl.decode_step(p16, cfg16, tok, pos, cache, tables, mode="pq")
    lb = tl.decode_step(p16, cfg16, tok, pos, back, tables, mode="pq")
    assert torch.equal(la, lb)


def test_crash_between_write_and_rename_keeps_the_old_snapshot(rng, models, tmp_path, monkeypatch):
    _, params, cents = models
    tables = convert.cents_from_numpy(cents, device="cpu")
    sched = Scheduler(params, CFG, pcfg(), tables, device="cpu")
    sched.submit(Request(rid=0, prompt=rng.integers(0, 300, 10), max_new_tokens=20))
    sched.step()
    path = str(tmp_path / "s.npz")
    ck.save_session(path, sched)
    first = {k: v.copy() for k, v in np.load(path).items()}
    for _ in range(3):
        sched.step()

    def crash(src, dst):
        raise OSError("killed between the write and the rename")

    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(OSError):
        ck.save_session(path, sched)
    monkeypatch.undo()
    assert os.path.exists(path + ".tmp")
    again = np.load(path)
    assert sorted(again) == sorted(first) and all(np.array_equal(again[k], first[k]) for k in first)
    restored = ck.load_session(path, params, CFG, pcfg(), tables, device="cpu")
    meta = json.loads(bytes(first["__session_meta__"]).decode())
    assert restored.slot_generated[0] == meta["slots"][0]["generated"]  # the first snapshot's tokens

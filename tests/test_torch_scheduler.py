"""The port's continuous-batching scheduler on the CPU (f32, the tiny model of
tests/test_scheduler.py, 128-token pages, Lt=8).

The host policy cases of tests/test_scheduler.py run on the port alone (no
XLA compile, so they are cheap). Token parity:
  * against the port's flat pipeline generate(mode="pq_kernel") with
    full-window flushes: equal greedy tokens. Both are f32, encode the same
    windows at the same steps and attend over the same codes and residual
    rows; only the summation order of the attention splits differs, far
    below the logit gaps of these prompts;
  * against million_tpu's Scheduler on the same requests: agreement >= 0.85,
    the bar tests/test_scheduler.py:75-76 sets between million_tpu's own two
    paths (its kernels compute with int8 tables, so a near-tie may flip).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache.paged_pq_cache import PagedPQCacheConfig as JPagedCfg
from million_tpu.models import llama as jl
from million_tpu.runtime.scheduler import Request as JRequest, Scheduler as JScheduler
from million_tpu_torch import convert
from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama as tl
from million_tpu_torch.runtime.generate import generate
from million_tpu_torch.runtime.sampling import SamplingConfig
from million_tpu_torch.runtime.scheduler import Request, Scheduler

GEOM = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=32,
            intermediate_size=128, vocab_size=300)
JCFG = dataclasses.replace(jl.PRESETS["test-tiny"], dtype=jnp.float32, **GEOM)
CFG = dataclasses.replace(tl.PRESETS["test-tiny"], dtype=torch.float32, **GEOM)
M = 16


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return convert.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                                     torch.float32, device="cpu")


def make_cents(rng, O=0, M_v=M, C_v=64):
    c = {"key": rng.standard_normal((2, M, 64, 32 // M)).astype(np.float32),
         "value": rng.standard_normal((2, M_v, C_v, 32 // M_v)).astype(np.float32)}
    if O:
        for side, name, m in (("key", "k_outlier_idx", M), ("value", "v_outlier_idx", M_v)):
            idx = np.sort(rng.choice(32, O, replace=False)).astype(np.int32)
            c[name] = np.stack([idx] * 2)
            for ch in idx:
                c[side][:, ch % m, :, ch // m] = 0.0
    return c


def pool(**kw):
    base = dict(num_layers=2, nh_k=2, d=32, M=M, C=64, Lt=8, page_size=128, n_pages=8, max_seqs=2,
                pages_per_seq=4, dtype=torch.float32)
    base.update(kw)
    return PagedPQCacheConfig(**base)


def build(rng, params, **kw):
    c = make_cents(rng)
    return convert.cents_from_numpy(c, device="cpu"), pool(**kw)


def sched_for(params, tables, pcfg, **kw):
    return Scheduler(params, CFG, pcfg, tables, device="cpu", **kw)


def prompt(rng, n):
    return rng.integers(0, 300, n)


def flat_tokens(params, tables, p, n_new, **geom):
    """The port's flat pipeline on one request, full-window flushes."""
    cfg = PQCacheConfig(bs=1, nh_k=2, d=32, M=M, C=64, Lt=8, N_max=512, dtype=torch.float32, **geom)
    res, _ = generate(params, CFG, torch.from_numpy(np.asarray(p)[None]), init_state(cfg, 2, device="cpu"),
                      tables, mode="pq_kernel", max_new_tokens=n_new, device="cpu")
    return res.tokens[0]


def test_scheduler_completes_queued_requests(rng, params):
    tables, pcfg = build(rng, params)
    sched = sched_for(params, tables, pcfg)
    for i, n in enumerate((12, 20, 9, 15)):
        sched.submit(Request(rid=i, prompt=prompt(rng, n), max_new_tokens=12))
    done = sched.run_to_completion(max_ticks=200)
    assert sorted(f.rid for f in done) == [0, 1, 2, 3]
    for f in done:
        assert len(f.tokens) == 12 and ((0 <= f.tokens) & (f.tokens < 300)).all()
    assert int(sched.state["used"].sum()) == 0  # all pages recycled
    assert (sched.state["page_table"] == -1).all()


@pytest.mark.parametrize("n_prompt,n_new", [(16, 14), (45, 30), (128, 20)])
def test_scheduler_matches_flat_pipeline(rng, params, n_prompt, n_new):
    tables, pcfg = build(rng, params)
    p = prompt(rng, n_prompt)
    sched = sched_for(params, tables, pcfg)
    sched.submit(Request(rid=0, prompt=p, max_new_tokens=n_new))
    got = sched.run_to_completion(max_ticks=100)[0].tokens
    np.testing.assert_array_equal(got, flat_tokens(params, tables, p, n_new))


def test_scheduler_matches_million_tpu_scheduler(rng, params, jparams):
    """Two requests through both packages' schedulers; the second is admitted
    while the first decodes. Agreement >= 0.85 per request."""
    c = make_cents(rng)
    tables = convert.cents_from_numpy(c, device="cpu")
    jt = jl.build_tables({k: jnp.asarray(v) for k, v in c.items()})
    prompts = [prompt(rng, 16), prompt(rng, 24)]
    jpcfg = JPagedCfg(num_layers=2, nh_k=2, d=32, M=M, C=64, Lt=8, page_size=128, n_pages=8, max_seqs=2,
                      pages_per_seq=4, dtype=jnp.float32)
    js = JScheduler(jparams, JCFG, jpcfg, jt)
    ts = sched_for(params, tables, pool())
    for rid, p in enumerate(prompts):
        js.submit(JRequest(rid=rid, prompt=p.astype(np.int32), max_new_tokens=14))
        ts.submit(Request(rid=rid, prompt=p, max_new_tokens=14))
    want = {f.rid: f.tokens for f in js.run_to_completion(max_ticks=60)}
    got = {f.rid: f.tokens for f in ts.run_to_completion(max_ticks=60)}
    assert set(got) == set(want) == {0, 1}
    for rid in got:
        agree = (got[rid] == want[rid]).mean()
        assert agree >= 0.85, f"rid {rid}: agreement {agree}: {got[rid]} vs {want[rid]}"
    assert int(ts.state["used"].sum()) == int(np.asarray(js.state["used"]).sum()) == 0


def test_scheduler_interleaves_different_lengths(rng, params):
    tables, pcfg = build(rng, params, n_pages=12, max_seqs=3)
    sched = sched_for(params, tables, pcfg)
    sched.submit(Request(rid=0, prompt=prompt(rng, 30), max_new_tokens=20))
    sched.step()  # admits rid 0 and decodes
    sched.submit(Request(rid=1, prompt=prompt(rng, 5), max_new_tokens=6))
    done = sched.run_to_completion(max_ticks=100)
    assert {f.rid: len(f.tokens) for f in done} == {0: 20, 1: 6}


def test_scheduler_asymmetric_geometry(rng, params):
    """K: d_m=2, C=256; V: d_m=4, C=128 pools. The flat pipeline with the
    same geometry must give the same greedy tokens."""
    c = make_cents(rng, M_v=8, C_v=128)
    c["key"] = rng.standard_normal((2, M, 256, 2)).astype(np.float32)
    tables = convert.cents_from_numpy(c, device="cpu")
    sched = sched_for(params, tables, pool(M_v=8, C=256))
    assert sched.state["value_pool"].shape[-1] == 8
    p = prompt(rng, 12)
    sched.submit(Request(rid=0, prompt=p, max_new_tokens=10))
    got = sched.run_to_completion(max_ticks=100)[0].tokens
    cfg = PQCacheConfig(bs=1, nh_k=2, d=32, M=M, M_v=8, C=256, Lt=8, N_max=256, dtype=torch.float32)
    res, _ = generate(params, CFG, torch.from_numpy(p[None]), init_state(cfg, 2, device="cpu"), tables,
                      mode="pq_kernel", max_new_tokens=10, device="cpu")
    np.testing.assert_array_equal(got, res.tokens[0])


def test_scheduler_stats_observability(rng, params):
    tables, pcfg = build(rng, params)
    sched = sched_for(params, tables, pcfg)
    s0 = sched.stats()
    assert s0["pages_used"] == 0 and s0["active_seqs"] == 0
    assert s0["in_flight"] == 0 and s0["waiting_requests"] == 0
    sched.submit(Request(rid=0, prompt=prompt(rng, 20), max_new_tokens=8))
    sched.step()
    s1 = sched.stats()
    assert s1["active_seqs"] == 1 and s1["in_flight"] == 1 and s1["pages_used"] > 0
    slot = next(p for p in s1["per_seq"] if p["active"])
    assert slot["n_codes"] == 20 and slot["n_pages"] == s1["pages_used"]
    assert abs(s1["compression_x"] - 8.0) < 1e-9  # f32 dense KV 256 B against 32 code bytes
    assert s1["live_code_bytes"] == 20 * 2 * 2 * (16 + 16)
    sched.run_to_completion(max_ticks=50)
    s2 = sched.stats()
    assert s2["pages_used"] == 0 and s2["in_flight"] == 0 and s2["finished_requests"] == 1
    # a table the device exhausted behind the host's accounting is data loss: fail loud
    sched.state["seq_active"][0], sched.state["seq_n_pages"][0] = 1, 1
    with pytest.raises(RuntimeError, match="page-table corruption"):
        sched.stats()


def test_scheduler_on_demand_paging_beats_worst_case(rng, params):
    """Worst-case demand (3 pages) exceeds the pool (2); actual use fits."""
    tables, pcfg = build(rng, params, n_pages=2, max_seqs=1)
    sched = sched_for(params, tables, pcfg)
    sched.submit(Request(rid=0, prompt=prompt(rng, 128), max_new_tokens=128))
    done = sched.run_to_completion(max_ticks=200)
    assert len(done) == 1 and len(done[0].tokens) == 128
    assert sched.preemptions == 0 and int(sched.state["used"].sum()) == 0


def run_two_long(params, n_pages=3, watch=None):
    """Two 100-token requests of 60 new tokens each: three pages cannot hold
    both as they grow."""
    tables, pcfg = build(np.random.default_rng(5), params, n_pages=n_pages, pages_per_seq=3)
    sched = sched_for(params, tables, pcfg)
    for rid in (0, 1):
        sched.submit(Request(rid=rid, prompt=prompt(np.random.default_rng(100 + rid), 100),
                             max_new_tokens=60))
    while sched.waiting or any(r is not None for r in sched.slot_req):
        sched.step()
        if watch is not None:
            watch(sched)
    sched.drain()
    return sched


def test_scheduler_preemption_and_resume(params):
    sched = run_two_long(params)
    assert sorted(f.rid for f in sched.finished) == [0, 1]
    assert all(len(f.tokens) == 60 for f in sched.finished)
    assert sched.preemptions >= 1 and int(sched.state["used"].sum()) == 0
    assert sched.stats()["page_table_errors"] == 0


def test_scheduler_preemption_preserves_tokens(params):
    seen = {}

    def watch(sched):
        if sched.preemptions and not seen:
            seen.update({rid: list(t) for rid, t in sched._preempt_saved.items()})

    sched = run_two_long(params, watch=watch)
    assert seen, "expected a preemption in this configuration"
    for f in sched.finished:
        if f.rid in seen:
            assert list(f.tokens[: len(seen[f.rid])]) == seen[f.rid]


def test_preemption_leaves_the_older_request_undisturbed(params):
    """The youngest slot pays for a dry pool: the older request's tokens are
    those of a run in a pool large enough for both."""
    tight, calm = run_two_long(params), run_two_long(params, n_pages=6)
    assert tight.preemptions >= 1 and calm.preemptions == 0
    got = {f.rid: f.tokens for f in tight.finished}
    want = {f.rid: f.tokens for f in calm.finished}
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == 60


def test_scheduler_skip_ahead_admission(rng, params):
    tables, pcfg = build(rng, params, n_pages=4)
    sched = sched_for(params, tables, pcfg)
    sched.submit(Request(rid=0, prompt=prompt(rng, 200), max_new_tokens=40))  # takes 2 pages
    sched.step()
    sched.submit(Request(rid=1, prompt=prompt(rng, 400), max_new_tokens=4))  # needs 4: blocked
    sched.submit(Request(rid=2, prompt=prompt(rng, 20), max_new_tokens=4))  # fits now
    sched.step()
    active = {r.rid for r in sched.slot_req if r is not None}
    assert 2 in active and 1 not in active  # skipped ahead
    done = sched.run_to_completion(max_ticks=300)
    assert sorted(f.rid for f in done) == [0, 1, 2]


@pytest.mark.parametrize("O", [0, 4])
def test_scheduler_long_prompt_chunked_admission(rng, params, O):
    """A prompt longer than admit_chunk goes through the chunked admission
    and matches the flat pipeline with the same chunking, with and without
    outlier pools (admission writes, flush writes and the outlier terms of
    history and decode all take part)."""
    tables = convert.cents_from_numpy(make_cents(rng, O=O), device="cpu")
    p = prompt(rng, 180)
    sched = sched_for(params, tables, pool(OK=O, OV=O), admit_chunk=64)
    sched.submit(Request(rid=0, prompt=p, max_new_tokens=10))
    got = sched.run_to_completion(max_ticks=50)[0].tokens
    cfg = PQCacheConfig(bs=1, nh_k=2, d=32, M=M, C=64, Lt=8, N_max=256, dtype=torch.float32, OK=O, OV=O)
    res, _ = generate(params, CFG, torch.from_numpy(p[None]), init_state(cfg, 2, device="cpu"), tables,
                      mode="pq_kernel", max_new_tokens=10, prefill_chunk=64, device="cpu")
    np.testing.assert_array_equal(got, res.tokens[0])
    assert int(sched.state["used"].sum()) == 0


def test_scheduler_rejects_what_it_cannot_serve(rng, params):
    tables, pcfg = build(rng, params)
    sched = sched_for(params, tables, pcfg)
    with pytest.raises(ValueError, match="capacity"):
        sched.submit(Request(rid=0, prompt=prompt(rng, 4 * 128 + 1), max_new_tokens=1))
    with pytest.raises(ValueError, match="admit_chunk"):
        sched_for(params, tables, pool(page_size=512), admit_chunk=128)
    with pytest.raises(NotImplementedError):
        Scheduler(params, CFG, pcfg, tables, mesh=object(), device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            Scheduler(params, CFG, pcfg, tables)
    tiny = sched_for(params, tables, pool(n_pages=1, max_seqs=1))
    tiny.submit(Request(rid=0, prompt=prompt(rng, 200), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="stalled"):
        tiny.run_to_completion(max_ticks=5)


def test_scheduler_outlier_geometry_matches_flat(rng, params):
    """OK = OV = 4 exact channels through one-shot admission, flushes and the
    decode ticks: the flat pipeline with the same tables, same tokens."""
    tables = convert.cents_from_numpy(make_cents(rng, O=4), device="cpu")
    p = prompt(rng, 16)
    sched = sched_for(params, tables, pool(OK=4, OV=4))
    assert sched.state["key_outlier_pool"].shape == (2, 9, 2, 128, 4)
    sched.submit(Request(rid=0, prompt=p, max_new_tokens=14))
    got = sched.run_to_completion(max_ticks=50)[0].tokens
    np.testing.assert_array_equal(got, flat_tokens(params, tables, p, 14, OK=4, OV=4))


def test_pipeline_drain_after_partial_stepping(rng, params):
    tables, pcfg = build(rng, params)
    sched = sched_for(params, tables, pcfg, tick_chain=1)
    sched.submit(Request(rid=0, prompt=prompt(rng, 12), max_new_tokens=50))
    for _ in range(5):
        sched.step()
    assert len(sched.slot_generated[0]) < 6  # two ticks are still in flight
    sched.drain()
    assert len(sched.slot_generated[0]) == 6  # admission samples 1 token, each tick one more
    assert sched.ticks_dispatched == 5


@pytest.mark.parametrize("pipeline", [True, False])
def test_tick_chain_matches_single_tick(rng, params, pipeline):
    """Chaining is a pure dispatch-batching change: the same tokens as
    tick_chain=1, across flushes and mixed slot lengths, pipelined or not."""
    tables, pcfg = build(rng, params, n_pages=12, max_seqs=3)

    def run(chain):
        sched = sched_for(params, tables, pcfg, tick_chain=chain)
        sched.pipeline = pipeline
        for rid, n in enumerate((12, 20, 9)):
            sched.submit(Request(rid=rid, prompt=prompt(np.random.default_rng(rid), n), max_new_tokens=25))
        return {f.rid: f.tokens for f in sched.run_to_completion(max_ticks=300)}

    got, want = run(8), run(1)
    assert set(got) == set(want) == {0, 1, 2}
    for rid in got:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_tick_chain_is_clamped_by_window_and_budget(rng, params):
    tables, pcfg = build(rng, params)
    sched = sched_for(params, tables, pcfg, tick_chain=8)
    sched.submit(Request(rid=0, prompt=prompt(rng, 13), max_new_tokens=30))  # r = 1 after admission
    assert sched.step() == 7 and sched.slot_r[0] == 8  # Lt - r, not 8: the window fills exactly
    assert sched.step() == 8  # flushed first, then a whole chain
    assert sched.slot_codes[0] == 20 and sched.slot_r[0] == 8
    sched.step()
    sched.step()  # 1 + 7 + 8 + 8 + min(8, budget left = 6)
    assert sched.slot_sent[0] == 30


def test_tick_chain_eos_mid_chain(rng, params):
    tables, pcfg = build(rng, params)
    p = prompt(rng, 12)
    ref = sched_for(params, tables, pcfg, tick_chain=1)
    ref.submit(Request(rid=0, prompt=p, max_new_tokens=20))
    base = ref.run_to_completion(max_ticks=100)[0].tokens
    eos = int(base[4])
    first = next(i for i in range(1, len(base)) if base[i] == eos)  # admission's token is not EOS-checked
    sched = sched_for(params, tables, pcfg, tick_chain=8)
    sched.submit(Request(rid=0, prompt=p, max_new_tokens=20, eos_id=eos))
    got = list(sched.run_to_completion(max_ticks=100)[0].tokens)
    assert got == list(base[: first + 1]) and got[-1] == eos  # nothing after EOS survives
    assert sched.slot_req[0] is None and int(sched.state["used"].sum()) == 0


def test_scheduler_group_admission(rng, params):
    """Two equal-bucket long prompts waiting together admit through ONE
    batched chunked pass; the tokens are those of slot-by-slot admission."""
    tables, pcfg = build(rng, params, n_pages=12, max_seqs=3)
    calls = []

    def run(batch):
        sched = sched_for(params, tables, pcfg, admit_chunk=128, admit_batch=8 if batch else 1)
        real = sched._admit_group
        sched._admit_group = lambda reqs, slots: (calls.append(len(reqs)), real(reqs, slots))[1]
        for rid, n in enumerate((300, 280)):  # one 3-chunk bucket
            sched.submit(Request(rid=rid, prompt=prompt(np.random.default_rng(rid), n), max_new_tokens=8))
        return {f.rid: f.tokens for f in sched.run_to_completion(max_ticks=60)}

    got, want = run(True), run(False)
    assert calls == [2]
    assert set(got) == set(want) == {0, 1}
    for rid in got:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_sampling_draws_from_the_schedulers_generator(rng, params):
    """Temperature sampling runs on the scheduler's own torch.Generator: the
    same seed gives the same tokens, another seed other tokens."""
    tables, pcfg = build(rng, params)
    p = prompt(rng, 12)

    def run(seed):
        sched = sched_for(params, tables, pcfg, sampling=SamplingConfig(temperature=1.0, top_k=50), seed=seed)
        sched.submit(Request(rid=0, prompt=p, max_new_tokens=16))
        return sched.run_to_completion(max_ticks=50)[0].tokens

    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()

"""OPQ rotations in the port's flat, chunked and paged paths against
million_tpu on the CPU (f32 test-tiny and the tiny model of
tests/test_scheduler.py), with random orthogonal Rk / Rv per layer (QR of a
seeded normal), the setup of tests/test_model.py:262.

Tolerances:
  * flat prefill (exact and distorted) and decode across sub-window flushes,
    the port's "pq_kernel" (the kernel's plain version on the CPU) against
    million_tpu's "pq" oracle: logits atol 1e-4, codes equal;
  * chunked prefill against million_tpu's chunked_prefill(use_kernel=False):
    last logits atol 1e-4, codes equal; one chunk against the port's own flat
    OPQ prefill: codes equal, logits 1e-4;
  * paged admission, both sides on their plain routes: logits 1e-4; a paged
    step against million_tpu's flat "pq" oracle on the same sequence: 1e-4;
    against million_tpu's paged step (its Pallas kernel in interpret mode,
    int8 q and tables), with the port given the codebook those tables hold:
    no further than million_tpu's own oracle is (+1e-4; see the test); the
    scheduler's greedy tokens equal the port's flat OPQ generate;
  * the OPQ rung of the quality ladder, trained by both packages on the same
    samples with the same seeds: Δppl within max(0.01, 25 %) of million_tpu's,
    the rung margin of PERF.md section 2 (the two draw different k-means++
    inits, so the tables differ).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache import paged_pq_cache as jpc
from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import chunked_prefill as jcp
from million_tpu.models import llama as jl
from million_tpu.models import paged_decode as jpd
from million_tpu.ops.pq_attention_pallas import dequantize_table
from million_tpu_torch import convert
from million_tpu_torch.cache import paged_pq_cache as tpc
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import chunked_prefill as tcp
from million_tpu_torch.models import llama as tl
from million_tpu_torch.models import paged_decode as tpd
from million_tpu_torch.runtime.generate import generate
from million_tpu_torch.runtime.sampling import SamplingConfig
from million_tpu_torch.runtime.scheduler import Request, Scheduler

JCFG = jl.PRESETS["test-tiny"]
TCFG = tl.PRESETS["test-tiny"]
L, D, NH_K = JCFG.num_layers, JCFG.head_dim, JCFG.num_kv_heads
BS, LT, N_MAX = 2, 8, 128


def rotations(seed, layers=L, d=D):
    g = np.random.default_rng(seed).standard_normal((layers, d, d))
    return np.linalg.qr(g)[0].astype(np.float32)


def jax_params(cfg):
    jp = jl.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, convert.params_from_numpy(tree, torch.float32, device="cpu")


@pytest.fixture(scope="module")
def params():
    return jax_params(JCFG)


def make_cents(rng, geom, layers=L, d=D, C=None):
    """geom "dm2": M=d/2, C=32. "outlier": M=d/4, C=64 with 4 + 4 exact
    channels whose centroid components are 0. Both with rotations."""
    M, C0, dm, O = (d // 2, 32, 2, 0) if geom == "dm2" else (d // 4, 64, 4, 4)
    C = C or C0
    c = {"key": rng.standard_normal((layers, M, C, dm)).astype(np.float32),
         "value": rng.standard_normal((layers, M, C, dm)).astype(np.float32),
         "Rk": rotations(int(rng.integers(1 << 30)), layers, d),
         "Rv": rotations(int(rng.integers(1 << 30)), layers, d)}
    if O:
        for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")):
            idx = np.stack([np.sort(rng.choice(d, O, replace=False)) for _ in range(layers)])
            c[name] = idx.astype(np.int32)
            for li in range(layers):
                for ch in idx[li]:
                    c[side][li, ch % M, :, ch // M] = 0.0
    return c, dict(M=M, C=C, OK=O, OV=O)


def caches(geom_kw):
    j = j_init_state(JPQCfg(bs=BS, nh_k=NH_K, d=D, Lt=LT, N_max=N_MAX, dtype=jnp.float32, **geom_kw), L)
    t = init_state(PQCacheConfig(bs=BS, nh_k=NH_K, d=D, Lt=LT, N_max=N_MAX, dtype=torch.float32, **geom_kw),
                   L, device="cpu")
    return j, t


def assert_caches_equal(jc, tc):
    conv = convert.pq_cache_from_numpy({k: np.asarray(v) for k, v in jc.items()}, device="cpu")
    assert (conv["n_codes"], conv["r"]) == (tc["n_codes"], tc["r"])
    for k in ("key_codes", "value_codes", "key_outliers", "value_outliers"):
        if k in tc:
            np.testing.assert_array_equal(conv[k].float().numpy(), tc[k].float().numpy(), err_msg=k)
    r = tc["r"]
    for k in ("key_residual", "value_residual"):
        np.testing.assert_allclose(conv[k][:, :, :, :r].numpy(), tc[k][:, :, :, :r].numpy(), atol=1e-5)


def test_cents_from_numpy_carries_rotations(rng):
    c, _ = make_cents(rng, "dm2")
    t = convert.cents_from_numpy(c, device="cpu")
    for k in ("Rk", "Rv"):
        assert t[k].dtype == torch.float32 and tuple(t[k].shape) == (L, D, D)
        np.testing.assert_array_equal(t[k].numpy(), c[k])
    with pytest.raises(ValueError, match="both"):
        convert.cents_from_numpy({k: v for k, v in c.items() if k != "Rv"}, device="cpu")


@pytest.mark.parametrize("distort", [False, True])
@pytest.mark.parametrize("geom", ["dm2", "outlier"])
def test_flat_prefill_matches_jax(rng, params, geom, distort):
    """Rotated codes and residual tail; exact attention in the original space,
    or with distort_recent the rotated reconstruction unrotated by R^T."""
    jp, tp = params
    c, gkw = make_cents(rng, geom)
    ids = rng.integers(0, JCFG.vocab_size, (BS, 13))
    jc, tc = caches(gkw)
    lj, jc = jl.prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, {k: jnp.asarray(v) for k, v in c.items()},
                        mode="pq", distort_recent=distort)
    lt = tl.prefill(tp, TCFG, torch.from_numpy(ids), tc, convert.cents_from_numpy(c, device="cpu"),
                    mode="pq", distort_recent=distort)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    assert_caches_equal(jc, tc)


@pytest.mark.parametrize("geom", ["dm2", "outlier"])
def test_flat_decode_across_flush_matches_jax(rng, params, geom):
    """Prefill 17 tokens, 12 decode steps with F=4 flushes of the rotated
    window: port "pq_kernel" against JAX "pq" per step, caches equal."""
    jp, tp = params
    c, gkw = make_cents(rng, geom)
    jcents, tcents = {k: jnp.asarray(v) for k, v in c.items()}, convert.cents_from_numpy(c, device="cpu")
    jc, tc = caches(gkw)
    ids = rng.integers(0, JCFG.vocab_size, (BS, 17))
    _, jc = jl.prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, mode="pq")
    tl.prefill(tp, TCFG, torch.from_numpy(ids), tc, tcents, mode="pq")
    flushes = 0
    for t, tok in enumerate(rng.integers(0, JCFG.vocab_size, (12, BS))):
        if tc["r"] >= LT:
            jc = jl.flush_windows(jc, jcents, n=4)
            tl.flush_windows(tc, tcents, n=4)
            flushes += 1
        lj, jc = jl.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32), jnp.asarray(17 + t, jnp.int32),
                                jc, jcents, mode="pq")
        lt = tl.decode_step(tp, TCFG, torch.from_numpy(tok), 17 + t, tc, tcents, mode="pq_kernel")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, err_msg=f"step {t}")
    assert flushes >= 2
    assert_caches_equal(jc, tc)


def test_rotations_cancel_while_history_is_exact(rng, params):
    """With every token still in the exact residual window, the rotated cache
    gives the unrotated run's logits (orthogonal invariance)."""
    _, tp = params
    c, gkw = make_cents(rng, "dm2")
    plain = {k: v for k, v in c.items() if k not in ("Rk", "Rv")}
    ids = torch.from_numpy(rng.integers(0, TCFG.vocab_size, (BS, 3)))
    out = []
    for cents in (c, plain):
        tc = caches(gkw)[1]
        t = convert.cents_from_numpy(cents, device="cpu")
        tl.prefill(tp, TCFG, ids, tc, t, mode="pq")
        out.append(tl.decode_step(tp, TCFG, torch.tensor([5, 9]), 3, tc, t, mode="pq_kernel"))
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), atol=1e-5)


def test_chunked_prefill_matches_jax_and_flat(rng, params):
    jp, tp = params
    c, gkw = make_cents(rng, "dm2")
    jcents, tcents = {k: jnp.asarray(v) for k, v in c.items()}, convert.cents_from_numpy(c, device="cpu")
    ids = rng.integers(0, JCFG.vocab_size, (BS, 50))
    jc, tc = caches(gkw)
    lj, jc = jcp.chunked_prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, chunk=16, hist_block=16,
                                 use_kernel=False)
    lt, _ = tcp.chunked_prefill(tp, TCFG, torch.from_numpy(ids), tc, tcents, chunk=16, hist_block=16)
    assert (tc["n_codes"], tc["r"]) == (48, 2)
    assert_caches_equal(jc, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    # the plain versions of both partials give the wrapper route's logits
    lp, _ = tcp.chunked_prefill(tp, TCFG, torch.from_numpy(ids), caches(gkw)[1], tcents, chunk=16,
                                hist_block=16, use_kernel=False)
    np.testing.assert_allclose(lp.numpy(), lt.numpy(), atol=1e-5)
    # one chunk: the port's flat OPQ prefill (tests/test_chunked_prefill.py:130)
    l1, c1 = tcp.chunked_prefill(tp, TCFG, torch.from_numpy(ids), caches(gkw)[1], tcents, chunk=128)
    cf = caches(gkw)[1]
    lf = tl.prefill(tp, TCFG, torch.from_numpy(ids), cf, tcents, mode="pq", last_logit_only=True)
    for k in ("key_codes", "value_codes"):
        assert torch.equal(c1[k], cf[k]), k
    np.testing.assert_allclose(c1["key_residual"].numpy(), cf["key_residual"].numpy(), atol=1e-5)
    np.testing.assert_allclose(l1.numpy(), lf[:, -1].numpy(), atol=1e-4)


# --- the paged path, on the tiny model of tests/test_scheduler.py -------------------------------

PGEOM = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=32,
             intermediate_size=128, vocab_size=300)
PJCFG = dataclasses.replace(JCFG, dtype=jnp.float32, **PGEOM)
PTCFG = dataclasses.replace(TCFG, dtype=torch.float32, **PGEOM)
PD, PM, PC, PS = 32, 16, 64, 128
POOL = dict(num_layers=2, nh_k=2, d=PD, M=PM, C=PC, Lt=LT, page_size=PS, n_pages=8, max_seqs=2,
            pages_per_seq=4)


@pytest.fixture(scope="module")
def pparams():
    return jax_params(PJCFG)


@pytest.fixture(scope="module")
def paged_admission(pparams):
    """One chunked admission (275 tokens, 3 chunks of 128) with OPQ tables in
    both packages, each on its plain route."""
    jp, tp = pparams
    rng = np.random.default_rng(17)
    c, _ = make_cents(rng, "dm2", layers=2, d=PD, C=PC)
    jt = jl.build_tables({k: jnp.asarray(v) for k, v in c.items()})
    tt = convert.cents_from_numpy(c, device="cpu")
    jcfg = jpc.PagedPQCacheConfig(dtype=jnp.float32, **POOL)
    tcfg = tpc.PagedPQCacheConfig(dtype=torch.float32, **POOL)
    prompt = rng.integers(0, 300, 275)
    jst = jpc.allocate_pages(jpc.init_paged_state(jcfg), jnp.asarray(0), 3)
    tst = tpc.init_paged_state(tcfg, device="cpu")
    tpc.allocate_pages(tst, 0, 3)
    lj, jst = jpd.paged_admit_chunked(jp, PJCFG, jcfg, 0, prompt.astype(np.int32), jst, jt, chunk=128,
                                      use_kernel=False)
    lt, _ = tpd.paged_admit_chunked(tp, PTCFG, tcfg, 0, prompt, tst, tt, chunk=128, hist_block=64,
                                    use_kernel=False)
    return dict(c=c, jt=jt, tt=tt, jcfg=jcfg, tcfg=tcfg, jst=jst, tst=tst, lj=np.asarray(lj), lt=lt.numpy(),
                prompt=prompt)


def slot_tokens(st, pool, slot, n):
    table = st["page_table"][slot].tolist()
    t = np.arange(n)
    pages = np.asarray([table[i] for i in t // PS])
    return st[pool][:, pages, :, t % PS].permute(1, 2, 0, 3).float().numpy()


def test_paged_admission_matches_jax(pparams, paged_admission):
    a = paged_admission
    tst = a["tst"]
    assert (int(tst["seq_n_codes"][0]), int(tst["seq_r"][0])) == (272, 3)
    np.testing.assert_allclose(a["lt"], a["lj"], atol=1e-4)
    conv = convert.paged_state_from_numpy({k: np.asarray(v) for k, v in a["jst"].items()}, a["tcfg"],
                                          device="cpu")
    for pool in ("key_pool", "value_pool"):
        x, y = slot_tokens(conv, pool, 0, 272), slot_tokens(tst, pool, 0, 272)
        np.testing.assert_array_equal(x[0], y[0], err_msg=pool)  # layer 0 sees no attention
        assert (x == y).mean() >= 0.999, pool
    for k in ("key_residual", "value_residual"):  # the rotated ragged tail
        np.testing.assert_allclose(conv[k][:, 0, :, :3].numpy(), tst[k][:, 0, :, :3].numpy(), atol=1e-5)
    # the wrapper route (plain versions on the CPU) gives the same
    tst2 = tpc.init_paged_state(a["tcfg"], device="cpu")
    tpc.allocate_pages(tst2, 0, 3)
    l2, _ = tpd.paged_admit_chunked(pparams[1], PTCFG, a["tcfg"], 0, a["prompt"], tst2, a["tt"], chunk=128)
    np.testing.assert_allclose(l2.numpy(), a["lt"], atol=1e-5)


def test_paged_prefill_seq_matches_jax(rng, pparams, paged_admission):
    jp, tp = pparams
    a = paged_admission
    ids = rng.integers(0, 300, (1, 45))
    jst = jpc.allocate_pages(jpc.init_paged_state(a["jcfg"]), jnp.asarray(1), 1)
    tst = tpc.init_paged_state(a["tcfg"], device="cpu")
    tpc.allocate_pages(tst, 1, 1)
    lj, jst = jpd.paged_prefill_seq(jp, PJCFG, a["jcfg"], jnp.asarray(1), jnp.asarray(ids, jnp.int32), jst,
                                    a["jt"])
    lt, _ = tpd.paged_prefill_seq(tp, PTCFG, a["tcfg"], 1, torch.from_numpy(ids), tst, a["tt"])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    conv = convert.paged_state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, a["tcfg"], device="cpu")
    for pool in ("key_pool", "value_pool"):
        np.testing.assert_array_equal(slot_tokens(conv, pool, 1, 44), slot_tokens(tst, pool, 1, 44))
    np.testing.assert_allclose(conv["key_residual"][:, 1, :, :1].numpy(), tst["key_residual"][:, 1, :, :1].numpy(),
                               atol=1e-5)


def jax_flat_twin(jst, jcfg, slot=0):
    """million_tpu's flat PQ cache holding slot `slot` of its paged state:
    the pages' code words in table order, the residual window, the counters."""
    table = np.asarray(jst["page_table"])[slot]
    nc, r = int(jst["seq_n_codes"][slot]), int(jst["seq_r"][slot])
    cache = j_init_state(JPQCfg(bs=1, nh_k=2, d=PD, M=PM, C=PC, Lt=LT, N_max=512, dtype=jnp.float32), 2)
    for side in ("key", "value"):
        pool = np.asarray(jst[side + "_pool"])  # (L, pages, nh_k, M, PS / 4)
        used = pool[:, table[: -(-nc // PS)]]
        words = np.moveaxis(used, 1, 3).reshape(*used.shape[:1], *used.shape[2:4], -1)
        cache[side + "_codes"] = cache[side + "_codes"].at[:, 0, :, :, : words.shape[-1]].set(words)
        cache[side + "_residual"] = cache[side + "_residual"].at[:, 0].set(jst[side + "_residual"][:, slot])
    cache["n_codes"] = jnp.full((2,), nc, jnp.int32)
    cache["r"] = jnp.full((2,), r, jnp.int32)
    return cache


def test_paged_step_matches_jax_and_flat(pparams, paged_admission):
    """Teacher-forced paged steps with OPQ, then a flush of the rotated window
    and one more step, each from million_tpu's state, converted (the flush
    then writes the codes million_tpu writes). Plain routes: the port's step
    against million_tpu's flat "pq" oracle on the same sequence, 1e-4.
    million_tpu's paged step (its Pallas kernel in interpret mode, int8 q and
    tables): the port, given the codebook those tables hold, is no further
    from it than million_tpu's own oracle on that codebook is (+1e-4). Here
    that kernel's gap to its oracle reaches 2.03e-2 on one logit of the
    post-flush step (ROADMAP C.3), so a fixed 2e-2 cannot hold it."""
    jp, tp = pparams
    a = paged_admission
    jst = {k: jnp.array(v) for k, v in a["jst"].items()}
    deq = dict(a["c"])
    for side, pack in (("key", "kpack"), ("value", "vpack")):
        deq[side] = np.stack([
            np.asarray(dequantize_table(jax.tree.map(lambda x: x[li], a["jt"][pack]), C=PC, direct=True, d_m=2))
            for li in range(2)])
    tdeq = convert.cents_from_numpy(deq, device="cpu")
    jcents = {k: jnp.asarray(v) for k, v in a["c"].items()}
    jdeq = {k: jnp.asarray(v) for k, v in deq.items()}
    rng = np.random.default_rng(19)
    n, flushed, gaps = 275, False, []
    for step, tok in enumerate(rng.integers(0, 300, (6, 2))):
        tst = convert.paged_state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, a["tcfg"],
                                             device="cpu")
        if int(tst["seq_r"][0]) >= LT:  # the rotated window flushes as it is
            mask = np.asarray([True, False])
            jst = jpd.flush_paged_slots(a["jcfg"], jst, a["jt"], jnp.asarray(mask))
            tpd.flush_paged_slots(a["tcfg"], tst, a["tt"], torch.from_numpy(mask))
            conv = convert.paged_state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, a["tcfg"],
                                                  device="cpu")
            for pool in ("key_pool", "value_pool"):
                np.testing.assert_array_equal(slot_tokens(conv, pool, 0, 280), slot_tokens(tst, pool, 0, 280))
            flushed = True
        twin = jax_flat_twin(jst, a["jcfg"])
        pos = jnp.asarray(n + step, jnp.int32)
        lo, _ = jl.decode_step(jp, PJCFG, jnp.asarray(tok[:1], jnp.int32), pos, twin, jcents, mode="pq")
        lo_deq, _ = jl.decode_step(jp, PJCFG, jnp.asarray(tok[:1], jnp.int32), pos, jax_flat_twin(jst, a["jcfg"]),
                                   jdeq, mode="pq")
        lj, jst = jpd.paged_decode_step(jp, PJCFG, a["jcfg"], jnp.asarray(tok, jnp.int32),
                                        jnp.asarray([n + step, 0], jnp.int32), jst, a["jt"])
        before = {k: v.clone() for k, v in tst.items()}
        lt = tpd.paged_decode_step(tp, PTCFG, a["tcfg"], torch.from_numpy(tok), None, tst, a["tt"])
        np.testing.assert_allclose(lt[0].numpy(), np.asarray(lo)[0], atol=1e-4, err_msg=f"step {step}")
        ld = tpd.paged_decode_step(tp, PTCFG, a["tcfg"], torch.from_numpy(tok), None, before, tdeq)
        np.testing.assert_allclose(ld[0].numpy(), np.asarray(lo_deq)[0], atol=1e-4, err_msg=f"step {step}")
        ref_gap = np.abs(np.asarray(lo_deq)[0] - np.asarray(lj)[0])
        port_gap = np.abs(ld[0].numpy() - np.asarray(lj)[0])
        assert (port_gap <= ref_gap + 1e-4).all(), f"step {step}"
        gaps.append(float(port_gap.max()))
    print("gap to million_tpu's Pallas paged step per step:", gaps)
    assert flushed and int(tst["seq_n_codes"][0]) == 280


def test_scheduler_opq_matches_flat_pipeline(pparams, paged_admission):
    """tests/test_scheduler.py:135 on the port: the scheduler with OPQ tables
    gives the greedy tokens of the port's flat OPQ generate (both f32, the
    same codes at the same steps)."""
    _, tp = pparams
    a = paged_admission
    prompt = np.random.default_rng(23).integers(0, 300, 14)
    sched = Scheduler(tp, PTCFG, a["tcfg"], a["tt"], device="cpu")
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=12))
    got = sched.run_to_completion(max_ticks=60)[0].tokens
    flat = init_state(PQCacheConfig(bs=1, nh_k=2, d=PD, M=PM, C=PC, Lt=LT, N_max=256, dtype=torch.float32),
                      2, device="cpu")
    res, _ = generate(tp, PTCFG, torch.from_numpy(prompt[None]), flat, a["tt"], mode="pq_kernel",
                      max_new_tokens=12, sampling=SamplingConfig(), device="cpu")
    np.testing.assert_array_equal(np.asarray(got), res.tokens[0])


# --- the OPQ rung of the quality ladder -------------------------------------------------------------

def test_opq_rung_tables_match_jax():
    """The ladder's OPQ rung (rung_cents(opq=True), pq.kmeans.train_opq) on
    tiny_lm_v1's K/V (4 windows of 512 tokens of the frozen stream, 4,096 rows
    a layer and side), at nbits=6 to keep the CPU time short. The two packages
    draw different k-means++ inits, and at this size the init alone moves
    Δppl by 0.1-0.5 (the port's seeds 0-3 at nbits=8: OPQ +0.16 to +0.33, PQ
    -0.09 to +0.41), so the tables are compared where they are deterministic:
    their reconstruction error (mean squared, original space, summed over
    layers and sides) within 2 % of million_tpu's tables', orthogonal
    rotations, and the perplexity of
    million_tpu's tables evaluated by the port equal to million_tpu's own
    evaluation (1e-4 relative)."""
    from million_tpu.benchmarks import quality_ladder as jql
    from million_tpu.benchmarks.perplexity import perplexity as j_perplexity
    from million_tpu.benchmarks.tiny_lm import load_checkpoint as j_load
    from million_tpu.cache.pq_cache import PQCacheConfig as JCfg
    from million_tpu_torch.benchmarks import quality_ladder as tql
    from million_tpu_torch.benchmarks.tiny_lm import build_corpus_frozen, checkpoint_path, load_checkpoint
    from million_tpu_torch.pq.ops import pq_decode, pq_encode

    if not checkpoint_path().exists():
        pytest.skip("tiny_lm_v1 checkpoint missing")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, cfg = load_checkpoint(checkpoint_path(), device="cpu")
        jp, jcfg = j_load(checkpoint_path())
        tokens = build_corpus_frozen()
        sample, eval_tokens = tokens[:4 * 512], tokens[-(2 * 512 + 1):]
        kv_k, kv_v = tql.sample_kv(params, cfg, sample, windows=4, ctx=512, bs=4)
        M, nbits, iters = cfg.head_dim // 2, 6, 8
        port = tql.rung_cents(cfg, kv_k, kv_v, M_k=M, nbits_k=nbits, opq=True, train_iters=iters, device="cpu")
        jk, jRk = jql.train_cents(kv_k, M, nbits, iters=iters, opq=True)
        jv, jRv = jql.train_cents(kv_v, M, nbits, iters=iters, opq=True, seed=100)
        ref = {"key": np.asarray(jk), "value": np.asarray(jv), "Rk": np.asarray(jRk), "Rv": np.asarray(jRv)}
        ref_t = convert.cents_from_numpy(ref, device="cpu")
        total = [0.0, 0.0]
        for side, R, kv in (("key", "Rk", kv_k), ("value", "Rv", kv_v)):
            for li in range(cfg.num_layers):
                x = torch.from_numpy(kv[li].astype(np.float32))
                eye = torch.eye(cfg.head_dim)
                np.testing.assert_allclose((port[R][li] @ port[R][li].t()).numpy(), eye.numpy(), atol=1e-4)
                errs = []
                for tab in (port, ref_t):
                    xr = x @ tab[R][li]
                    rec = pq_decode(pq_encode(xr, tab[side][li], "strided"), tab[side][li], "strided")
                    errs.append(float((rec @ tab[R][li].t() - x).square().mean()))
                total = [a + b for a, b in zip(total, errs)]
        # one table's error moves by up to 8 % with the k-means++ init (0.917-1.021 of million_tpu's
        # here); their sum over the layers and sides moves far less
        assert total[0] <= 1.02 * total[1], total
        pqc = dict(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M, C=2**nbits, Lt=64, N_max=512)
        mine = tql.rung_perplexity(params, cfg, eval_tokens, ref_t, max_length=512, max_windows=2)["ppl"]
        want = j_perplexity(jp, jcfg, eval_tokens, lambda: j_init_state(JCfg(dtype=jcfg.dtype, **pqc),
                                                                           jcfg.num_layers),
                            {k: jnp.asarray(v) for k, v in ref.items()}, mode="pq", max_length=512,
                            distort_recent=True, max_windows=2)["ppl"]
        own = tql.rung_perplexity(params, cfg, eval_tokens, port, max_length=512, max_windows=2)["ppl"]
    finally:
        torch.set_num_threads(n)
    print(f"OPQ nbits={nbits}: ppl of million_tpu's tables, port {mine!r} / million_tpu {want!r}; "
          f"the port's own tables {own!r}")
    assert abs(mine - want) <= 1e-4 * want
    assert np.isfinite(own)


# --- on the card: OPQ through every kernel of the three paths ------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_opq_paths_match_the_cpu(pparams, cuda_device):
    """With rotations, the flat (B1, B7), chunked (the causal kernel, B3, B7)
    and paged (B4, B7) paths on the card give the greedy tokens of their
    plain versions on the CPU (f32, the tiny model, 256-token pages)."""
    _, tp = pparams
    on = lambda tree, d: {k: (v.to(d) if k != "layers" else {a: b.to(d) for a, b in v.items()})
                          for k, v in tree.items()}
    c, _ = make_cents(np.random.default_rng(29), "dm2", layers=2, d=PD, C=PC)
    prompt = np.random.default_rng(31).integers(0, 300, 300)
    toks = {}
    for dev in ("cpu", cuda_device):
        p, t = on(tp, dev), convert.cents_from_numpy(c, device=dev)
        cfg = PQCacheConfig(bs=1, nh_k=2, d=PD, M=PM, C=PC, Lt=LT, N_max=512, dtype=torch.float32)
        ids = torch.from_numpy(prompt[None]).to(dev)
        for what, kw in (("flat", {}), ("chunked", dict(prefill_chunk=64))):
            res, _ = generate(p, PTCFG, ids, init_state(cfg, 2, device=dev), t, mode="pq_kernel",
                              max_new_tokens=16, flush_chunk=4, device=dev, **kw)
            toks.setdefault(what, []).append(res.tokens[0])
        pcfg = tpc.PagedPQCacheConfig(**{**POOL, "page_size": 256, "n_pages": 6}, dtype=torch.float32)
        sched = Scheduler(p, PTCFG, pcfg, t, admit_chunk=128, device=dev)
        sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=16))
        toks.setdefault("paged", []).append(np.asarray(sched.run_to_completion(max_ticks=80)[0].tokens))
    for what, (a, b) in toks.items():
        np.testing.assert_array_equal(b, a, err_msg=what)

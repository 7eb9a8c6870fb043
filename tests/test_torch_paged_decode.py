"""The port's paged serving forward against million_tpu on the CPU (f32,
the tiny model of tests/test_scheduler.py, 128-token pages, Lt=8).

The same weights, codebooks and prompts go to both packages; million_tpu's
paged state crosses through convert.paged_state_from_numpy. Tolerances:
  * admission without a kernel on either side (one-shot, and chunked with
    the plain history route against million_tpu's use_kernel=False): codes
    in pages equal token by token (>= 99.9 % beyond layer 0, where an encode
    tie could flip on f32 noise), counters and live residual rows equal,
    logits atol 1e-4 (f32, same arithmetic, other summation order);
  * with outlier pools the port's history applies the outlier terms and
    million_tpu's plain route drops them, so the port is held against
    million_tpu's kernel route at 5e-2 (int8 tables);
  * a teacher-forced paged_decode_step from a converted million_tpu state
    against million_tpu's step (Pallas paged kernel in interpret mode): 2e-2
    with the port decoding with the codebook that kernel's int8 tables hold.
    What is left is the kernel's int8 q and its bf16 weights; the gap measures
    1.0e-2 here (2.2e-2 with the f32 codebook), and million_tpu's own tests
    hold that kernel to its oracle at 2e-2 (tests/test_pallas_kernel.py:596).
    Against the port's own flat decode_step(mode="pq") on the same single
    sequence, which is f32 like the port's step: 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache import paged_pq_cache as jpc
from million_tpu.models import llama as jl
from million_tpu.models import paged_decode as jpd
from million_tpu.ops.pq_attention_pallas import dequantize_table
from million_tpu_torch import convert
from million_tpu_torch.cache import paged_pq_cache as tpc
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama as tl
from million_tpu_torch.models import paged_decode as tpd

GEOM = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=32,
            intermediate_size=128, vocab_size=300)
JCFG = dataclasses.replace(jl.PRESETS["test-tiny"], dtype=jnp.float32, **GEOM)
TCFG = dataclasses.replace(tl.PRESETS["test-tiny"], dtype=torch.float32, **GEOM)
L, NH_K, D, M, C, LT, PS = 2, 2, 32, 16, 64, 8, 128
POOL = dict(num_layers=L, nh_k=NH_K, d=D, M=M, C=C, Lt=LT, page_size=PS, n_pages=8, max_seqs=2,
            pages_per_seq=4)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, convert.params_from_numpy(tree, torch.float32, device="cpu")


def make_tables(rng, O=0):
    c = {"key": rng.standard_normal((L, M, C, 2)).astype(np.float32),
         "value": rng.standard_normal((L, M, C, 2)).astype(np.float32)}
    if O:
        for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")):
            idx = np.sort(rng.choice(D, O, replace=False)).astype(np.int32)
            c[name] = np.stack([idx] * L)
            for ch in idx:
                c[side][:, ch % M, :, ch // M] = 0.0
    jt = jl.build_tables({k: jnp.asarray(v) for k, v in c.items()})
    cfgs = (jpc.PagedPQCacheConfig(dtype=jnp.float32, OK=O, OV=O, **POOL),
            tpc.PagedPQCacheConfig(dtype=torch.float32, OK=O, OV=O, **POOL))
    return jt, convert.cents_from_numpy(c, device="cpu"), cfgs


def fresh(jcfg, tcfg, needs):
    """Empty states of both packages with `needs[slot]` pages allocated."""
    jst, tst = jpc.init_paged_state(jcfg), tpc.init_paged_state(tcfg, device="cpu")
    for slot, k in enumerate(needs):
        if k:
            jst = jpc.allocate_pages(jst, jnp.asarray(slot), k)
            tpc.allocate_pages(tst, slot, k)
    return jst, tst


def slot_tokens(st, pool, slot, n):
    """(L, nh_k, n, X): the slot's first n tokens, read through its table."""
    table = st["page_table"][slot].tolist()
    t = np.arange(n)
    pages = np.asarray([table[i] for i in t // PS])
    return st[pool][:, pages, :, t % PS].permute(1, 2, 0, 3).float().numpy()


def assert_slots_equal(jst, tst, tcfg, slots, min_agree=0.999, deep_atol=1e-6):
    """deep_atol: what the exact rows of layers past the first may differ by
    (layer 0 sees no attention, so it is held at one bf16 ulp either way)."""
    conv = convert.paged_state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, tcfg, device="cpu")
    for k in ("used", "page_table", "seq_n_codes", "seq_n_pages", "seq_r", "seq_active"):
        np.testing.assert_array_equal(conv[k].numpy(), tst[k].numpy(), err_msg=k)
    for slot in slots:
        n, r = int(tst["seq_n_codes"][slot]), int(tst["seq_r"][slot])
        for pool in ("key_pool", "value_pool"):
            a, b = slot_tokens(conv, pool, slot, n), slot_tokens(tst, pool, slot, n)
            np.testing.assert_array_equal(a[0], b[0], err_msg=pool)  # layer 0 sees no attention
            assert (a == b).mean() >= min_agree, pool
        for pool in ("key_outlier_pool", "value_outlier_pool"):
            if pool in tst:  # exact channels, rounded to bf16 by both
                x, y = slot_tokens(conv, pool, slot, n), slot_tokens(tst, pool, slot, n)
                np.testing.assert_allclose(x[0], y[0], rtol=2**-7, atol=1e-6, err_msg=pool)
                np.testing.assert_allclose(x, y, rtol=2**-7, atol=deep_atol, err_msg=pool)
        for k in ("key_residual", "value_residual"):
            np.testing.assert_allclose(conv[k][:, slot, :, :r].numpy(), tst[k][:, slot, :, :r].numpy(),
                                       atol=max(1e-5, deep_atol), err_msg=k)
    return conv


@pytest.mark.parametrize("pos", [[0, 5, 77], [300, 300, 300]])
def test_rope_per_seq_matches_rope_and_jax(rng, pos):
    """The per-sequence RoPE helper equals _rope where the positions are
    equal, and million_tpu's _rope_per_seq at 1e-6, for the llama-3 scaling."""
    cfg = dataclasses.replace(TCFG, rope_scaling="llama3", rope_theta=500000.0)
    jcfg = dataclasses.replace(JCFG, rope_scaling="llama3", rope_theta=500000.0)
    x = rng.standard_normal((3, 4, 1, 32)).astype(np.float32)
    p = torch.tensor(pos)
    got = tl._rotate(torch.from_numpy(x), *tl._rope_per_seq(cfg, p, "cpu"))
    want = jpd._rope_per_seq(jnp.asarray(x), jnp.asarray(pos), jl._rope_freqs(jcfg), jl._rope_mscale(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if len(set(pos)) == 1:
        shared = tl._rotate(torch.from_numpy(x), *tl._rope(cfg, pos[0], "cpu"))
        np.testing.assert_array_equal(got.numpy(), shared.numpy())


def test_prefill_seq_matches_jax(rng, params):
    jp, tp = params
    jt, tt, (jcfg, tcfg) = make_tables(rng)
    n = 45  # 44 codes and a ragged tail of 1
    ids = rng.integers(0, 300, (1, n))
    jst, tst = fresh(jcfg, tcfg, [1])
    lj, jst = jpd.paged_prefill_seq(jp, JCFG, jcfg, jnp.asarray(0), jnp.asarray(ids, jnp.int32), jst, jt)
    lt, out = tpd.paged_prefill_seq(tp, TCFG, tcfg, 0, torch.from_numpy(ids), tst, tt)
    assert out is tst
    assert (int(tst["seq_n_codes"][0]), int(tst["seq_r"][0]), int(tst["seq_active"][0])) == (44, 1, 1)
    assert_slots_equal(jst, tst, tcfg, [0])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


@pytest.fixture(scope="module")
def chunked_admission(params):
    """One chunked admission (275 tokens, 3 chunks of 128) in both packages,
    shared by the tests that start from an admitted slot."""
    jp, tp = params
    rng = np.random.default_rng(7)
    jt, tt, (jcfg, tcfg) = make_tables(rng)
    prompt = rng.integers(0, 300, 275)
    jst, tst = fresh(jcfg, tcfg, [3])
    lj, jst = jpd.paged_admit_chunked(jp, JCFG, jcfg, 0, prompt.astype(np.int32), jst, jt, chunk=128,
                                      use_kernel=False)
    lt, _ = tpd.paged_admit_chunked(tp, TCFG, tcfg, 0, prompt, tst, tt, chunk=128, hist_block=64,
                                    use_kernel=False)
    return dict(jst=jst, tst=tst, lj=np.asarray(lj), lt=lt.numpy(), jt=jt, tt=tt, jcfg=jcfg, tcfg=tcfg,
                prompt=prompt)


def test_admit_chunked_matches_jax(chunked_admission):
    a = chunked_admission
    assert (int(a["tst"]["seq_n_codes"][0]), int(a["tst"]["seq_r"][0])) == (272, 3)
    assert_slots_equal(a["jst"], a["tst"], a["tcfg"], [0])
    np.testing.assert_allclose(a["lt"], a["lj"], atol=1e-4)


def test_admit_chunked_wrapper_route_equals_plain_route(params, chunked_admission):
    """use_kernel=None goes through the chunk-history wrapper, which runs its
    plain version for CPU tensors: the same state and logits."""
    _, tp = params
    a = chunked_admission
    _, tst = fresh(a["jcfg"], a["tcfg"], [3])
    lt, _ = tpd.paged_admit_chunked(tp, TCFG, a["tcfg"], 0, a["prompt"], tst, a["tt"], chunk=128)
    np.testing.assert_allclose(lt.numpy(), a["lt"], atol=1e-5)
    for k in ("key_pool", "value_pool"):
        assert torch.equal(tst[k][:, :-1], a["tst"][k][:, :-1]), k


def test_converted_state_reads_token_by_token(params, chunked_admission):
    """The converter after an admission AND a flush: million_tpu's state,
    converted, gives the port's codes token by token through the page table,
    and both flushed the same window into the same place."""
    jp, tp = params
    a = chunked_admission
    jst = {k: jnp.array(v) for k, v in a["jst"].items()}  # the fixture's state stays as it is
    tst = {k: v.clone() for k, v in a["tst"].items()}
    rng = np.random.default_rng(8)
    win = rng.standard_normal((L, 2, NH_K, LT, D)).astype(np.float32)  # a full window in every slot
    for side in ("key_residual", "value_residual"):
        jst[side] = jnp.asarray(win)
        tst[side].copy_(torch.from_numpy(win))
    jst["seq_r"] = jst["seq_r"].at[0].set(LT)
    tst["seq_r"][0] = LT
    mask = np.asarray([True, False])
    jst = jpd.flush_paged_slots(a["jcfg"], jst, a["jt"], jnp.asarray(mask))
    tpd.flush_paged_slots(a["tcfg"], tst, a["tt"], torch.from_numpy(mask))
    assert (int(tst["seq_n_codes"][0]), int(tst["seq_r"][0])) == (280, 0)
    conv = assert_slots_equal(jst, tst, a["tcfg"], [0])
    words = np.asarray(jst["key_pool"])
    table = np.asarray(jst["page_table"])[0]
    for t in (0, 127, 128, 271, 272, 279):  # across a page boundary and into the flushed window
        w = words[:, table[t // PS], :, :, (t % PS) // 4]  # (L, nh_k, M) int32 words
        byte = (w.astype(np.uint32) >> (8 * (t % 4))) & 0xFF
        np.testing.assert_array_equal(slot_tokens(conv, "key_pool", 0, 280)[:, :, t], byte)


def test_admit_chunked_with_outlier_pools(rng, params):
    jp, tp = params
    jt, tt, (jcfg, tcfg) = make_tables(rng, O=4)
    prompt = rng.integers(0, 300, 275)
    outs = {}
    for uk in (None, False):
        _, tst = fresh(jcfg, tcfg, [3])
        outs[uk], _ = tpd.paged_admit_chunked(tp, TCFG, tcfg, 0, prompt, tst, tt, chunk=128, use_kernel=uk)
    np.testing.assert_allclose(outs[None].numpy(), outs[False].numpy(), atol=1e-5)
    jst, _ = fresh(jcfg, tcfg, [3])
    lj, jst = jpd.paged_admit_chunked(jp, JCFG, jcfg, 0, prompt.astype(np.int32), jst, jt, chunk=128,
                                      use_kernel=True)
    # deeper layers carry the int8-table noise of million_tpu's kernel route
    assert_slots_equal(jst, tst, tcfg, [0], min_agree=0.97, deep_atol=5e-2)
    np.testing.assert_allclose(outs[None].numpy(), np.asarray(lj), rtol=5e-2, atol=5e-2)


def test_batched_admission_equals_one_by_one(rng, params):
    _, tp = params
    _, tt, (jcfg, tcfg) = make_tables(rng)
    p0, p1 = rng.integers(0, 300, 275), rng.integers(0, 300, 261)  # one 3-chunk bucket
    _, a = fresh(jcfg, tcfg, [3, 3])
    la0, _ = tpd.paged_admit_chunked(tp, TCFG, tcfg, 0, p0, a, tt, chunk=128)
    la1, _ = tpd.paged_admit_chunked(tp, TCFG, tcfg, 1, p1, a, tt, chunk=128)
    _, b = fresh(jcfg, tcfg, [3, 3])
    lb, _ = tpd.paged_admit_chunked_batch(tp, TCFG, tcfg, [0, 1], [p0, p1], b, tt, chunk=128)
    for k in ("seq_n_codes", "seq_r", "seq_active", "seq_n_pages", "page_table", "used"):
        assert torch.equal(a[k], b[k]), k
    assert a["seq_n_codes"].tolist() == [272, 260] and a["seq_r"].tolist() == [3, 1]
    for slot, n in ((0, 272), (1, 260)):
        for pool in ("key_pool", "value_pool"):
            np.testing.assert_array_equal(slot_tokens(a, pool, slot, n), slot_tokens(b, pool, slot, n))
    np.testing.assert_allclose(lb[0].numpy(), la0[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(lb[1].numpy(), la1[0].numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="shared bucket"):
        tpd.paged_admit_chunked_batch(tp, TCFG, tcfg, [0, 1], [p0, p1[:100]], b, tt, chunk=128)
    with pytest.raises(ValueError, match="multiple of 4"):
        tpd.paged_admit_chunked(tp, TCFG, tcfg, 0, p0, b, tt, chunk=130)


def test_flush_with_a_mixed_mask_matches_jax(rng):
    jt, tt, (jcfg, tcfg) = make_tables(rng, O=4)
    jst, tst = fresh(jcfg, tcfg, [2, 1])
    win = {s: rng.standard_normal((L, 2, NH_K, LT, D)).astype(np.float32) for s in ("key", "value")}
    counters = dict(seq_n_codes=[120, 40], seq_r=[LT, 5], seq_active=[1, 1])
    for s, w in win.items():
        jst[s + "_residual"] = jnp.asarray(w)
        tst[s + "_residual"].copy_(torch.from_numpy(w))
    for k, v in counters.items():
        jst[k] = jnp.asarray(v, jnp.int32)
        tst[k].copy_(torch.tensor(v, dtype=torch.int32))
    mask = np.asarray([True, False])
    jst = jpd.flush_paged_slots(jcfg, jst, jt, jnp.asarray(mask))
    out = tpd.flush_paged_slots(tcfg, tst, tt, torch.from_numpy(mask))
    assert out is tst and tst["seq_n_codes"].tolist() == [128, 40] and tst["seq_r"].tolist() == [0, 5]
    conv = convert.paged_state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, tcfg, device="cpu")
    for k in ("seq_n_codes", "seq_r", "page_table", "used"):
        np.testing.assert_array_equal(conv[k].numpy(), tst[k].numpy(), err_msg=k)
    for pool in ("key_pool", "value_pool", "key_outlier_pool", "value_outlier_pool"):
        # the flushed window [120, 128) of slot 0; the unmasked slot's pages stay empty
        np.testing.assert_array_equal(slot_tokens(conv, pool, 0, 128)[:, :, 120:],
                                      slot_tokens(tst, pool, 0, 128)[:, :, 120:], err_msg=pool)
        assert not tst[pool][:, int(tst["page_table"][1, 0])].any(), pool


def test_flush_window_may_straddle_two_pages(rng):
    """A window that starts 4 tokens before a page boundary is written to
    both pages, token by token (the reference's page-slab writer would shift
    such a window back inside the first page)."""
    _, tt, (_, tcfg) = make_tables(rng)
    tst = tpc.init_paged_state(tcfg, device="cpu")
    tpc.allocate_pages(tst, 0, 2)
    win = torch.from_numpy(rng.standard_normal((L, 2, NH_K, LT, D)).astype(np.float32))
    tst["key_residual"].copy_(win)
    tst["value_residual"].copy_(win)
    tst["seq_n_codes"][0], tst["seq_r"][0], tst["seq_active"][0] = PS - 4, LT, 1
    tpd.flush_paged_slots(tcfg, tst, tt, torch.tensor([True, False]))
    from million_tpu_torch.pq.ops import runtime_encode

    want = runtime_encode(win[:, 0], tt["key"][0], "strided")[0].numpy()  # layer 0: (nh_k, Lt, M)
    got = slot_tokens(tst, "key_pool", 0, PS + 4)[0, :, PS - 4:]
    np.testing.assert_array_equal(got, want)
    assert int(tst["seq_n_codes"][0]) == PS + 4


def test_decode_step_matches_jax_step_and_the_flat_oracle(params, chunked_admission):
    """Teacher-forced steps from the admitted state: the port's paged step
    (plain version of the paged kernel) against million_tpu's paged step
    (2e-2) and against the port's flat oracle step on the same sequence
    (1e-4), with an inactive slot beside the live one."""
    jp, tp = params
    a = chunked_admission
    jst = {k: jnp.array(v) for k, v in a["jst"].items()}
    tst = convert.paged_state_from_numpy({k: np.asarray(v) for k, v in a["jst"].items()}, a["tcfg"],
                                         device="cpu")
    rng = np.random.default_rng(9)
    n = 275
    deq = dict(a["tt"])
    for side, pack in (("key", "kpack"), ("value", "vpack")):
        deq[side] = torch.from_numpy(np.stack([
            np.asarray(dequantize_table(jax.tree.map(lambda x: x[li], a["jt"][pack]), C=C, direct=True, d_m=2))
            for li in range(L)]))
    gaps = []
    for step, tok in enumerate(rng.integers(0, 300, (3, 2))):
        # the flat twin of slot 0, built from the paged state before the step
        nc, r = int(tst["seq_n_codes"][0]), int(tst["seq_r"][0])
        flat = init_state(PQCacheConfig(bs=1, nh_k=NH_K, d=D, M=M, C=C, Lt=LT, N_max=512,
                                        dtype=torch.float32), L, device="cpu")
        for side in ("key", "value"):
            flat[side + "_codes"][:, 0, :, :nc] = torch.from_numpy(
                slot_tokens(tst, side + "_pool", 0, nc)).to(torch.uint8)
            flat[side + "_residual"][:, 0] = tst[side + "_residual"][:, 0]
        flat["n_codes"], flat["r"] = nc, r
        want_flat = tl.decode_step(tp, TCFG, torch.from_numpy(tok[:1]), n + step, flat, a["tt"], mode="pq")

        pos = np.asarray([n + step, 0], np.int32)
        lj, jst = jpd.paged_decode_step(jp, JCFG, a["jcfg"], jnp.asarray(tok, jnp.int32), jnp.asarray(pos),
                                        jst, a["jt"])
        before = {k: v.clone() for k, v in tst.items()}
        lt = tpd.paged_decode_step(tp, TCFG, a["tcfg"], torch.from_numpy(tok), None, tst, a["tt"])
        assert torch.isfinite(lt).all()  # the inactive slot computes in lockstep, on nothing
        np.testing.assert_allclose(lt[0].numpy(), want_flat[0].numpy(), atol=1e-4, err_msg=f"step {step}")
        # million_tpu's step decodes with int8 tables: the port is given the codebook those
        # tables hold (dequantize_table); what is left is that kernel's int8 / bf16 q
        ld = tpd.paged_decode_step(tp, TCFG, a["tcfg"], torch.from_numpy(tok), None, before, deq)
        gaps.append((float(np.abs(ld[0].numpy() - np.asarray(lj)[0]).max()),
                     float(np.abs(lt[0].numpy() - np.asarray(lj)[0]).max())))
        np.testing.assert_allclose(ld[0].numpy(), np.asarray(lj)[0], atol=2e-2, err_msg=f"step {step}")
        assert tst["seq_r"].tolist() == [r + 1, 0] == np.asarray(jst["seq_r"]).tolist()
    print("gap to million_tpu's step, with its codebook / with the f32 codebook:", gaps)
    # the rows the three steps appended; layer 0's depend on no attention
    np.testing.assert_allclose(tst["key_residual"][0, 0, :, :6].numpy(),
                               np.asarray(jst["key_residual"])[0, 0, :, :6], atol=1e-5)
    # the plain version on request gives the wrapper's CPU result
    again = {k: v.clone() for k, v in tst.items()}
    l1 = tpd.paged_decode_step(tp, TCFG, a["tcfg"], torch.from_numpy(tok), None, tst, a["tt"], n_bound=3 * PS)
    l2 = tpd.paged_decode_step(tp, TCFG, a["tcfg"], torch.from_numpy(tok), None, again, a["tt"],
                               use_kernel=False)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-5)


def test_unported_routes_raise(rng, params):
    _, tp = params
    _, tt, (_, tcfg) = make_tables(rng)
    # the mesh routes arrived with the multi-GPU slice: on a one-rank mesh (one sequence shard, its
    # slab the whole pool) admission, flush and decode give what they give without one
    from million_tpu_torch.parallel.mesh import make_mesh

    tok = torch.zeros(2, dtype=torch.long)
    outs = []
    for mesh in (None, make_mesh(device="cpu")):
        tst = tpc.init_paged_state(tcfg, device="cpu")
        tpc.allocate_pages(tst, 0, 2)
        la, _ = tpd.paged_admit_chunked(tp, TCFG, tcfg, 0, np.arange(40) % 7, tst, tt, chunk=16, mesh=mesh)
        tst["seq_r"][0] = LT
        tpd.flush_paged_slots(tcfg, tst, tt, torch.tensor([True, False]), mesh=mesh)
        ld = tpd.paged_decode_step(tp, TCFG, tcfg, tok, None, tst, tt, mesh=mesh)
        outs.append((la, ld, tst["key_pool"].clone()))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bf16_admission_with_32_exact_channels(rng, monkeypatch):
    """A 16-bit model with 32 exact K and V channels (pq.outlier_k=32), a
    geometry the bf16 history kernel is not built for: the admission's
    history partials take the f32 precision (on the card the f32 kernel,
    where it raised before), and the logits stay within the 5e-2 of
    million_tpu's kernel route with outlier pools."""
    from million_tpu_torch.ops import pq_chunk_attention_kernel as K

    geom = dict(GEOM, hidden_size=128, intermediate_size=256, head_dim=64)
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16, **geom)
    tcfg = dataclasses.replace(TCFG, dtype=torch.bfloat16, **geom)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), torch.bfloat16,
                                   device="cpu")
    d, m, O = 64, 16, 32
    c = {"key": rng.standard_normal((L, m, C, d // m)).astype(np.float32),
         "value": rng.standard_normal((L, m, C, d // m)).astype(np.float32)}
    for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")):
        idx = np.sort(rng.choice(d, O, replace=False)).astype(np.int32)
        c[name] = np.stack([idx] * L)
        for ch in idx:
            c[side][:, ch % m, :, ch // m] = 0.0
    pool = dict(POOL, d=d, M=m, OK=O, OV=O)
    jpcfg = jpc.PagedPQCacheConfig(dtype=jnp.bfloat16, **pool)
    tpcfg = tpc.PagedPQCacheConfig(dtype=torch.bfloat16, **pool)
    jst, tst = fresh(jpcfg, tpcfg, [3])
    prompt = rng.integers(0, 300, 275)
    seen = []
    plain = K.pq_chunk_attention_plain

    def spy(*a, **k):
        seen.append(k["precision"])
        return plain(*a, **k)

    monkeypatch.setattr(K, "pq_chunk_attention_plain", spy)
    lt, _ = tpd.paged_admit_chunked(tp, tcfg, tpcfg, 0, prompt, tst, convert.cents_from_numpy(c, device="cpu"),
                                    chunk=128)
    assert seen == ["f32"] * (L * 2)  # every layer of the two chunks with a history
    lj, _ = jpd.paged_admit_chunked(jp, jcfg, jpcfg, 0, prompt.astype(np.int32), jst,
                                    jl.build_tables({k: jnp.asarray(v) for k, v in c.items()}), chunk=128,
                                    use_kernel=True)
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32), rtol=5e-2, atol=5e-2)

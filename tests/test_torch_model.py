"""The port's model, cache and generation loop against million_tpu on the CPU.

The test-tiny model (f32) gets the same weights and codebooks in both
packages (made with numpy or JAX, carried across by million_tpu_torch.convert).
The port's "pq_kernel" mode (the kernel's plain version on the CPU) is held
against million_tpu's "pq" oracle mode at atol 1e-4 per step, across
sub-window flushes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache.dense_cache import DenseCacheConfig as JDenseCfg, init_dense_state as j_init_dense
from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import llama as jl
from million_tpu.runtime.generate import generate as j_generate
from million_tpu.runtime.sampling import SamplingConfig as JSampling
from million_tpu_torch import convert
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, cache_memory_bytes, init_state
from million_tpu_torch.models import llama as tl
from million_tpu_torch.runtime.generate import generate

JCFG = jl.PRESETS["test-tiny"]
TCFG = tl.PRESETS["test-tiny"]
L, D_HEAD, NH_K = JCFG.num_layers, JCFG.head_dim, JCFG.num_kv_heads
BS, LT, N_MAX = 2, 8, 128


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, convert.params_from_numpy(np_tree(jp), torch.float32, device="cpu")


def make_cents(rng, geom):
    """geom "dm2": M=d/2, C=32. "outlier": M=d/4, C=64 with 4 + 4 exact
    outlier channels whose centroid components are 0."""
    if geom == "dm2":
        M, C, dm, O = D_HEAD // 2, 32, 2, 0
    else:
        M, C, dm, O = D_HEAD // 4, 64, 4, 4
    c = {"key": rng.standard_normal((L, M, C, dm)).astype(np.float32),
         "value": rng.standard_normal((L, M, C, dm)).astype(np.float32)}
    if O:
        for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")):
            idx = np.stack([np.sort(rng.choice(D_HEAD, O, replace=False)) for _ in range(L)])
            c[name] = idx.astype(np.int32)
            for li in range(L):
                for ch in idx[li]:
                    c[side][li, ch % M, :, ch // M] = 0.0
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    return jc, convert.cents_from_numpy(c, device="cpu"), dict(M=M, C=C, OK=O, OV=O)


def caches(geom_kw):
    j = j_init_state(JPQCfg(bs=BS, nh_k=NH_K, d=D_HEAD, Lt=LT, N_max=N_MAX, dtype=jnp.float32, **geom_kw), L)
    t = init_state(PQCacheConfig(bs=BS, nh_k=NH_K, d=D_HEAD, Lt=LT, N_max=N_MAX, dtype=torch.float32, **geom_kw),
                   L, device="cpu")
    return j, t


def assert_caches_equal(jc, tc):
    conv = convert.pq_cache_from_numpy(np_tree_keep(jc), device="cpu")
    assert (conv["n_codes"], conv["r"]) == (tc["n_codes"], tc["r"])
    for k in ("key_codes", "value_codes", "key_outliers", "value_outliers"):
        if k in tc:
            np.testing.assert_array_equal(conv[k].float().numpy(), tc[k].float().numpy(), err_msg=k)
    r = tc["r"]
    for k in ("key_residual", "value_residual"):
        np.testing.assert_allclose(conv[k][:, :, :, :r].numpy(), tc[k][:, :, :, :r].numpy(), atol=1e-5)


def np_tree_keep(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_presets_match_jax():
    assert set(tl.PRESETS) == set(jl.PRESETS)
    for name, jcfg in jl.PRESETS.items():
        jd = dataclasses.asdict(jcfg)
        td = dataclasses.asdict(tl.PRESETS[name])
        assert jnp.dtype(jd.pop("dtype")).name == str(td.pop("dtype")).replace("torch.", "")
        assert jd == td, name


@pytest.mark.parametrize("preset", ["llama-3.2-3b", "yarn-llama-2-7b-128k", "test-tiny"])
def test_rope_matches_jax(preset):
    inv_j = np.asarray(jl._rope_freqs(jl.PRESETS[preset]))
    inv_t = tl._rope_freqs(tl.PRESETS[preset]).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-6)
    assert tl._rope_mscale(tl.PRESETS[preset]) == jl._rope_mscale(jl.PRESETS[preset])
    x = np.random.default_rng(0).standard_normal((1, 2, 5, jl.PRESETS[preset].head_dim)).astype(np.float32)
    pos = np.arange(30000, 30005)
    want = jl._apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv_j))
    got = tl._apply_rope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("mode", ["pq", "dense"])
def test_prefill_logits_match_jax(rng, params, mode):
    jp, tp = params
    jcents, tcents, gkw = make_cents(rng, "outlier")
    ids = rng.integers(0, JCFG.vocab_size, (BS, 13))
    if mode == "pq":
        jc, tc = caches(gkw)
    else:
        jc = j_init_dense(JDenseCfg(bs=BS, nh_k=NH_K, d=D_HEAD, N_max=64, dtype=jnp.float32), L)
        tc = init_dense_state(DenseCacheConfig(bs=BS, nh_k=NH_K, d=D_HEAD, N_max=64, dtype=torch.float32),
                              L, device="cpu")
    lj, jc = jl.prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents if mode == "pq" else None, mode=mode)
    lt = tl.prefill(tp, TCFG, torch.from_numpy(ids), tc, tcents if mode == "pq" else None, mode=mode)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    if mode == "pq":
        assert_caches_equal(jc, tc)
    else:
        assert tc["length"] == int(jc["length"][0]) == 13
    last = tl.prefill(tp, TCFG, torch.from_numpy(ids), caches(gkw)[1] if mode == "pq" else
                      init_dense_state(DenseCacheConfig(bs=BS, nh_k=NH_K, d=D_HEAD, N_max=64,
                                                        dtype=torch.float32), L, device="cpu"),
                      tcents if mode == "pq" else None, mode=mode, last_logit_only=True)
    np.testing.assert_allclose(last.numpy(), lt[:, -1:].numpy(), atol=1e-6)


@pytest.mark.parametrize("geom", ["dm2", "outlier"])
def test_decode_across_flush_matches_jax(rng, params, geom):
    """Prefill 17 tokens, then 12 decode steps with F=4 sub-window flushes
    (three of them): port "pq_kernel" vs JAX "pq" per step, and the caches
    (codes, outlier arenas, counters, live residual rows) stay equal."""
    jp, tp = params
    jcents, tcents, gkw = make_cents(rng, geom)
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
            assert_caches_equal(jc, tc)
        lj, jc = jl.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32), jnp.asarray(17 + t, jnp.int32),
                                jc, jcents, mode="pq")
        lt = tl.decode_step(tp, TCFG, torch.from_numpy(tok), 17 + t, tc, tcents, mode="pq_kernel")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, err_msg=f"step {t}")
    assert flushes >= 2
    assert_caches_equal(jc, tc)


def test_dense_decode_matches_jax(rng, params):
    jp, tp = params
    jc = j_init_dense(JDenseCfg(bs=BS, nh_k=NH_K, d=D_HEAD, N_max=32, dtype=jnp.float32), L)
    tc = init_dense_state(DenseCacheConfig(bs=BS, nh_k=NH_K, d=D_HEAD, N_max=32, dtype=torch.float32),
                          L, device="cpu")
    ids = rng.integers(0, JCFG.vocab_size, (BS, 6))
    _, jc = jl.prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, None, mode="dense")
    tl.prefill(tp, TCFG, torch.from_numpy(ids), tc, None, mode="dense")
    for t, tok in enumerate(rng.integers(0, JCFG.vocab_size, (3, BS))):
        lj, jc = jl.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32), jnp.asarray(6 + t, jnp.int32),
                                jc, None, mode="dense")
        lt = tl.decode_step(tp, TCFG, torch.from_numpy(tok), 6 + t, tc, None, mode="dense")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


@pytest.mark.parametrize("geom", ["dm2", "outlier"])
def test_generate_greedy_matches_jax(rng, params, geom):
    jp, tp = params
    jcents, tcents, gkw = make_cents(rng, geom)
    jc, tc = caches(gkw)
    ids = rng.integers(0, JCFG.vocab_size, (BS, 10))
    rj, _ = j_generate(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, mode="pq",
                       max_new_tokens=16, sampling=JSampling(), flush_chunk=4)
    rt, tc = generate(tp, TCFG, torch.from_numpy(ids), tc, tcents, mode="pq_kernel",
                      max_new_tokens=16, flush_chunk=4, device="cpu", selfcheck_every=5)
    assert rt.n_flushes >= 2
    np.testing.assert_array_equal(rt.tokens, np.asarray(rj.tokens))
    assert rt.selfcheck_max_diff < 1e-4
    assert tc["n_codes"] == 8 + 4 * rt.n_flushes


def test_generate_one_token_and_capacity(rng, params):
    jp, tp = params
    jcents, tcents, gkw = make_cents(rng, "dm2")
    ids = rng.integers(0, JCFG.vocab_size, (BS, 9))
    jc, tc = caches(gkw)
    rj, _ = j_generate(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, mode="pq", max_new_tokens=1)
    rt, _ = generate(tp, TCFG, torch.from_numpy(ids), tc, tcents, max_new_tokens=1, device="cpu")
    assert rt.tokens.shape == (BS, 1)
    np.testing.assert_array_equal(rt.tokens, np.asarray(rj.tokens))
    with pytest.raises(ValueError, match="N_max"):
        generate(tp, TCFG, torch.from_numpy(ids), caches(gkw)[1], tcents, max_new_tokens=200,
                 device="cpu")
    dense = init_dense_state(DenseCacheConfig(bs=BS, nh_k=NH_K, d=D_HEAD, N_max=16, dtype=torch.float32),
                             L, device="cpu")
    with pytest.raises(ValueError, match="dense cache capacity"):
        generate(tp, TCFG, torch.from_numpy(ids), dense, None, mode="dense", max_new_tokens=8,
                 device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        generate(tp, TCFG, torch.from_numpy(ids), caches(gkw)[1], tcents, flush_chunk=6,
                 device="cpu")


def test_cuda_requested_without_card_raises(params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the error path is not reachable")
    _, tp = params
    cfg = PQCacheConfig(bs=1, nh_k=NH_K, d=D_HEAD, M=8, C=32, Lt=LT, N_max=N_MAX)
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg, L)
    with pytest.raises(RuntimeError, match="cuda"):
        tl.init_params(TCFG)
    with pytest.raises(RuntimeError, match="cuda"):
        generate(tp, TCFG, torch.zeros((1, 4), dtype=torch.long), init_state(cfg, L, device="cpu"),
                 None, max_new_tokens=2)


def test_later_slices_raise(rng, params):
    _, tp = params
    _, tcents, gkw = make_cents(rng, "dm2")
    tc = caches(gkw)[1]
    ids = torch.zeros((BS, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError):
        tl.prefill(tp, TCFG, ids, tc, tcents, mesh=object())
    # distort_recent and return_hidden arrived with the quality slice
    hidden = tl.prefill(tp, TCFG, ids, caches(gkw)[1], tcents, distort_recent=True, return_hidden=True)
    assert hidden.shape == (BS, 4, TCFG.hidden_size)


def test_cache_memory_bytes():
    cfg = PQCacheConfig(bs=1, nh_k=8, d=128, M=32, C=128, N_max=32768, OK=16, OV=16)
    mem = cache_memory_bytes(cfg, 28)
    assert mem["codes"] + mem["outliers"] == 28 * 8 * 32768 * 128

"""The port's chunked prefill against million_tpu on the CPU (test-tiny, f32).

Mirrors tests/test_chunked_prefill.py: one chunk reproduces the port's flat
prefill (codes bit-equal, logits atol 1e-4); a multi-chunk prefill matches
million_tpu's chunked_prefill(use_kernel=False) with the same weights,
codebooks and ids (codes, counters and live residual rows equal, last logits
atol 1e-4) and decodes on like it; with outlier channels, where million_tpu's
plain route drops the outlier terms of the history, the port is held against
million_tpu's kernel route in interpret mode at that kernel's int8-table
tolerance (5e-2, as tests/test_chunked_prefill.py holds it); generate(
prefill_chunk=...) gives million_tpu's greedy tokens; the contract's errors
are raised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import chunked_prefill as jcp
from million_tpu.models import llama as jl
from million_tpu.runtime.generate import generate as j_generate
from million_tpu.runtime.sampling import SamplingConfig as JSampling
from million_tpu_torch import convert
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import chunked_prefill as tcp
from million_tpu_torch.models import llama as tl
from million_tpu_torch.ops.pq_attention_ref import causal_attention
from million_tpu_torch.runtime.generate import generate

JCFG = jl.PRESETS["test-tiny"]
TCFG = tl.PRESETS["test-tiny"]
L, D_HEAD, NH_K = JCFG.num_layers, JCFG.head_dim, JCFG.num_kv_heads
BS, LT, N_MAX = 2, 8, 128


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, convert.params_from_numpy(tree, torch.float32, device="cpu")


def make_cents(rng, geom):
    """geom "dm2": M=d/2, C=32. "outlier": M=d/4, C=64 with 4 + 4 exact
    outlier channels whose centroid components are 0."""
    M, C, dm, O = (D_HEAD // 2, 32, 2, 0) if geom == "dm2" else (D_HEAD // 4, 64, 4, 4)
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


def caches(geom_kw, bs=BS):
    j = j_init_state(JPQCfg(bs=bs, nh_k=NH_K, d=D_HEAD, Lt=LT, N_max=N_MAX, dtype=jnp.float32, **geom_kw), L)
    t = init_state(PQCacheConfig(bs=bs, nh_k=NH_K, d=D_HEAD, Lt=LT, N_max=N_MAX, dtype=torch.float32, **geom_kw),
                   L, device="cpu")
    return j, t


def assert_caches_equal(jc, tc, layers=slice(None)):
    conv = convert.pq_cache_from_numpy({k: np.asarray(v) for k, v in jc.items()}, device="cpu")
    assert (conv["n_codes"], conv["r"]) == (tc["n_codes"], tc["r"])
    for k in ("key_codes", "value_codes", "key_outliers", "value_outliers"):
        if k in tc:
            np.testing.assert_array_equal(conv[k][layers].float().numpy(), tc[k][layers].float().numpy(),
                                          err_msg=k)
    r = tc["r"]
    for k in ("key_residual", "value_residual"):
        np.testing.assert_allclose(conv[k][layers, :, :, :r].numpy(), tc[k][layers, :, :, :r].numpy(),
                                   atol=1e-5)


@pytest.mark.parametrize("geom", ["dm2", "outlier"])
def test_single_chunk_matches_flat_prefill(rng, params, geom):
    _, tp = params
    _, tcents, gkw = make_cents(rng, geom)
    ids = torch.from_numpy(rng.integers(0, TCFG.vocab_size, (BS, 50)))
    lc, cc = tcp.chunked_prefill(tp, TCFG, ids, caches(gkw)[1], tcents, chunk=128)
    cf = caches(gkw)[1]
    lf = tl.prefill(tp, TCFG, ids, cf, tcents, mode="pq", last_logit_only=True)
    assert (cc["n_codes"], cc["r"]) == (cf["n_codes"], cf["r"]) == (48, 2)
    for k in ("key_codes", "value_codes"):
        assert torch.equal(cc[k], cf[k]), k
    for k in ("key_outliers", "value_outliers"):
        if k in cf:  # exact channels: layer 0 sees no attention, so it is bit-equal; deeper
            # layers carry the float noise of the blockwise partial, at most one bf16 ulp
            assert torch.equal(cc[k][0], cf[k][0]), k
            np.testing.assert_allclose(cc[k].float().numpy(), cf[k].float().numpy(), rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(cc["key_residual"].numpy(), cf["key_residual"].numpy(), atol=1e-5)
    assert lc.shape == (BS, TCFG.vocab_size)
    np.testing.assert_allclose(lc.numpy(), lf[:, -1].numpy(), atol=1e-4)


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("n,chunk", [(50, 16), (96, 32), (23, 4)])
def test_multi_chunk_matches_jax(rng, params, n, chunk, use_kernel):
    jp, tp = params
    jcents, tcents, gkw = make_cents(rng, "dm2")
    ids = rng.integers(0, JCFG.vocab_size, (BS, n))
    jc, tc = caches(gkw)
    lj, jc = jcp.chunked_prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, chunk=chunk,
                                 hist_block=16, use_kernel=False)
    lt, tc2 = tcp.chunked_prefill(tp, TCFG, torch.from_numpy(ids), tc, tcents, chunk=chunk,
                                  hist_block=16, use_kernel=use_kernel)
    assert tc2 is tc and (tc["n_codes"], tc["r"]) == (n - n % 4, n % 4)
    assert_caches_equal(jc, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


def test_decode_continues_after_chunked_prefill(rng, params):
    """The chunked caches are decode-ready: port "pq_kernel" steps track
    million_tpu's "pq" steps across a flush."""
    jp, tp = params
    jcents, tcents, gkw = make_cents(rng, "dm2")
    ids = rng.integers(0, JCFG.vocab_size, (BS, 42))
    jc, tc = caches(gkw)
    _, jc = jcp.chunked_prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, chunk=16,
                                hist_block=16, use_kernel=False)
    tcp.chunked_prefill(tp, TCFG, torch.from_numpy(ids), tc, tcents, chunk=16)
    flushes = 0
    for t, tok in enumerate(rng.integers(0, JCFG.vocab_size, (9, BS))):
        if tc["r"] >= LT:
            jc = jl.flush_windows(jc, jcents, n=4)
            tl.flush_windows(tc, tcents, n=4)
            flushes += 1
        lj, jc = jl.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32), jnp.asarray(42 + t, jnp.int32),
                                jc, jcents, mode="pq")
        lt = tl.decode_step(tp, TCFG, torch.from_numpy(tok), 42 + t, tc, tcents, mode="pq_kernel")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, err_msg=f"step {t}")
    assert flushes >= 1
    assert_caches_equal(jc, tc)


def test_outlier_multi_chunk(rng, params):
    """Outlier channels. The port's two history routes agree (both apply the
    outlier terms); million_tpu applies them only on its kernel route, whose
    int8 tables bound the agreement to 5e-2. Layer 0 sees no attention
    history, so its arenas are equal bit for bit."""
    jp, tp = params
    jcents, tcents, gkw = make_cents(rng, "outlier")
    ids = rng.integers(0, JCFG.vocab_size, (1, 50))
    outs = {}
    for uk in (None, False):
        tc = caches(gkw, bs=1)[1]
        outs[uk], _ = tcp.chunked_prefill(tp, TCFG, torch.from_numpy(ids), tc, tcents, chunk=16,
                                          hist_block=16, use_kernel=uk)
    np.testing.assert_allclose(outs[None].numpy(), outs[False].numpy(), atol=1e-5)
    jc = caches(gkw, bs=1)[0]
    lj, jc = jcp.chunked_prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jl.build_tables(jcents),
                                 chunk=16, hist_block=16, use_kernel=True)
    assert_caches_equal(jc, tc, layers=slice(0, 1))
    np.testing.assert_allclose(outs[None].numpy(), np.asarray(lj), rtol=5e-2, atol=5e-2)
    # the outlier terms matter: without them the history route moves away
    stripped = {k: v for k, v in tcents.items() if "outlier" not in k}
    no_o, _ = tcp.chunked_prefill(tp, TCFG, torch.from_numpy(ids),
                                  caches(dict(gkw, OK=0, OV=0), bs=1)[1], stripped, chunk=16)
    assert float((no_o - outs[None]).abs().max()) > 5e-2


@pytest.mark.parametrize("n_prompt,chunk", [(48, 16), (30, 8)])
def test_generate_chunked_greedy_matches_jax(rng, params, n_prompt, chunk):
    jp, tp = params
    jcents, tcents, gkw = make_cents(rng, "dm2")
    jc, tc = caches(gkw)
    ids = rng.integers(0, JCFG.vocab_size, (BS, n_prompt))
    rj, _ = j_generate(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, mode="pq",
                       max_new_tokens=12, sampling=JSampling(), flush_chunk=4,
                       prefill_chunk=chunk, prefill_hist_block=16)
    rt, tc = generate(tp, TCFG, torch.from_numpy(ids), tc, tcents, mode="pq_kernel",
                      max_new_tokens=12, flush_chunk=4, prefill_chunk=chunk, device="cpu")
    assert rt.tokens.shape == (BS, 12)
    np.testing.assert_array_equal(rt.tokens, np.asarray(rj.tokens))
    assert tc["n_codes"] == n_prompt - n_prompt % 4 + 4 * rt.n_flushes


@pytest.mark.parametrize("use_kernel", [None, False])
def test_hist_block_reaches_the_plain_history_route(rng, params, monkeypatch, use_kernel):
    """generate(prefill_hist_block=...) and chunked_prefill(hist_block=...)
    set the history block of the plain version on both CPU routes: the
    wrapper's (use_kernel None) and the explicit plain route's."""
    from million_tpu_torch.ops import pq_chunk_attention_kernel as K

    _, tp = params
    _, tcents, gkw = make_cents(rng, "dm2")
    ids = torch.from_numpy(rng.integers(0, TCFG.vocab_size, (BS, 40)))
    seen = []
    plain = K.pq_chunk_attention_plain

    def spy(*a, **kw):
        seen.append(kw["hist_block"])
        return plain(*a, **kw)

    monkeypatch.setattr(K, "pq_chunk_attention_plain", spy)
    monkeypatch.setattr(tcp, "pq_chunk_attention_plain", spy)
    tcp.chunked_prefill(tp, TCFG, ids, caches(gkw)[1], tcents, chunk=16, hist_block=12,
                        use_kernel=use_kernel)
    assert seen == [12] * (L * 2)  # every layer of the two chunks that have a history
    if use_kernel is None:
        del seen[:]
        generate(tp, TCFG, ids, caches(gkw)[1], tcents, max_new_tokens=1, prefill_chunk=16,
                 prefill_hist_block=20, device="cpu")
        assert seen == [20] * (L * 2)


@pytest.mark.parametrize("nc,block", [(32, 8), (24, 1024), (21, 8)])
def test_causal_partial_matches_jax(rng, nc, block):
    q = rng.standard_normal((2, 4, nc, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, nc, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, nc, 16)).astype(np.float32)
    out, lse = tcp._causal_partial(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   0.25, block=block)
    want_out, want_lse = jcp._causal_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                                             block=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)
    flat = causal_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=0.25)
    np.testing.assert_allclose(out.numpy(), flat.numpy(), atol=1e-5)


def test_contract_errors(rng, params):
    _, tp = params
    _, tcents, gkw = make_cents(rng, "dm2")
    ids = torch.from_numpy(rng.integers(0, TCFG.vocab_size, (BS, 40)))
    with pytest.raises(ValueError, match="multiple of 4"):
        tcp.chunked_prefill(tp, TCFG, ids, caches(gkw)[1], tcents, chunk=10)
    warm = caches(gkw)[1]
    tcp.chunked_prefill(tp, TCFG, ids, warm, tcents, chunk=16)
    with pytest.raises(ValueError, match="FRESH"):
        tcp.chunked_prefill(tp, TCFG, ids, warm, tcents, chunk=16)
    long_ids = torch.zeros((BS, N_MAX + 8), dtype=torch.long)
    with pytest.raises(ValueError, match="N_max"):
        tcp.chunked_prefill(tp, TCFG, long_ids, caches(gkw)[1], tcents, chunk=16)
    with pytest.raises(ValueError, match="N_max"):
        generate(tp, TCFG, long_ids, caches(gkw)[1], tcents, prefill_chunk=16, device="cpu")
    dense = init_dense_state(DenseCacheConfig(bs=BS, nh_k=NH_K, d=D_HEAD, N_max=64, dtype=torch.float32),
                             L, device="cpu")
    with pytest.raises(ValueError, match="PQ mode"):
        generate(tp, TCFG, ids, dense, None, mode="dense", prefill_chunk=16, device="cpu")
    with pytest.raises(NotImplementedError):
        tcp.chunked_prefill(tp, TCFG, ids, caches(gkw)[1], tcents, chunk=16, mesh=object())


def test_counters_advance_once_per_chunk(rng, params, monkeypatch):
    """Every layer of a chunk writes at the same n_codes and sees the same
    history length; the counters move after the last layer."""
    _, tp = params
    _, tcents, gkw = make_cents(rng, "dm2")
    seen = []
    real = tcp.pq_chunk_history_attention

    def spy(q, kc, vc, kcent, vcent, n_prev, scale, **kw):
        seen.append((n_prev, q.shape[2]))
        return real(q, kc, vc, kcent, vcent, n_prev, scale, **kw)

    monkeypatch.setattr(tcp, "pq_chunk_history_attention", spy)
    ids = torch.from_numpy(rng.integers(0, TCFG.vocab_size, (1, 42)))
    tcp.chunked_prefill(tp, TCFG, ids, caches(gkw, bs=1)[1], tcents, chunk=16)
    assert seen == [(16, 16)] * L + [(32, 10)] * L


def test_bf16_model_with_32_exact_channels(rng, monkeypatch):
    """A 16-bit model with 32 exact K and V channels (pq.outlier_k=32), a
    geometry the bf16 history kernel is not built for: every history partial
    takes the f32 precision (on the card the f32 kernel, where it raised
    before), and the logits stay within the 5e-2 that million_tpu's kernel
    route (int8 tables, interpret mode) is held to with outliers."""
    import dataclasses

    from million_tpu_torch.ops import pq_chunk_attention_kernel as K

    geom = dict(num_layers=2, hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=2,
                head_dim=64, vocab_size=256)
    jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16, **geom)
    tcfg = dataclasses.replace(TCFG, dtype=torch.bfloat16, **geom)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), torch.bfloat16,
                                   device="cpu")
    d, M, C, O, n_layers = 64, 16, 64, 32, 2
    c = {"key": rng.standard_normal((n_layers, M, C, d // M)).astype(np.float32),
         "value": rng.standard_normal((n_layers, M, C, d // M)).astype(np.float32)}
    for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")):
        idx = np.stack([np.sort(rng.choice(d, O, replace=False)) for _ in range(n_layers)]).astype(np.int32)
        c[name] = idx
        for li in range(n_layers):
            for ch in idx[li]:
                c[side][li, ch % M, :, ch // M] = 0.0
    kw = dict(bs=1, nh_k=2, d=d, M=M, C=C, Lt=LT, N_max=N_MAX, OK=O, OV=O)
    jc = j_init_state(JPQCfg(dtype=jnp.bfloat16, **kw), n_layers)
    tc = init_state(PQCacheConfig(dtype=torch.bfloat16, **kw), n_layers, device="cpu")
    ids = rng.integers(0, 256, (1, 50))
    seen = []
    plain = K.pq_chunk_attention_plain

    def spy(*a, **k):
        seen.append(k["precision"])
        return plain(*a, **k)

    monkeypatch.setattr(K, "pq_chunk_attention_plain", spy)
    lt, _ = tcp.chunked_prefill(tp, tcfg, torch.from_numpy(ids), tc, convert.cents_from_numpy(c, device="cpu"),
                                chunk=16, hist_block=16)
    assert seen == ["f32"] * (n_layers * 3)  # every layer of the three chunks with a history
    lj, _ = jcp.chunked_prefill(jp, jcfg, jnp.asarray(ids, jnp.int32), jc,
                                jl.build_tables({k: jnp.asarray(v) for k, v in c.items()}), chunk=16,
                                hist_block=16, use_kernel=True)
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32), rtol=5e-2, atol=5e-2)

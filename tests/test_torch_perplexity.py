"""The port's perplexity path against million_tpu on the CPU.

`prefill(distort_recent=True, return_hidden=True)` gets the same weights,
codebooks and tokens in both packages (test-tiny width, f32): the pre-head
hidden states agree within 1e-4 with and without 4 + 4 exact outlier
channels, at C 256 and 128, over a ragged tail. `perplexity` on the pinned
tiny_lm_v1 checkpoint, with million_tpu-trained codebooks carried across as
numpy, agrees within 1e-3 relative (PQ, distorted) and 1e-4 (dense): f32
sums in another order over 2 x 511 positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.benchmarks import perplexity as jppl
from million_tpu.benchmarks import quality_ladder as jql
from million_tpu.benchmarks.tiny_lm import load_checkpoint as j_load
from million_tpu.cache.dense_cache import DenseCacheConfig as JDenseCfg, init_dense_state as j_init_dense
from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import llama as jl
from million_tpu.pq.kmeans import train_pq as j_train_pq
from million_tpu_torch import convert
from million_tpu_torch.benchmarks import perplexity as tppl
from million_tpu_torch.benchmarks import quality_ladder as tql
from million_tpu_torch.benchmarks.tiny_lm import build_corpus_frozen, checkpoint_path, load_checkpoint
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama as tl

JCFG = jl.PRESETS["test-tiny"]
TCFG = tl.PRESETS["test-tiny"]
L, D_HEAD, NH_K = JCFG.num_layers, JCFG.head_dim, JCFG.num_kv_heads
HIDDEN_TOL = 1e-4
PPL_RTOL, DENSE_RTOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def tiny_params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), torch.float32, device="cpu")


def random_cents(rng, M, C, O):
    """Standard-normal codebooks; O exact channels a side, their centroid
    components 0 (strided layout: channel c is component c // M of subspace c % M)."""
    dm = D_HEAD // M
    c = {side: rng.standard_normal((L, M, C, dm)).astype(np.float32) for side in ("key", "value")}
    for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")):
        if O:
            idx = np.stack([np.sort(rng.choice(D_HEAD, O, replace=False)) for _ in range(L)]).astype(np.int32)
            c[name] = idx
            for li in range(L):
                for ch in idx[li]:
                    c[side][li, ch % M, :, ch // M] = 0.0
    return c


@pytest.mark.parametrize("C", [256, 128])
@pytest.mark.parametrize("M,O", [(8, 0), (4, 4)], ids=["dm2", "dm4_outlier"])
def test_distorted_prefill_hidden_matches_jax(rng, tiny_params, M, O, C):
    jp, tp = tiny_params
    c = random_cents(rng, M, C, O)
    bs, n = 2, 23  # a ragged tail of 3 tokens: its codes distort attention too
    ids = rng.integers(0, JCFG.vocab_size, (bs, n))
    kw = dict(bs=bs, nh_k=NH_K, d=D_HEAD, M=M, C=C, Lt=8, N_max=32, OK=O, OV=O)
    jcache = j_init_state(JPQCfg(dtype=jnp.float32, **kw), L)
    tcache = init_state(PQCacheConfig(dtype=torch.float32, **kw), L, device="cpu")
    want, _ = jl.prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jcache, {k: jnp.asarray(v) for k, v in c.items()},
                         mode="pq", distort_recent=True, return_hidden=True)
    got = tl.prefill(tp, TCFG, torch.from_numpy(ids), tcache, convert.cents_from_numpy(c, device="cpu"),
                     mode="pq", distort_recent=True, return_hidden=True)
    assert got.shape == (bs, n, TCFG.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HIDDEN_TOL)
    # the distortion moved the hidden states, and the cache holds the same counts either way
    exact = tl.prefill(tp, TCFG, torch.from_numpy(ids), init_state(PQCacheConfig(dtype=torch.float32, **kw), L,
                                                                     device="cpu"),
                       convert.cents_from_numpy(c, device="cpu"), mode="pq", return_hidden=True)
    assert float((exact - got).abs().max()) > 10 * HIDDEN_TOL
    assert (tcache["n_codes"], tcache["r"]) == (20, 3)


def test_plain_encode_route_matches(rng, tiny_params):
    """use_kernel=False takes the encode's plain version: on the CPU the same codes."""
    _, tp = tiny_params
    c = convert.cents_from_numpy(random_cents(rng, 8, 64, 0), device="cpu")
    ids = torch.from_numpy(rng.integers(0, 256, (1, 16)))
    kw = dict(bs=1, nh_k=NH_K, d=D_HEAD, M=8, C=64, Lt=8, N_max=16, dtype=torch.float32)
    a, b = (tl.prefill(tp, TCFG, ids, init_state(PQCacheConfig(**kw), L, device="cpu"), c,
                       distort_recent=True, return_hidden=True, use_kernel=u) for u in (True, False))
    assert torch.equal(a, b)


def test_nll_from_hidden_matches_full_logits(rng, tiny_params):
    """Chunked projection with a short last chunk equals the full-logit NLL."""
    _, tp = tiny_params
    x = torch.from_numpy(rng.standard_normal((2, 37, TCFG.hidden_size)).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, 256, (2, 36)))
    logp = torch.log_softmax(tl._logits(tp, TCFG, x[:, :36]), -1)
    want = -logp.gather(-1, tgt[..., None]).sum()
    for chunk in (5, 36, 64):
        got = tppl._nll_from_hidden(tp, TCFG, x, tgt, chunk)
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.fixture(scope="module")
def tiny_lm():
    if not checkpoint_path().exists():
        pytest.skip("tiny_lm_v1 checkpoint missing")
    jp, jcfg = j_load(checkpoint_path())
    tp, tcfg = load_checkpoint(checkpoint_path(), device="cpu")
    return jp, jcfg, tp, tcfg


def test_checkpoint_loads_as_the_reference(tiny_lm):
    jp, jcfg, tp, tcfg = tiny_lm
    assert tcfg.head_dim == jcfg.head_dim and tcfg.num_layers == jcfg.num_layers
    assert tcfg.dtype == torch.float32
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(), np.asarray(jp["layers"]["wq"]))
    np.testing.assert_array_equal(tp["lm_head"].numpy(), np.asarray(jp["lm_head"]))


def test_sample_kv_matches_jax(tiny_lm):
    jp, jcfg, tp, tcfg = tiny_lm
    tokens = build_corpus_frozen()
    jk_, jv_ = jql.sample_kv(jp, jcfg, tokens, windows=2, ctx=128, bs=2)
    tk_, tv_ = tql.sample_kv(tp, tcfg, tokens, windows=2, ctx=128, bs=2)
    assert tk_.dtype == np.float16 and tk_.shape == jk_.shape == (2, 2 * 2 * 128, 32)
    for got, want in ((tk_, jk_), (tv_, jv_)):  # f16 rows: one rounding step apart at most
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3, atol=2e-3)


def test_perplexity_matches_jax(tiny_lm):
    jp, jcfg, tp, tcfg = tiny_lm
    tokens = build_corpus_frozen()
    kv_k, kv_v = jql.sample_kv(jp, jcfg, tokens, windows=2, ctx=512, bs=2)
    c = {"key": np.stack([np.asarray(j_train_pq(jnp.asarray(kv_k[l]), 16, 8, 4, l, "strided"))
                          for l in range(2)]),
         "value": np.stack([np.asarray(j_train_pq(jnp.asarray(kv_v[l]), 16, 8, 4, 100 + l, "strided"))
                            for l in range(2)])}
    eval_tokens = tokens[-2 * 512:]
    kw = dict(bs=1, nh_k=2, d=32, M=16, C=256, Lt=64, N_max=512)
    want = jppl.perplexity(jp, jcfg, eval_tokens, lambda: j_init_state(JPQCfg(dtype=jnp.float32, **kw), 2),
                           {k: jnp.asarray(v) for k, v in c.items()}, mode="pq", max_length=512)
    tcents = convert.cents_from_numpy(c, device="cpu")
    for mode in ("pq", "pq_kernel"):
        got = tppl.perplexity(tp, tcfg, eval_tokens,
                              lambda: init_state(PQCacheConfig(dtype=torch.float32, **kw), 2, device="cpu"),
                              tcents, mode=mode, max_length=512)
        assert got["windows"] == want["windows"] == 2
        assert abs(got["ppl"] - want["ppl"]) <= PPL_RTOL * want["ppl"], (mode, got, want)
    dense_j = jppl.perplexity(jp, jcfg, eval_tokens,
                              lambda: j_init_dense(JDenseCfg(bs=1, nh_k=2, d=32, N_max=512, dtype=jnp.float32), 2),
                              None, mode="dense", max_length=512, distort_recent=False)
    dense_t = tppl.perplexity(tp, tcfg, eval_tokens,
                              lambda: init_dense_state(DenseCacheConfig(bs=1, nh_k=2, d=32, N_max=512,
                                                                        dtype=torch.float32), 2, device="cpu"),
                              None, mode="dense", max_length=512, distort_recent=False)
    assert abs(dense_t["ppl"] - dense_j["ppl"]) <= DENSE_RTOL * dense_j["ppl"]
    assert got["ppl"] != dense_t["ppl"]  # the distortion reached the loss
    with pytest.raises(ValueError):
        tppl.perplexity(tp, tcfg, eval_tokens[:100], None, None, max_length=512)

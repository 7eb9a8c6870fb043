"""Wide int16 codes (C > 256, nbits 9-12) in the port against million_tpu.

The inputs are made with numpy from a seed and handed to both packages. On
the CPU every check runs the port's plain versions:
  * the int16 arena and its reads, codes of 32,768 and more included (read
    back unsigned, as million_tpu's take wraps a negative int16 index);
  * convert between the two packages' int16 arenas (exact);
  * the encode at C = 512, 1024 and 4096 against million_tpu's jnp encode
    (bit-equal on integer inputs, the agreement thresholds of
    tests/test_torch_encode_kernel.py on random ones) and against its fused
    Pallas encode in interpret mode at C = 512; encode_route over C 257 to
    65,536 and d_m 1 to 128;
  * one Lloyd step from the same centroids (codes equal, centroids within
    1e-5 on well-separated data) and train_pq's reconstruction error within
    2 % of million_tpu's (the two k-means++ inits differ);
  * test-tiny at M = 8, C = 512, Lt = 8: greedy generate equal tokens and
    step logits within 1e-4 of million_tpu's mode "pq", across flushes; the
    chunked prefill against million_tpu's chunked prefill within 1e-4 (its
    jnp history partial, which unpacks 8-bit words, replaced by one that
    reads int16 codes); save_cache / load_cache of an int16 cache;
  * the ladder's nbits 9 rung on million_tpu-trained tables within 1e-4 of
    million_tpu's perplexity, quality_bench on million_tpu-trained tables
    (rel_mse and attn_mae within 1e-5, the rounding of the printed numbers)
    and with its own k-means (within QB_OWN_RTOL), the native trainer at
    nbits 9 bit-equal to million_tpu's, the CLI's four stages at nbits 9.
Tests marked `cuda` hold the encode kernel's wide build against its plain
version on the card and skip without one."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import million_tpu.pq.kmeans  # noqa: F401  (million_tpu.pq re-exports a function named kmeans)
from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import chunked_prefill as jcp
from million_tpu.models import llama as jl
from million_tpu.ops.pq_encode_pallas import pq_encode_fused as jax_fused
from million_tpu.pq.ops import pq_decode as jax_decode, pq_encode as jax_encode
from million_tpu.runtime.generate import generate as j_generate
from million_tpu.runtime.sampling import SamplingConfig as JSampling
from million_tpu_torch import convert
from million_tpu_torch.cache import pq_cache as tpc
from million_tpu_torch.models import chunked_prefill as tcp
from million_tpu_torch.models import llama as tl
from million_tpu_torch.ops import pq_encode_kernel as E
from million_tpu_torch.pq import kmeans as tk
from million_tpu_torch.pq import ops as tops
from million_tpu_torch.runtime import checkpoint
from million_tpu_torch.runtime.generate import generate

jk = sys.modules["million_tpu.pq.kmeans"]

JCFG = dataclasses.replace(jl.PRESETS["test-tiny"], num_layers=2)
TCFG = dataclasses.replace(tl.PRESETS["test-tiny"], num_layers=2)
L, D_HEAD, NH_K = JCFG.num_layers, JCFG.head_dim, JCFG.num_kv_heads
M, C, LT, N_MAX = D_HEAD // 2, 512, 8, 128
ENCODE_THRESHOLDS = {"exact": (0.999, 1e-4), "fast": (0.98, 2e-3)}  # tests/test_torch_encode_kernel.py
LOGIT_TOL = 1e-4
# quality_bench trained by each package's own k-means (different k-means++ draws) against
# million_tpu's numbers on the same vectors (QB, 25 Lloyd steps): over seeds 0-4 the largest of the
# 60 relative gaps was 22.4 % (attn_mae, which 16 queries over 2,048 keys make noisy; rel_mse
# 9.5 %), 18.8 % at seed 0; the limit is 1.5 x the largest
QB_OWN_RTOL = 0.35


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def one_thread():
    """torch on one intra-op thread for the k-means tests: under pytest-xdist
    every worker takes a thread per core by default, and the oversubscribed
    CPU slows the k-means++ draws tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, convert.params_from_numpy(tree, torch.float32, device="cpu")


def wide_cents(rng, C=C):
    c = {s: rng.standard_normal((L, M, C, D_HEAD // M)).astype(np.float32) for s in ("key", "value")}
    return {k: jnp.asarray(v) for k, v in c.items()}, convert.cents_from_numpy(c, device="cpu")


def caches(bs=1, C=C):
    j = j_init_state(JPQCfg(bs=bs, nh_k=NH_K, d=D_HEAD, M=M, C=C, Lt=LT, N_max=N_MAX, dtype=jnp.float32), L)
    t = tpc.init_state(tpc.PQCacheConfig(bs=bs, nh_k=NH_K, d=D_HEAD, M=M, C=C, Lt=LT, N_max=N_MAX,
                                         dtype=torch.float32), L, device="cpu")
    return j, t


def assert_arenas_equal(jc, tc):
    conv = convert.pq_cache_from_numpy({k: np.asarray(v) for k, v in jc.items()}, device="cpu")
    assert (conv["n_codes"], conv["r"]) == (tc["n_codes"], tc["r"])
    for k in ("key_codes", "value_codes"):
        assert conv[k].dtype == tc[k].dtype == torch.int16
        np.testing.assert_array_equal(conv[k].numpy(), tc[k].numpy(), err_msg=k)


# --- storage --------------------------------------------------------------------------------------

def test_store_load_int16_codes_above_32767(rng):
    """An int16 arena holds codes up to 65,535 as bit patterns; the port's
    reads (code_index, pq_decode, lut_scores) take them unsigned and agree
    with million_tpu's decode of the same int16 codes."""
    assert tpc.wide_codes(512) and not tpc.wide_codes(256)
    with pytest.raises(ValueError):
        tpc.wide_codes(65537)
    cfg = tpc.PQCacheConfig(bs=1, nh_k=2, d=4, M=2, C=65536, Lt=4, N_max=16)
    cache = tpc.init_state(cfg, 1, device="cpu")
    assert cache["key_codes"].dtype == cache["value_codes"].dtype == torch.int16
    mem = tpc.cache_memory_bytes(cfg, 1)
    assert mem["codes"] == 2 * tpc.cache_memory_bytes(dataclasses.replace(cfg, C=256), 1)["codes"]
    codes = rng.integers(0, 65536, (1, 2, 8, 2))
    codes[0, 0, 0] = (32768, 65535)
    stored = torch.from_numpy(codes.astype(np.uint16).view(np.int16))
    tpc.stacked_prefix_write(cache, 0, stored, stored, None, None)
    got = tops.code_index(cache["key_codes"][0, :, :, :8])
    np.testing.assert_array_equal(got.numpy(), codes)
    cents = rng.standard_normal((2, 65536, 2)).astype(np.float32)
    want = jax_decode(jnp.asarray(stored.numpy()), jnp.asarray(cents), "strided")
    np.testing.assert_array_equal(tops.pq_decode(stored, _t(cents), "strided").numpy(), np.asarray(want))
    lut = torch.from_numpy(rng.standard_normal((2, 65536)).astype(np.float32))
    s = tops.lut_scores(lut, stored[0, 0])
    np.testing.assert_allclose(s.numpy(), lut.numpy()[[0, 1], codes[0, 0]].sum(-1), rtol=1e-6)


def test_convert_round_trips_int16_arenas(rng, params):
    """A million_tpu wide cache after a prefill carries over to the port and
    back bit for bit; its int16 arena is (..., M, N) there and (..., N, M)
    here."""
    jp, _ = params
    jcents, _ = wide_cents(rng)
    jc, _ = caches()
    _, jc = jl.prefill(jp, JCFG, jnp.asarray(rng.integers(0, JCFG.vocab_size, (1, 13)), jnp.int32), jc,
                       jcents, mode="pq")
    jnp_cache = {k: np.asarray(v) for k, v in jc.items()}
    conv = convert.pq_cache_from_numpy(jnp_cache, device="cpu")
    for k in ("key_codes", "value_codes"):
        assert jnp_cache[k].dtype == np.int16 and conv[k].dtype == torch.int16
        assert conv[k].shape == (L, 1, NH_K, N_MAX, M)
        back = convert.arena_to_numpy(conv[k])
        assert back.dtype == np.int16
        np.testing.assert_array_equal(back, jnp_cache[k])
    assert conv["n_codes"] == 12 and conv["r"] == 1
    words = rng.integers(-2**31, 2**31, (2, 3, 4, 5), dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(convert.arena_to_numpy(torch.from_numpy(convert.arena_from_words(words))), words)


# --- encode ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("Cw", [512, 1024, 4096])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_plain_encode_matches_jax(rng, Cw, precision):
    """The port's encode (plain on the CPU) against million_tpu's jnp encode:
    int16 codes, at the agreement thresholds of the 8-bit tests."""
    Mw, dm = 4, 2
    x = rng.standard_normal((3, 100, Mw * dm)).astype(np.float32)
    cents = rng.standard_normal((Mw, Cw, dm)).astype(np.float32)
    got = E.pq_encode_fused(_t(x), _t(cents), "strided", precision)
    assert got.dtype == torch.int16 and got.shape == (3, 100, Mw)
    want = np.asarray(jax_encode(jnp.asarray(x), jnp.asarray(cents), "strided", precision=precision))
    assert want.dtype == np.int32
    agree_min, mse_rtol = ENCODE_THRESHOLDS[precision]
    got = tops.code_index(got).numpy()
    assert (got == want).mean() >= agree_min
    rec = lambda c: tops.pq_decode(_t(c), _t(cents), "strided").numpy()  # noqa: E731
    err_g, err_w = (float(((rec(c) - x) ** 2).mean()) for c in (got, want))
    assert abs(err_g - err_w) <= mse_rtol * err_w


@pytest.mark.parametrize("Cw", [512, 1024, 4096])
def test_integer_inputs_equal_codes(rng, Cw):
    """Integer-valued inputs: every sum is exact, so the port's plain encode,
    million_tpu's jnp encode and its fused encode agree code for code, ties
    to the lowest index."""
    Mw, dm = 4, 2
    x = rng.integers(-4, 5, (64, Mw * dm)).astype(np.float32)
    cents = rng.integers(-4, 5, (Mw, Cw, dm)).astype(np.float32)
    got = tops.code_index(E.pq_encode_fused(_t(x), _t(cents), "strided", "fast")).numpy()
    for precision in ("fast", "exact"):
        want = np.asarray(jax_encode(jnp.asarray(x), jnp.asarray(cents), "strided", precision=precision))
        np.testing.assert_array_equal(got, want)


def test_plain_encode_matches_jax_fused_interpret(rng):
    """Against million_tpu's fused Pallas encode in interpret mode at C = 512
    (it stages the whole codebook and returns int32 codes above 256)."""
    Mw, dm = 8, 2
    x = rng.standard_normal((64, Mw * dm)).astype(np.float32)
    cents = rng.standard_normal((Mw, C, dm)).astype(np.float32)
    for precision in ("fast", "exact"):
        want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(cents), "strided", precision=precision,
                                    interpret=True))
        got = tops.code_index(E.pq_encode_fused(_t(x), _t(cents), "strided", precision)).numpy()
        assert (got == want).mean() >= ENCODE_THRESHOLDS[precision][0]


def test_encode_route_takes_every_wide_geometry():
    """C 257..65,536 at every d_m 1..128 goes to the wide build, with no card;
    what no build takes raises."""
    for Cw in (257, 300, 512, 1024, 4096, 32768, 65536):
        for dm in range(1, 129):
            assert E.encode_route(dm, Cw) == "wide"
    assert E.encode_route(2, 256) == "tiled" and E.encode_route(32, 256) == "generic"
    for bad in ((2, 65537), (2, 0), (0, 512), (227, 512)):
        with pytest.raises(ValueError):
            E.encode_route(*bad)


def test_plain_wide_encode_banks_and_empty(rng):
    """Stacked banks, a strided view and an empty input keep int16 codes."""
    cents = rng.standard_normal((3, 4, 1024, 2)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((3, 2, 10, 8)).astype(np.float32)).transpose(1, 2)
    got = E.pq_encode_fused_stacked(x, _t(cents), "strided")
    for s in range(3):
        np.testing.assert_array_equal(got[s].numpy(), E.pq_encode_fused(x[s], _t(cents[s]), "strided").numpy())
    empty = E.pq_encode_fused_stacked(x[:, :0], _t(cents), "strided")
    assert empty.shape == (3, 0, 2, 4) and empty.dtype == torch.int16


# --- k-means --------------------------------------------------------------------------------------

def test_lloyd_step_matches_jax(rng, one_thread):
    """One Lloyd step at C = 512 from the same centroids: assignments equal
    and updated centroids and counts within 1e-5 of million_tpu's _assign +
    _update, subspace by subspace. The rows lie around 512 centres and the
    step starts near them, so no row is near a tie (f32 sums in another
    order)."""
    Mw, dm, n, Cw = 2, 2, 4096, 512
    centres = rng.uniform(-20, 20, (Mw, Cw, dm))
    labels = rng.integers(0, Cw, (n, Mw))
    x = (centres[np.arange(Mw), labels] + 0.02 * rng.standard_normal((n, Mw, dm))).reshape(n, -1)
    x = x.astype(np.float32)
    xs = tops.subspace_view(_t(x), Mw).contiguous()
    init = (centres + 0.01 * rng.standard_normal(centres.shape)).astype(np.float32)
    codes = tk.assign(xs, _t(init))
    assert codes.dtype == torch.int16
    new, counts = tk._update(xs, codes, Cw)
    for m in range(Mw):
        xm = jnp.asarray(x[:, m * dm:(m + 1) * dm])
        a = jk._assign(xm, jnp.asarray(init[m]))
        np.testing.assert_array_equal(tops.code_index(codes[:, m]).numpy(), np.asarray(a))
        want, want_counts = jk._update(xm, a, Cw)
        np.testing.assert_allclose(new[m].numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(counts[m].numpy(), np.asarray(want_counts))


def test_train_pq_close_to_jax(rng, one_thread):
    """train_pq at nbits 9 end to end from each package's own k-means++
    draws: reconstruction error within 2 % of million_tpu's."""
    Mw, n = 4, 4096
    x = rng.standard_normal((n, 8)).astype(np.float32)
    got = tk.train_pq(_t(x), Mw, nbits=9, iters=5, layout="strided")
    want = jk.train_pq(jnp.asarray(x), Mw, nbits=9, iters=5, layout="strided")
    err = lambda c: float(((tops.pq_decode(tops.pq_encode(_t(x), c, "strided"), c, "strided").numpy()  # noqa
                            - x) ** 2).sum())
    e_got, e_want = err(got), err(torch.from_numpy(np.array(want)))
    assert abs(e_got - e_want) <= 0.02 * e_want, (e_got, e_want)


def test_native_trainer_nbits9_matches_jax(rng):
    """The port's native trainer (csrc/pqlib.cpp) at nbits 9 gives million_tpu's
    native codebooks bit for bit: the same C++ source."""
    from million_tpu import native as jnative
    from million_tpu_torch import native as tnative

    if not (tnative.native_available() and jnative.native_available()):
        pytest.skip("no C++ compiler for the native library")
    x = rng.standard_normal((2048, 16)).astype(np.float32)
    got = tnative.train_pq_native(x, 8, nbits=9, iters=3, layout="strided")
    want = jnative.train_pq_native(x, 8, nbits=9, iters=3, layout="strided")
    assert got.shape == (8, 512, 2)
    np.testing.assert_array_equal(got, want)


# --- model ----------------------------------------------------------------------------------------

def test_attention_route_reads_the_arena_dtype():
    assert tl.attention_route(torch.int16) == "pq"
    assert tl.attention_route(torch.uint8) == "pq_kernel"
    assert tl.attention_route(torch.int16, "dense") == "dense"
    _, tc = caches()
    assert tl.attention_route(tc["key_codes"].dtype) == "pq"


def test_generate_matches_jax(rng, params):
    """test-tiny, 2 layers, M = 8, C = 512, Lt = 8, a 12-token prompt and 16
    greedy tokens: the port's "pq_kernel" (the "pq" route on int16 codes)
    against million_tpu's generate(mode="pq"): equal tokens, flushes past
    the prompt; then the same tokens teacher-forced step by step, logits
    within 1e-4 and the arenas equal after every flush."""
    jp, tp = params
    jcents, tcents = wide_cents(rng)
    ids = rng.integers(0, JCFG.vocab_size, (1, 12))
    jc, tc = caches()
    rj, jc_out = j_generate(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, mode="pq",
                            max_new_tokens=16, sampling=JSampling(temperature=0.0))
    rt, tc = generate(tp, TCFG, torch.from_numpy(ids), tc, tcents, mode="pq_kernel", max_new_tokens=16,
                      device="cpu", selfcheck_every=4)
    np.testing.assert_array_equal(rt.tokens, np.asarray(rj.tokens))
    assert tc["key_codes"].dtype == torch.int16 and int(np.asarray(jc_out["n_codes"])[0]) > 12
    assert rt.n_flushes >= 1 and tc["n_codes"] == 12 + LT * rt.n_flushes
    assert rt.selfcheck_max_diff == 0.0  # both modes take the same plain route
    # teacher-forced: the same tokens through decode_step, step logits
    jc, tc = caches()
    lj, jc = jl.prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, mode="pq")
    lt = tl.prefill(tp, TCFG, torch.from_numpy(ids), tc, tcents, mode="pq")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL)
    flushes = 0
    for t, tok in enumerate(rt.tokens[0, :-1]):
        if tc["r"] >= LT:
            jc = jl.flush_windows(jc, jcents)
            tl.flush_windows(tc, tcents)
            flushes += 1
            assert_arenas_equal(jc, tc)
        lj, jc = jl.decode_step(jp, JCFG, jnp.asarray([tok], jnp.int32), jnp.asarray(12 + t, jnp.int32), jc,
                                jcents, mode="pq")
        lt = tl.decode_step(tp, TCFG, torch.tensor([int(tok)]), 12 + t, tc, tcents, mode="pq_kernel")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL, err_msg=f"step {t}")
    assert flushes >= 1


def _wide_history_partial(q, key_codes, value_codes, kcent, vcent, n_prev, scale, nb, hist_block):
    """million_tpu's jnp history partial for an int16 arena: its own
    _history_partial unpacks the arena as int32 words of four 8-bit codes
    (models/chunked_prefill.py:148-190), which an int16 arena is not. This
    one reads the codes with million_tpu's load_codes_t, decodes them with
    its pq_decode and takes the same f32 softmax over the first n_prev
    tokens."""
    from million_tpu.cache.pq_cache import load_codes_t
    from million_tpu.ops.pq_attention_ref import _gqa_expand

    nh = q.shape[1]
    dec = lambda c, cents: jax_decode(jnp.swapaxes(load_codes_t(c), -1, -2), cents, "strided")  # noqa: E731
    kf, vf = (_gqa_expand(dec(c, cents), nh) for c, cents in ((key_codes, kcent), (value_codes, vcent)))
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32) * scale, kf)
    s = jnp.where((jnp.arange(kf.shape[2]) < n_prev)[None, None, None], s, -1e30)
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    return jnp.einsum("bhqk,bhkd->bhqd", p, vf) / l, (m + jnp.log(l))[..., 0]


def test_chunked_prefill_matches_jax(rng, params, monkeypatch):
    """Chunks of 8 over a 30-token prompt at C = 512: the port's chunked
    prefill (the plain history route on int16 codes) against million_tpu's
    chunked prefill within 1e-4, the arenas equal, and a decode step that
    continues from it. million_tpu's own jnp history cannot read an int16
    arena (it unpacks 8-bit words), so its history partial is replaced by
    _wide_history_partial; the rest of its chunked prefill runs as it is."""
    monkeypatch.setattr(jcp, "_history_partial", _wide_history_partial)
    jp, tp = params
    jcents, tcents = wide_cents(rng)
    ids = rng.integers(0, JCFG.vocab_size, (2, 30))
    jc, tc = caches(bs=2)
    lj, jc = jcp.chunked_prefill(jp, JCFG, jnp.asarray(ids, jnp.int32), jc, jcents, chunk=8, use_kernel=False)
    lt, tc = tcp.chunked_prefill(tp, TCFG, torch.from_numpy(ids), tc, tcents, chunk=8)
    assert (tc["n_codes"], tc["r"]) == (28, 2)
    assert_arenas_equal(jc, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL)
    tok = rng.integers(0, JCFG.vocab_size, (2,))
    lj, _ = jl.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32), jnp.asarray(30, jnp.int32), jc, jcents,
                           mode="pq")
    lt = tl.decode_step(tp, TCFG, torch.from_numpy(tok), 30, tc, tcents, mode="pq_kernel")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL)


def test_checkpoint_round_trips_int16_cache(rng, params, tmp_path):
    _, tp = params
    _, tcents = wide_cents(rng, C=1024)
    _, tc = caches(C=1024)
    tl.prefill(tp, TCFG, torch.from_numpy(rng.integers(0, TCFG.vocab_size, (1, 21))), tc, tcents, mode="pq")
    tc["key_codes"][0, 0, 0, 0, 0] = -1  # the bit pattern of code 65,535
    checkpoint.save_cache(str(tmp_path / "c.npz"), tc, pos=21)
    back, pos = checkpoint.load_cache(str(tmp_path / "c.npz"), device="cpu")
    assert pos == 21 and (back["n_codes"], back["r"]) == (20, 1)
    for k, v in tc.items():
        if torch.is_tensor(v):
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


# --- quality --------------------------------------------------------------------------------------

def test_ladder_rung_on_jax_tables(rng, one_thread):
    """million_tpu-trained nbits 9 tables (M = d/2 on the pinned tiny_lm_v1)
    through the port's ladder rung: perplexity within 1e-4 of million_tpu's
    own perplexity of the same tables."""
    from million_tpu.benchmarks.perplexity import perplexity as j_perplexity
    from million_tpu.benchmarks.quality_ladder import sample_kv as j_sample_kv, train_cents as j_train_cents
    from million_tpu.benchmarks.tiny_lm import load_checkpoint as j_load
    from million_tpu_torch.benchmarks import quality_ladder as tql
    from million_tpu_torch.benchmarks.tiny_lm import build_corpus, checkpoint_path, load_checkpoint

    if not checkpoint_path().exists():
        pytest.skip("tiny_lm_v1 checkpoint missing")
    jparams, jcfg = j_load(checkpoint_path())
    tparams, tcfg = load_checkpoint(checkpoint_path(), device="cpu")
    tokens = build_corpus()
    kv_k, kv_v = j_sample_kv(jparams, jcfg, tokens[:4 * 256], windows=4, ctx=256, bs=4)
    Mq = jcfg.head_dim // 2
    cents = {"key": j_train_cents(kv_k, Mq, 9, iters=2)[0], "value": j_train_cents(kv_v, Mq, 9, iters=2, seed=100)[0]}
    ev = tokens[-4 * 256:]
    pqc = JPQCfg(bs=1, nh_k=jcfg.num_kv_heads, d=jcfg.head_dim, M=Mq, M_v=Mq, C=512, Lt=64, N_max=256,
                 dtype=jcfg.dtype)
    want = j_perplexity(jparams, jcfg, ev, lambda: j_init_state(pqc, jcfg.num_layers), cents, mode="pq",
                        max_length=256, distort_recent=True, max_windows=2)["ppl"]
    got = tql.rung_perplexity(tparams, tcfg, ev, convert.cents_from_numpy(
        {k: np.asarray(v) for k, v in cents.items()}, device="cpu"), max_length=256, max_windows=2)["ppl"]
    assert abs(got - want) <= 1e-4 * want, (got, want)


QB = dict(n=2048, d=32, n_queries=16, iters=25, seed=0)


@pytest.fixture(scope="module")
def jax_quality_bench():
    """million_tpu's quality_bench main at QB, its printed JSON line."""
    import contextlib
    import io

    from million_tpu.benchmarks import quality_bench as jqb

    argv = ["quality_bench", "--n", str(QB["n"]), "--d", str(QB["d"]), "--n-queries", str(QB["n_queries"]),
            "--iters", str(QB["iters"]), "--seed", str(QB["seed"])]
    out, old = io.StringIO(), sys.argv
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            jqb.main()
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_quality_bench_on_jax_tables(jax_quality_bench, one_thread):
    """The port's quality_bench with million_tpu's k-means tables: the same
    synthetic K/V (numpy, one seed) and the same JSON line, every rel_mse
    and attn_mae within 1e-5 (the rounding of the printed numbers)."""
    from million_tpu_torch.benchmarks import quality_bench as tqb

    def jax_tables(x, Mq, nbits):
        return np.asarray(jk.train_pq(jnp.asarray(x), M=Mq, nbits=nbits, iters=QB["iters"], layout="strided",
                                      seed=QB["seed"]))

    got = tqb.sweep(device="cpu", tables=jax_tables, **QB)
    want = jax_quality_bench
    assert set(got) == set(want) and got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert [(r["M"], r["nbits"], r["M_v"], r["nbits_v"]) for r in got["sweep"]] == \
        [(r["M"], r["nbits"], r["M_v"], r["nbits_v"]) for r in want["sweep"]] == \
        [tuple(c) for c in tqb.combos(QB["d"])]
    assert (QB["d"] // 4, 10) in [(r["M"], r["nbits"]) for r in got["sweep"]]
    for g, w in zip(got["sweep"], want["sweep"]):
        assert abs(g["rel_mse"] - w["rel_mse"]) <= 1.01e-5 and abs(g["attn_mae"] - w["attn_mae"]) <= 1.01e-5, (g, w)


def test_quality_bench_own_training(jax_quality_bench, one_thread):
    """The port's quality_bench with its own k-means against million_tpu's
    numbers: within QB_OWN_RTOL (the two draw different k-means++ inits)."""
    from million_tpu_torch.benchmarks import quality_bench as tqb

    got = tqb.sweep(device="cpu", **QB)
    for g, w in zip(got["sweep"], jax_quality_bench["sweep"]):
        for key in ("rel_mse", "attn_mae"):
            assert abs(g[key] - w[key]) <= QB_OWN_RTOL * w[key], (key, g, w)


def test_cli_pipeline_nbits9(tmp_path, monkeypatch, one_thread):
    """The pipeline's four stages at pq.nbits=9 on test-tiny: the sample
    budget, C = 512 tables, and evaluation rows that name the "pq" route."""
    from pathlib import Path

    from million_tpu_torch import cli as tcli
    from million_tpu_torch.utils.ledger import read_results

    monkeypatch.chdir(tmp_path)
    tiny = str(Path(__file__).resolve().parent.parent / "configs" / "test-tiny.json")
    tcli.main(["-f", tiny, "-p", "baseline", "sampling", "training", "evaluation", "--device", "cpu",
               "-o", f"run.results={tmp_path}/r.jsonl", "-o", f"run.artifacts={tmp_path}/artifacts",
               "-o", "pq.nbits=9", "-o", "pq.sample_target=1024", "-o", "pq.train_samples=1024",
               "-o", "pq.train_iters=2", "-o", "run.prefill_lengths=[64]", "-o", "run.decode_length=8"])
    rows = read_results(tmp_path / "r.jsonl")
    assert [r["stage"] for r in rows] == ["baseline", "evaluation"]
    assert rows[1]["attention_route"] == "pq" and rows[1]["mode"] == "pq_kernel"
    assert rows[1]["result"]["results"][0]["tpot_s"] > 0
    z = np.load(tmp_path / "artifacts/test-tiny/_synthetic/cents_M8_nbits9.npz")
    assert z["key"].shape == (2, 8, 512, 2) and np.isfinite(z["key"]).all()
    cfg = tcli.load_config([tiny], ["pq.nbits=9"], base=tcli.DEFAULTS)
    mcfg = tl.PRESETS[cfg.model.preset]
    assert tcli.sample_budget(cfg, mcfg) == 256 * 512
    assert tcli.pq_cache_config(cfg, mcfg).code_dtype == torch.int16


# --- on the card ----------------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encode kernel's wide build runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Cw", [512, 1024, 4096])
@pytest.mark.parametrize("dm", [1, 2, 4, 8, 16, 32])
def test_cuda_wide_encode_matches_plain(rng, cuda_device, Cw, dm):
    """B7's wide build against its plain version: >= 99.9 % equal codes and
    reconstruction MSE within 1e-4 on random bf16 inputs ("fast"), equal
    codes on integer inputs in both precisions and layouts, a bf16 strided
    view of a (bs, n, heads, d) projection, several banks."""
    Mw = max(128 // dm, 1)
    d = Mw * dm
    x = torch.from_numpy(rng.standard_normal((2, 3, 700, d)).astype(np.float32)).to(torch.bfloat16)
    cents = _t(rng.standard_normal((2, Mw, Cw, dm)).astype(np.float32))
    xv = x.transpose(1, 2)  # (2, 700, 3, d) view
    xd, cd = x.to(cuda_device).transpose(1, 2), cents.to(cuda_device)
    want = E.pq_encode_fused_plain(xd, cd, "strided", "fast").cpu()
    got = E.pq_encode_fused_stacked(xd, cd, "strided", "fast")
    torch.cuda.synchronize()
    assert got.dtype == torch.int16
    got = got.cpu()
    assert (got == want).float().mean() >= 0.999
    for s in range(2):
        rec = lambda c: tops.pq_decode(c, cents[s], "strided")  # noqa: E731
        err_g, err_w = ((rec(c[s]) - xv[s].float()).square().mean() for c in (got, want))
        assert abs(float(err_g - err_w)) <= 1e-4 * float(err_w)
    xi = _t(rng.integers(-4, 5, (1, 333, d)).astype(np.float32))
    ci = _t(rng.integers(-4, 5, (1, Mw, Cw, dm)).astype(np.float32))
    for layout in ("strided", "contiguous"):
        for precision in ("fast", "exact"):
            xid, cid = xi.to(cuda_device), ci.to(cuda_device)
            np.testing.assert_array_equal(E.pq_encode_fused_stacked(xid, cid, layout, precision).cpu().numpy(),
                                          E.pq_encode_fused_plain(xid, cid, layout, precision).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("d,Mw,Cw", [(24, 12, 300), (20, 5, 257), (40, 10, 1000), (18, 6, 513), (36, 6, 700),
                                     (128, 1, 2048)],
                         ids=["partial-group-dm2", "partial-group-dm4", "dm4-C1000", "generic-dm3",
                              "generic-dm6", "generic-dm128"])
def test_cuda_wide_encode_odd_geometries(rng, cuda_device, d, Mw, Cw):
    """B7's wide build where a group of 32 dims holds fewer subspaces than it
    could (M % (32 / d_m) != 0), at codebook sizes that are not whole chunks
    and at generic widths (3, 6, 128): equal codes on integer inputs,
    >= 99.9 % on random ones, both layouts."""
    dm = d // Mw
    x = torch.from_numpy(rng.standard_normal((2, 900, d)).astype(np.float32)).to(cuda_device)
    cents = torch.from_numpy(rng.standard_normal((2, Mw, Cw, dm)).astype(np.float32)).to(cuda_device)
    for layout in ("strided", "contiguous"):
        got = E.pq_encode_fused_stacked(x, cents, layout, "fast")
        assert got.dtype == torch.int16
        assert float((got == E.pq_encode_fused_plain(x, cents, layout, "fast")).float().mean()) >= 0.999
    xi = torch.from_numpy(rng.integers(-4, 5, (2, 500, d)).astype(np.float32)).to(cuda_device)
    ci = torch.from_numpy(rng.integers(-4, 5, (2, Mw, Cw, dm)).astype(np.float32)).to(cuda_device)
    for layout in ("strided", "contiguous"):
        np.testing.assert_array_equal(E.pq_encode_fused_stacked(xi, ci, layout, "exact").cpu().numpy(),
                                      E.pq_encode_fused_plain(xi, ci, layout, "exact").cpu().numpy())


@pytest.mark.cuda
def test_cuda_wide_encode_codes_above_32767(rng, cuda_device):
    """C = 65,536 with the first half of every codebook far away: every code
    lands at 32,768 or above (an int16 bit pattern), ties among the many equal
    integer centroids to the lowest index, as the plain version has them."""
    Mw, dm = 8, 4
    xi = torch.from_numpy(rng.integers(-4, 5, (1, 700, Mw * dm)).astype(np.float32)).to(cuda_device)
    ci = rng.integers(-4, 5, (1, Mw, 65536, dm)).astype(np.float32)
    ci[:, :, :32768] = 100.0
    ci = torch.from_numpy(ci).to(cuda_device)
    got = E.pq_encode_fused_stacked(xi, ci, "strided", "exact")
    np.testing.assert_array_equal(got.cpu().numpy(), E.pq_encode_fused_plain(xi, ci, "strided", "exact").cpu().numpy())
    assert int(tops.code_index(got).min()) >= 32768


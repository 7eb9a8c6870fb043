"""The flat cache's single-layer helpers (cache/pq_cache.py: init_layer_state,
prefill_update, decode_update, flush_window) against million_tpu's
(million_tpu/cache/pq_cache.py:165,194,239).

Both packages get the same f32 K/V and codebooks (numpy, from the seed): a
prefill of n tokens with n % 4 in {0, 1, 3}, then decode tokens one at a time
across a full-window flush, at C = 32 (uint8 codes) and C = 512 (int16). Held: the residual windows equal, r and n_codes
equal, codes equal on >= 99 % (both encode "fast", bf16-rounded; a tie may
fall the other way), and the attention over the resulting cache (the codes
partial LSE-merged with the r live residual rows) within 1e-4, each package
through its own f32 oracle on its own cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache import pq_cache as jc
from million_tpu.ops.pq_attention_ref import pq_decode_attention_ref as jax_ref
from million_tpu_torch import convert
from million_tpu_torch.cache import pq_cache as tc
from million_tpu_torch.ops.pq_attention_kernel import pq_codes_attention

BS, NH_K, G, D, M, C, LT, N_MAX = 2, 2, 2, 16, 8, 32, 8, 64


def configs(C=C):
    kw = dict(bs=BS, nh_k=NH_K, d=D, M=M, C=C, Lt=LT, N_max=N_MAX)
    return jc.PQCacheConfig(**kw, dtype=jnp.float32), tc.PQCacheConfig(**kw, dtype=torch.float32)


def compare(jst, tst, cents, q):
    words = {k: convert.arena_from_numpy(np.asarray(jst[k])) for k in ("key_codes", "value_codes")}
    for k in ("key_residual", "value_residual"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    assert (tst["n_codes"], tst["r"]) == (int(jst["n_codes"]), int(jst["r"]))
    n = tst["n_codes"]
    for k in ("key_codes", "value_codes"):
        agree = (tst[k][:, :, :n].numpy() == words[k][:, :, :n]).mean() if n else 1.0
        assert agree >= 0.99, f"{k}: agreement {agree}"
    out, _ = pq_codes_attention(torch.from_numpy(q / np.sqrt(D)), tst["key_codes"], tst["value_codes"],
                                torch.from_numpy(cents[0]), torch.from_numpy(cents[1]), n,
                                k_residual=tst["key_residual"], v_residual=tst["value_residual"], r=tst["r"])
    want = jax_ref(jnp.asarray(q.reshape(BS, NH_K * G, D)), jst["key_codes_t"], jst["value_codes_t"],
                   jnp.asarray(cents[0]), jnp.asarray(cents[1]), jst["key_residual"], jst["value_residual"],
                   jst["n_codes"], jst["r"])
    np.testing.assert_allclose(out.reshape(BS, NH_K * G, D).numpy(), np.asarray(want), atol=1e-4)


def with_codes_t(jst):
    """The reference oracle takes unpacked (bs, nh_k, M, N) codes."""
    out = dict(jst)
    for k in ("key_codes", "value_codes"):
        out[k + "_t"] = jc.load_codes_t(jst[k])
    return out


@pytest.mark.parametrize("C", [C, 512])
@pytest.mark.parametrize("n", [12, 13, 15])
def test_prefill_then_decode_across_a_flush(rng, n, C):
    jcfg, tcfg = configs(C)
    cents = [rng.standard_normal((M, C, D // M)).astype(np.float32) for _ in range(2)]
    q = rng.standard_normal((BS, NH_K, G, D)).astype(np.float32)
    k = rng.standard_normal((BS, NH_K, n, D)).astype(np.float32)
    v = rng.standard_normal((BS, NH_K, n, D)).astype(np.float32)
    jst = jc.init_layer_state(jcfg)
    tst = tc.init_layer_state(tcfg, device="cpu")
    jcents = [jnp.asarray(c) for c in cents]
    tcents = [torch.from_numpy(c) for c in cents]
    jst = jc.prefill_update(jst, jnp.asarray(k), jnp.asarray(v), *jcents)
    tst = tc.prefill_update(tst, torch.from_numpy(k), torch.from_numpy(v), *tcents)
    assert (tst["n_codes"], tst["r"]) == (n - n % 4, n % 4)  # the ragged tail stays exact
    compare(with_codes_t(jst), tst, cents, q)
    flushed = False
    for _ in range(LT - n % 4 + 3):  # fills the window, flushes it, and goes on
        flushed |= tst["r"] >= LT
        kt = rng.standard_normal((BS, NH_K, 1, D)).astype(np.float32)
        vt = rng.standard_normal((BS, NH_K, 1, D)).astype(np.float32)
        jst = jc.decode_update(jst, jnp.asarray(kt), jnp.asarray(vt), *jcents)
        tst = tc.decode_update(tst, torch.from_numpy(kt), torch.from_numpy(vt), *tcents)
    assert flushed and tst["n_codes"] == n - n % 4 + LT and tst["r"] == 3
    compare(with_codes_t(jst), tst, cents, q)


def test_flush_window_and_guards(rng):
    _, tcfg = configs()
    cents = [torch.from_numpy(rng.standard_normal((M, C, D // M)).astype(np.float32)) for _ in range(2)]
    st = tc.init_layer_state(tcfg, device="cpu")
    assert st["key_codes"].shape == (BS, NH_K, N_MAX, M) and "key_outliers" not in st
    assert st["key_codes"].dtype == torch.uint8
    assert tc.init_layer_state(configs(512)[1], device="cpu")["key_codes"].dtype == torch.int16
    st["key_residual"].normal_()
    st["value_residual"].normal_()
    st["r"] = LT
    tc.flush_window(st, *cents)
    assert (st["n_codes"], st["r"]) == (LT, 0)
    from million_tpu_torch.pq.ops import runtime_encode

    np.testing.assert_array_equal(st["key_codes"][:, :, :LT].numpy(),
                                  runtime_encode(st["key_residual"], cents[0], "strided").numpy())
    st["n_codes"] = N_MAX - 4
    with pytest.raises(ValueError, match="overflows"):
        tc.flush_window(st, *cents)
    with pytest.raises(ValueError, match="overflows"):
        tc.prefill_update(st, torch.zeros((BS, NH_K, 8, D)), torch.zeros((BS, NH_K, 8, D)), *cents)

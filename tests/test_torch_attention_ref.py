"""million_tpu_torch.ops.pq_attention_ref against million_tpu's on the CPU:
the exact partials, their merges, dense decode and causal prefill attention
(atol 1e-5, f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.ops import pq_attention_ref as J
from million_tpu_torch.ops import pq_attention_ref as T


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("valid", [0, 1, 5, 8])
def test_masked_partial_matches_jax(rng, valid):
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    oj, lj = J.masked_partial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(valid), scale=0.25)
    for arg in (valid, torch.arange(8) < valid):
        ot, lt = T.masked_partial_attention(_t(q), _t(k), _t(v), arg, scale=0.25)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)


def test_merges_match_jax(rng):
    outs = rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
    lses = rng.standard_normal((3, 2, 4)).astype(np.float32) * 3
    lses[1, 0] = -1e30  # an empty partial
    mj, lj = J.merge_partials(jnp.asarray(outs), jnp.asarray(lses), axis=0)
    mt, lt = T.merge_partials(_t(outs), _t(lses), dim=0)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    mj2, lj2 = J.merge_two_partials(*(jnp.asarray(a) for a in (outs[0], lses[0], outs[1], lses[1])))
    mt2, lt2 = T.merge_two_partials(_t(outs[0]), _t(lses[0]), _t(outs[1]), _t(lses[1]))
    np.testing.assert_allclose(mt2.numpy(), np.asarray(mj2), atol=1e-5)
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), atol=1e-5)


def test_dense_and_causal_attention_match_jax(rng):
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    np.testing.assert_allclose(
        T.dense_decode_attention(_t(q), _t(k), _t(v)).numpy(),
        np.asarray(J.dense_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
        atol=1e-5)
    qs = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    np.testing.assert_allclose(
        T.causal_attention(_t(qs), _t(k), _t(v)).numpy(),
        np.asarray(J.causal_attention(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v))),
        atol=1e-5)

"""Parity of million_tpu_torch.pq.ops with million_tpu.pq.ops on the CPU.

The same numpy inputs go through both packages. Encodes are compared by
agreement rate and reconstruction error (near-ties may flip), decode and
LUT values to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.pq import ops as jops
from million_tpu_torch.pq import ops as tops


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("d_m,C", [(2, 64), (4, 32)])
def test_subspace_view_roundtrip(rng, layout, d_m, C):
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    M = 16 // d_m
    want = np.asarray(jops.subspace_view(jnp.asarray(x), M, layout))
    got = tops.subspace_view(_t(x), M, layout)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tops.merge_subspaces(got, layout).numpy(), x)


def _recon_mse(codes, cents, x, layout):
    xh = tops.pq_decode(_t(codes), _t(cents), layout).numpy()
    return float(np.mean((xh - x) ** 2))


@pytest.mark.parametrize("precision,min_agree", [("exact", 0.999), ("fast", 0.99)])
@pytest.mark.parametrize("d_m,C", [(2, 64), (4, 32)])
def test_encode_matches_jax(rng, precision, min_agree, d_m, C):
    d, n = 32, 2048
    M = d // d_m
    x = rng.standard_normal((2, n, d)).astype(np.float32)
    cents = rng.standard_normal((M, C, d_m)).astype(np.float32)
    want = np.asarray(jops.pq_encode(jnp.asarray(x), jnp.asarray(cents), "strided",
                                     precision=precision))
    got = tops.pq_encode(_t(x), _t(cents), "strided", precision=precision).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).mean() >= min_agree
    np.testing.assert_allclose(_recon_mse(got, cents, x, "strided"),
                               _recon_mse(want, cents, x, "strided"), rtol=1e-5)
    chunked = tops.pq_encode_chunked(_t(x), _t(cents), "strided", chunk=300,
                                     precision=precision).numpy()
    np.testing.assert_array_equal(chunked, got)


def test_batched_cents_encode_matches_per_bank(rng):
    L, d, M, C = 3, 16, 8, 32
    x = rng.standard_normal((L, 2, 5, d)).astype(np.float32)
    cents = rng.standard_normal((L, M, C, 2)).astype(np.float32)
    got = tops.pq_encode(_t(x), _t(cents), "strided", batched_cents=True).numpy()
    want = np.asarray(jops.pq_encode(jnp.asarray(x), jnp.asarray(cents), "strided",
                                     batched_cents=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_decode_and_lut_match_jax(rng, layout):
    d, M, C = 32, 8, 64
    cents = rng.standard_normal((M, C, d // M)).astype(np.float32)
    codes = rng.integers(0, C, (2, 3, 40, M)).astype(np.uint8)
    q = rng.standard_normal((2, 3, d)).astype(np.float32)
    np.testing.assert_allclose(
        tops.pq_decode(_t(codes), _t(cents), layout).numpy(),
        np.asarray(jops.pq_decode(jnp.asarray(codes), jnp.asarray(cents), layout)),
        atol=1e-6)
    lut_t = tops.build_lut(_t(q), _t(cents), layout)
    lut_j = jops.build_lut(jnp.asarray(q), jnp.asarray(cents), layout)
    np.testing.assert_allclose(lut_t.numpy(), np.asarray(lut_j), atol=1e-6)
    np.testing.assert_allclose(
        tops.lut_scores(lut_t, _t(codes)).numpy(),
        np.asarray(jops.lut_scores(lut_j, jnp.asarray(codes))), atol=1e-5)


def test_outlier_helpers_match_jax(rng):
    samples = rng.standard_normal((512, 16)).astype(np.float32)
    samples[:, 3] *= 9.0
    samples[:, 11] *= 5.0
    idx_t = tops.select_outlier_channels(_t(samples), 4)
    idx_j = np.asarray(jops.select_outlier_channels(jnp.asarray(samples), 4))
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    z = tops.zero_channels(_t(samples), idx_t)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jops.zero_channels(jnp.asarray(samples), jnp.asarray(idx_j))))
    back = tops.restore_channels(z, _t(samples), idx_t)
    np.testing.assert_array_equal(back.numpy(), samples)

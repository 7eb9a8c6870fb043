"""The port's k-means (million_tpu_torch/pq/kmeans.py) against million_tpu's.

jax.random and torch.Generator draw different points, so the Lloyd loop is
held against the reference from the reference's own k-means++ output: on
well-separated data nothing is near a tie, and the two must end with equal
assignments and centroids within 1e-5 (f32 sums in another order). Trained
end to end from their own inits, the two may only be compared in quality:
reconstruction MSE within 5 % of the reference's. Tests marked `cuda` hold
the encode kernel's assignment against the plain one on the card: final
inertia within 1e-4 relative (the two argmins may split near-ties the other
way, and index_add_ sums in another order)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import million_tpu.pq.kmeans  # noqa: F401  (million_tpu.pq re-exports a function named kmeans)
from million_tpu.pq import ops as jops
from million_tpu_torch.ops import pq_encode_kernel as E
from million_tpu_torch.pq import kmeans as tk
from million_tpu_torch.pq import ops as tops

jk = sys.modules["million_tpu.pq.kmeans"]

CENT_TOL = 1e-5
MSE_RTOL = 0.05
INERTIA_RTOL = 1e-4


def separated(rng, C, k, n, spread=0.05):
    """n points around C well-separated centres in k dims."""
    centres = rng.uniform(-10, 10, (C, k))
    return (centres[rng.integers(0, C, n)] + spread * rng.standard_normal((n, k))).astype(np.float32)


@pytest.mark.parametrize("k,C", [(2, 16), (4, 8)])
@pytest.mark.parametrize("chunk_n", [0, 96], ids=["small_n", "large_n"])
def test_lloyd_from_reference_init(rng, k, C, chunk_n):
    n, iters = 1000, 8
    x = separated(rng, C, k, n)
    key = jax.random.PRNGKey(3)
    init = np.asarray(jk._kmeanspp_init(jnp.asarray(x), key, C))
    want, _ = jk.kmeans(jnp.asarray(x), key, C, iters, chunk_n)
    want = np.asarray(want)
    xs = torch.from_numpy(x)[:, None, :]
    got = tk.lloyd(xs, torch.from_numpy(init)[None], iters, chunk_n=chunk_n)
    np.testing.assert_allclose(got[0].numpy(), want, atol=CENT_TOL)
    codes = tk._assign(xs, got, chunk_n)[:, 0].numpy()
    np.testing.assert_array_equal(codes, np.asarray(jk._assign(jnp.asarray(x), jnp.asarray(want))))
    # the reference's large-n inertia sums ||x||^2 + min(||c||^2 - 2 <x, c>), which cancels
    # at this data's scale: hold the port's to the float64 distance to the reference's centroids
    exact = float(((x.astype(np.float64) - want[codes]) ** 2).sum())
    assert abs(float(tk._inertia_large(xs, got, chunk_n)[0]) - exact) <= 1e-4 * exact


def test_lloyd_runs_all_subspaces_at_once(rng):
    """M subspaces in one call equal M single-subspace runs."""
    n, M, k, C = 600, 3, 2, 8
    xs = torch.from_numpy(np.stack([separated(rng, C, k, n) for _ in range(M)], 1))
    g = torch.Generator().manual_seed(0)
    init = tk._kmeanspp_init(xs, C, g)
    both = tk.lloyd(xs, init, 5)
    for m in range(M):
        one = tk.lloyd(xs[:, m:m + 1], init[m:m + 1], 5)
        np.testing.assert_allclose(both[m].numpy(), one[0].numpy(), atol=1e-6)


def test_split_empty_matches_reference(rng):
    n, k, C = 300, 2, 16
    x = rng.standard_normal((n, k)).astype(np.float32)
    cents = rng.standard_normal((C, k)).astype(np.float32)
    assign = rng.integers(0, C // 2, n)  # clusters C/2 .. C-1 empty
    counts = np.bincount(assign, minlength=C).astype(np.float32)
    want = np.asarray(jk._split_empty(jnp.asarray(x), jnp.asarray(assign), jnp.asarray(cents),
                                      jnp.asarray(counts)))
    got = tk._split_empty(torch.from_numpy(x)[:, None], torch.from_numpy(assign)[:, None],
                          torch.from_numpy(cents)[None], torch.from_numpy(counts)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("nbits", [7, 8])
@pytest.mark.parametrize("d_m", [2, 4, 8])
def test_train_pq_mse_close_to_reference(rng, nbits, d_m):
    n, d, iters = 4096, 16, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    M = d // d_m
    cj = jk.train_pq(jnp.asarray(x), M, nbits, iters, 0, "strided")
    mse_j = float(jnp.mean((jops.pq_decode(jops.pq_encode(jnp.asarray(x), cj, "strided"), cj, "strided")
                            - x) ** 2))
    xt = torch.from_numpy(x)
    ct = tk.train_pq(xt, M, nbits, iters, 0, "strided")
    assert ct.shape == (M, 2**nbits, d_m) and ct.dtype == torch.float32
    mse_t = float((tops.pq_decode(tops.pq_encode(xt, ct, "strided"), ct, "strided") - xt).square().mean())
    assert abs(mse_t - mse_j) <= MSE_RTOL * mse_j, (mse_t, mse_j)


def test_train_pq_large_n_step(rng, monkeypatch):
    """Above LARGE_N train_pq takes the chunked step with a strided donor pool;
    it reaches the small step's quality on the same data."""
    n, d, M, nbits = 2048, 8, 4, 5
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    small = tk.train_pq(x, M, nbits, 6)
    calls = []
    real = tk._lloyd_iter_large
    monkeypatch.setattr(tk, "_lloyd_iter_large", lambda *a: calls.append(a[1].shape) or real(*a))
    monkeypatch.setattr(tk, "LARGE_N", 1 << 10)
    monkeypatch.setattr(tk, "SUB_CAP", 1 << 9)
    large = tk.train_pq(x, M, nbits, 6)
    assert len(calls) == 6 and calls[0] == (512, M, d // M)  # donors from 512 strided rows

    def mse(c):
        return float((tops.pq_decode(tops.pq_encode(x, c), c) - x).square().mean())

    assert abs(mse(large) - mse(small)) <= MSE_RTOL * mse(small)


def test_kmeanspp_never_draws_a_covered_row(rng):
    """With as many distinct points as centroids, D^2 sampling picks each
    distinct point once: a row at distance 0 has weight 0."""
    pts = rng.standard_normal((12, 2)).astype(np.float32)
    xs = torch.from_numpy(np.repeat(pts, 40, axis=0))[:, None]
    for seed in range(5):
        init = tk._kmeanspp_init(xs, 12, torch.Generator().manual_seed(seed))[0].numpy()
        assert len({tuple(r) for r in init}) == 12


@pytest.mark.parametrize("chunk_n", [0, 64], ids=["small_n", "large_n"])
def test_empty_clusters_reseeded(rng, chunk_n):
    """Fewer distinct points than centroids: duplicates go empty and are
    re-seeded; nothing turns non-finite and every point is reconstructed."""
    pts = rng.standard_normal((10, 2)).astype(np.float32)
    xs = torch.from_numpy(np.repeat(pts, 60, axis=0))[:, None]
    init = tk._kmeanspp_init(xs, 16, torch.Generator().manual_seed(0))
    cents = tk.lloyd(xs, init, 5, chunk_n=chunk_n)
    assert torch.isfinite(cents).all()
    assert float(tk._inertia_large(xs, cents)[0]) < 1e-6  # means of equal points, f32 sums
    x = torch.from_numpy(np.repeat(rng.standard_normal((10, 16)).astype(np.float32), 60, axis=0))
    assert torch.isfinite(tk.train_pq(x, 8, 4, 5)).all()


def test_train_opq_improves_reconstruction(rng):
    n, d, M, nbits = 2048, 16, 8, 4
    A = rng.standard_normal((d, d)).astype(np.float32)
    scales = np.logspace(0, -1.2, d).astype(np.float32)
    X = torch.from_numpy((rng.standard_normal((n, d)).astype(np.float32) * scales) @ A)
    cents = tk.train_pq(X, M, nbits, iters=15)
    err_pq = float((tops.pq_decode(tops.pq_encode(X, cents), cents) - X).square().mean())
    R, cents_opq = tk.train_opq(X, M, nbits, iters=15, opq_iters=6)
    np.testing.assert_allclose((R @ R.t()).numpy(), np.eye(d), atol=1e-4)
    XR = X @ R
    err_opq = float((tops.pq_decode(tops.pq_encode(XR, cents_opq), cents_opq) @ R.t() - X).square().mean())
    assert err_opq < err_pq * 0.95, (err_opq, err_pq)


def test_kmeans_single_subspace(rng):
    x = torch.from_numpy(separated(rng, 8, 2, 500))
    cents, inertia = tk.kmeans(x, 8, iters=5)
    assert cents.shape == (8, 2) and inertia.shape == ()
    assert float(inertia) < 500 * 2 * 0.05**2 * 3


def test_wide_codebooks_raise(rng):
    """nbits 9 (C = 512, int16 codes) trains, as wide codes are ported; fewer
    samples than centroids still raise."""
    x = torch.from_numpy(rng.standard_normal((1024, 8)).astype(np.float32))
    cents = tk.train_pq(x, 4, nbits=9, iters=1)
    assert cents.shape == (4, 512, 2) and bool(torch.isfinite(cents).all())
    codes = tk.assign(tops.subspace_view(x, 4).contiguous(), cents)
    assert codes.dtype == torch.int16 and int(tops.code_index(codes).max()) < 512
    with pytest.raises(ValueError):
        tk.train_pq(x[:100], 4, nbits=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the encode kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("d_m", [2, 4, 8])
@pytest.mark.parametrize("large", [False, True], ids=["small_n", "large_n"])
def test_cuda_kernel_assignment_matches_plain(rng, cuda_device, C, d_m, large):
    n, d = 16384, 64
    xs = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda_device)
    xs = tops.subspace_view(xs, d // d_m, "strided").contiguous()
    init = tk._kmeanspp_init(xs, C, torch.Generator(device=cuda_device).manual_seed(0))
    chunk_n = 2048 if large else 0
    before = E.pq_encode_fused_stacked.launches
    got = tk.lloyd(xs, init, 10, chunk_n=chunk_n, use_kernel=True)
    assert E.pq_encode_fused_stacked.launches - before == 10 * (2 if large else 1)
    want = tk.lloyd(xs, init, 10, chunk_n=chunk_n, use_kernel=False)
    i_got = float(tk._inertia_large(xs, got, use_kernel=False).sum())
    i_want = float(tk._inertia_large(xs, want, use_kernel=False).sum())
    assert abs(i_got - i_want) <= INERTIA_RTOL * i_want, (i_got, i_want)
    # the two argmins round differently: near-ties may split the other way
    assert (tk.assign(xs, got) == tk._assign(xs, got)).float().mean() >= 0.999

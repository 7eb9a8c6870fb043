"""The port's fused PQ encode against million_tpu.

On the CPU the wrappers (pq_encode_fused, pq_encode_fused_stacked,
runtime_encode) run the kernel's plain PyTorch version. It is held against
million_tpu's fused Pallas encode in interpret mode and against its jnp
pq_encode with the thresholds of tests/test_encode_pallas.py: the two
objectives (argmax of <x,c> - 0.5||c||^2, argmin of ||c||^2 - 2<x,c>) round
differently, so "exact" asks for >= 99.9 % equal codes and reconstruction
errors equal within 1e-4 relative, "fast" (bf16 operands) for >= 98 % and
2e-3, and integer-valued inputs, where nothing rounds, for equal codes. Tests
marked `cuda` hold the CUDA kernel against the plain version on the card and
skip without one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.ops.pq_encode_pallas import pq_encode_fused as jax_fused
from million_tpu.pq.ops import pq_decode as jax_decode, pq_encode as jax_encode
from million_tpu_torch.ops import pq_encode_kernel as E
from million_tpu_torch.pq import ops as tops


def _t(x):
    return torch.from_numpy(np.array(x))


def recon_mse(codes, cents, x, layout):
    xr = np.asarray(jax_decode(jnp.asarray(codes), jnp.asarray(cents), layout))
    return ((xr - x) ** 2).mean()


THRESHOLDS = {"exact": (0.999, 1e-4), "fast": (0.98, 2e-3)}


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("d_m", [2, 4])
def test_fused_plain_matches_jax(rng, layout, d_m, precision):
    d, C = 32, 256
    M = d // d_m
    x = rng.standard_normal((3, 2, 100, d)).astype(np.float32)
    cents = rng.standard_normal((M, C, d_m)).astype(np.float32)
    got = E.pq_encode_fused(_t(x), _t(cents), layout, precision).numpy()
    assert got.shape == (3, 2, 100, M) and got.dtype == np.uint8
    min_agree, rtol = THRESHOLDS[precision]
    refs = {
        "pallas": np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(cents), layout,
                                       interpret=True, precision=precision)),
        "jnp": np.asarray(jax_encode(jnp.asarray(x), jnp.asarray(cents), layout,
                                     precision=precision)),
    }
    for name, want in refs.items():
        agree = (got == want).mean()
        assert agree >= min_agree, f"{name}: agreement {agree}"
        np.testing.assert_allclose(recon_mse(got, cents, x, layout),
                                   recon_mse(want, cents, x, layout), rtol=rtol, err_msg=name)


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_integer_inputs_give_equal_codes(rng, layout, precision):
    """Integer-valued inputs: nothing rounds (bf16 holds small integers), so
    the port, million_tpu's fused kernel and the numpy argmin agree bit for
    bit, ties to the lowest index."""
    d, M, C = 16, 8, 64
    x = rng.integers(-4, 5, (40, d)).astype(np.float32)
    cents = rng.integers(-4, 5, (M, C, d // M)).astype(np.float32)
    xs = x.reshape(40, M, 2) if layout == "contiguous" else x.reshape(40, 2, M).swapaxes(1, 2)
    want = ((xs[:, :, None, :] - cents[None]) ** 2).sum(-1).argmin(-1)
    got = E.pq_encode_fused(_t(x), _t(cents), layout, precision).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(cents), layout, interpret=True,
                             precision=precision)), want)
    if precision == "fast":
        np.testing.assert_array_equal(tops.runtime_encode(_t(x), _t(cents), layout).numpy(), want)


def test_stacked_matches_per_bank(rng):
    S, d, M, C = 3, 16, 8, 32
    x = rng.standard_normal((S, 2, 50, d)).astype(np.float32)
    cents = rng.standard_normal((S, M, C, d // M)).astype(np.float32)
    got = E.pq_encode_fused_stacked(_t(x), _t(cents), "strided", "exact").numpy()
    assert got.shape == (S, 2, 50, M)
    for s in range(S):
        one = E.pq_encode_fused(_t(x[s]), _t(cents[s]), "strided", "exact").numpy()
        np.testing.assert_array_equal(got[s], one)
        np.testing.assert_array_equal(
            one, np.asarray(jax_encode(jnp.asarray(x[s]), jnp.asarray(cents[s]), "strided")))


def test_runtime_encode_dispatch(rng):
    """The port's switch is on; a CPU tensor takes the plain chunked encode
    at the runtime precision, which equals the fused wrapper's CPU result."""
    assert tops.RUNTIME_FUSED_ENCODE is True and tops.RUNTIME_ENCODE_PRECISION == "fast"
    x = rng.standard_normal((2, 2, 1500, 16)).astype(np.float32)  # more than one 1024-token chunk
    cents = rng.standard_normal((8, 32, 2)).astype(np.float32)
    got = tops.runtime_encode(_t(x), _t(cents), "strided").numpy()
    np.testing.assert_array_equal(got, E.pq_encode_fused(_t(x), _t(cents), "strided", "fast").numpy())
    want = np.asarray(jax_encode(jnp.asarray(x), jnp.asarray(cents), "strided", precision="fast"))
    assert (got == want).mean() >= 0.98
    np.testing.assert_allclose(recon_mse(got, cents, x, "strided"),
                               recon_mse(want, cents, x, "strided"), rtol=2e-3)


def test_plain_row_chunks_do_not_change_codes(rng, monkeypatch):
    x = rng.standard_normal((2, 300, 16)).astype(np.float32)
    cents = rng.standard_normal((2, 8, 32, 2)).astype(np.float32)
    whole = E.pq_encode_fused_plain(_t(x), _t(cents), "strided", "exact")
    monkeypatch.setattr(E, "PLAIN_MAX_DIST", 2 * 8 * 32 * 7)  # 7 rows at a time
    np.testing.assert_array_equal(
        E.pq_encode_fused_plain(_t(x), _t(cents), "strided", "exact").numpy(), whole.numpy())


def test_strided_view_input(rng):
    """The model hands the encode a (bs, heads, n, d) transpose of a
    (bs, n, heads, d) projection, sliced on the token axis."""
    base = rng.standard_normal((2, 21, 3, 16)).astype(np.float32)
    cents = rng.standard_normal((4, 64, 4)).astype(np.float32)
    view = _t(base).transpose(1, 2)[:, :, :20]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        E.pq_encode_fused(view, _t(cents), "strided", "fast").numpy(),
        E.pq_encode_fused(view.contiguous(), _t(cents), "strided", "fast").numpy())
    assert E._collapse(tuple(view.shape[:-1]), tuple(view.stride()[:-1])) == [
        (2, 21 * 48), (3, 16), (20, 48)]
    assert E._collapse((4, 1, 5, 6), (30, 30, 6, 1)) == [(120, 1)]


def test_wrapper_rejects(rng):
    x = _t(rng.standard_normal((2, 5, 16)).astype(np.float32))
    cents = _t(rng.standard_normal((2, 8, 32, 2)).astype(np.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        E.pq_encode_fused_stacked(x.to("meta"), cents, "strided")
    with pytest.raises(ValueError, match="banks"):
        E.pq_encode_fused_stacked(x[:1], cents, "strided")
    with pytest.raises(ValueError, match="precision"):
        E.pq_encode_fused_stacked(x, cents, "strided", "sloppy")


def duplicated_codebook(rng, M, C, d_m):
    """Integer-valued (M, C, d_m) codebooks in which every centroid occurs at
    least twice (at shuffled positions, C >= 2), so that every nearest
    centroid is a tie; and for each index, whether a later index holds the
    same centroid."""
    k = C // 2
    cents = np.empty((M, C, d_m), np.float32)
    for m in range(M):
        base = rng.integers(-3, 4, (k, d_m)).astype(np.float32)
        idx = rng.permutation(np.concatenate([np.arange(k), np.arange(k), rng.integers(0, k, C - 2 * k)]))
        cents[m] = base[idx]
    later = np.array([[any((cents[m, c] == cents[m, c + 1:]).all(-1)) for c in range(C)] for m in range(M)])
    return cents, later


def nearest_lowest(x, cents, layout):
    """numpy: argmin of the squared distance, ties to the lowest index."""
    M, C, d_m = cents.shape
    xs = x.reshape(-1, M, d_m) if layout == "contiguous" else x.reshape(-1, d_m, M).swapaxes(1, 2)
    return ((xs[:, :, None, :] - cents[None]) ** 2).sum(-1).argmin(-1).reshape(*x.shape[:-1], M)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("C", [7, 128, 256])
@pytest.mark.parametrize("d_m", [1, 2, 4, 8])
def test_duplicate_centroids_take_lowest_index(rng, d_m, C, layout):
    """Every nearest centroid is a tie between copies: the port's plain
    version, million_tpu's fused encode (interpret mode) and its jnp encode
    all take the lowest index (integer-valued inputs: nothing rounds)."""
    d = 16
    M = d // d_m
    cents, later = duplicated_codebook(rng, M, C, d_m)
    x = rng.integers(-3, 4, (3, 20, d)).astype(np.float32)
    want = nearest_lowest(x, cents, layout)
    assert later[np.arange(M), want].all()  # each answer has a later copy it must beat
    got = E.pq_encode_fused(_t(x), _t(cents), layout, "fast").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(cents), layout, interpret=True,
                             precision="fast")), want)
    np.testing.assert_array_equal(
        np.asarray(jax_encode(jnp.asarray(x), jnp.asarray(cents), layout, precision="fast")), want)


def test_knockouts_of_the_encode_apply(tmp_path):
    """The knock-out builds that benchmarks/encode_kernel_ab.py times are text
    edits of this checkout's pq_encode.cu: every edit still finds its text."""
    from million_tpu_torch.benchmarks import encode_kernel_ab as A
    from million_tpu_torch.ops import cuda_build

    original = (cuda_build.CSRC / A.SOURCE).read_text()
    for name, edits in A.KNOCKOUTS.items():
        text = A.write_knockout(name, tmp_path).read_text()
        assert text != original and all(old not in text for old, _ in edits)


def test_bound_counts():
    assert E.encode_bytes(1024, 128, 64, 2) == 1024 * (256 + 64)
    assert E.encode_ops(10, 64, 256, 2) == 10 * 64 * 256 * 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


CUDA_CASES = {
    # shape of x, (M, C, d_m), layout, precision, dtype
    "dm2_bf16_fast": ((1, 2, 3, 700, 128), (64, 256, 2), "strided", "fast", torch.bfloat16),
    "dm4_c128_f32_fast": ((1, 2, 3, 700, 128), (32, 128, 4), "strided", "fast", torch.float32),
    "dm2_exact_contig": ((1, 1000, 64), (32, 200, 2), "contiguous", "exact", torch.float32),
    "flush_banks": ((5, 2, 3, 16, 128), (64, 256, 2), "strided", "fast", torch.bfloat16),
    "dm8": ((2, 300, 64), (8, 256, 8), "strided", "exact", torch.float32),
    "dm1_tiny": ((1, 33, 16), (16, 7, 1), "contiguous", "exact", torch.float32),
    "test_tiny_dm2": ((2, 2, 2, 50, 16), (8, 32, 2), "strided", "fast", torch.float32),
    # C not a multiple of the centroid tile (16 at d_m <= 2, 8 at d_m 4, 4 at d_m 8)
    "c1_dm2": ((1, 2, 300, 64), (32, 1, 2), "strided", "fast", torch.bfloat16),
    "c7_dm4": ((1, 2, 300, 64), (16, 7, 4), "contiguous", "exact", torch.float32),
    "c255_dm2_rows_333": ((1, 3, 8, 333, 128), (64, 255, 2), "strided", "fast", torch.bfloat16),
    "c200_dm8": ((1, 5, 257, 64), (8, 200, 8), "strided", "fast", torch.bfloat16),
    # the flush: one bank per layer of llama-3.2-3b
    "flush_28_banks": ((28, 4, 8, 16, 128), (64, 256, 2), "strided", "fast", torch.bfloat16),
    "flush_28_banks_c128": ((28, 4, 8, 16, 128), (32, 128, 4), "strided", "fast", torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(rng, cuda_device, case):
    shape, (M, C, d_m), layout, precision, dtype = CUDA_CASES[case]
    x = _t(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    cents = _t(rng.standard_normal((shape[0], M, C, d_m)).astype(np.float32))
    want = E.pq_encode_fused_plain(x, cents, layout, precision).numpy()
    before = E.pq_encode_fused_stacked.launches
    got = E.pq_encode_fused_stacked(x.to(cuda_device), cents.to(cuda_device), layout, precision)
    torch.cuda.synchronize()
    assert E.pq_encode_fused_stacked.launches == before + 1
    got = got.cpu().numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (got == want).mean() >= 0.999
    xf, cf = x.float().numpy(), cents.numpy()
    for s in range(shape[0]):
        np.testing.assert_allclose(recon_mse(got[s], cf[s], xf[s], layout),
                                   recon_mse(want[s], cf[s], xf[s], layout), rtol=1e-4)


@pytest.mark.cuda
def test_cuda_kernel_integer_inputs_and_views(rng, cuda_device):
    """Bit-equal codes where nothing rounds, through a strided view of x."""
    base = _t(rng.integers(-4, 5, (2, 333, 3, 128)).astype(np.float32))
    cents = _t(rng.integers(-4, 5, (64, 256, 2)).astype(np.float32))
    view = base.transpose(1, 2)[:, :, :332]
    want = E.pq_encode_fused(view, cents, "strided", "fast").numpy()
    for dtype in (torch.float32, torch.bfloat16):
        dev_view = base.to(cuda_device, dtype).transpose(1, 2)[:, :, :332]
        got = E.pq_encode_fused(dev_view, cents.to(cuda_device), "strided", "fast")
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    empty = E.pq_encode_fused(base.to(cuda_device)[:, :0], cents.to(cuda_device), "strided")
    assert empty.shape == (2, 0, 3, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("C", [1, 7, 200, 255, 256])
@pytest.mark.parametrize("d_m", [1, 2, 4, 8])
def test_cuda_duplicate_centroids_take_lowest_index(rng, cuda_device, d_m, C, layout):
    """Bit-equal codes where every nearest centroid is a tie (C = 1: one
    centroid, no tie), through the admission shape's kind of view, with a
    row count that is no multiple of either row tile."""
    d = 128
    M = d // d_m
    if C > 1:
        cents, _ = duplicated_codebook(rng, M, C, d_m)
    else:
        cents = rng.integers(-3, 4, (M, 1, d_m)).astype(np.float32)
    base = rng.integers(-3, 4, (3, 301, 2, d)).astype(np.float32)
    want = nearest_lowest(base.transpose(0, 2, 1, 3), cents, layout)
    view = _t(base).to(cuda_device, torch.bfloat16).transpose(1, 2)
    got = E.pq_encode_fused(view, _t(cents).to(cuda_device), layout, "fast")
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(64, 256, 2), (32, 128, 4)])
def test_cuda_kernel_views_at_path_shapes(rng, cuda_device, geometry):
    """The views the paths give the kernel: a serving admission chunk (6 x 8 x
    512 rows) and a chunk of 4 x 8 x 1000 rows, as the (bs, heads, n, d)
    transpose of a (bs, n, heads, d) projection; and an odd view (an element
    offset and odd strides, which take the element-wise copy)."""
    M, C, d_m = geometry
    cents = _t(rng.standard_normal((M, C, d_m)).astype(np.float32)).to(cuda_device)
    big = _t(rng.standard_normal((6, 1001, 8, 128)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    odd = _t(rng.standard_normal((4, 500, 8, 129)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    views = [big[:, :512].transpose(1, 2), big[:4, 1:].transpose(1, 2), odd[..., 1:].transpose(1, 2)]
    for view in views:
        got = E.pq_encode_fused(view, cents, "strided", "fast")
        want = E.pq_encode_fused_plain(view[None], cents[None], "strided", "fast")[0]
        assert got.shape == want.shape
        assert float((got == want).float().mean()) >= 0.999
        np.testing.assert_allclose(
            recon_mse(got.cpu().numpy(), cents.cpu().numpy(), view.float().cpu().numpy(), "strided"),
            recon_mse(want.cpu().numpy(), cents.cpu().numpy(), view.float().cpu().numpy(), "strided"),
            rtol=1e-4)

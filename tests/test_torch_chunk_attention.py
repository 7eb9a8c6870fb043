"""The port's chunk-history attention against million_tpu.

On the CPU the wrappers (pq_chunk_attention, pq_chunk_history_attention) run
the kernel's plain PyTorch version: an f32 online softmax over history blocks.
It is held at atol 1e-5 against million_tpu's f32 block scan
(chunked_prefill._history_partial, no outliers there) and against a numpy
softmax oracle that includes the outlier terms, and at 5e-2 against the TPU
kernel in interpret mode, which decodes with int8 tables and int8 q (the
tolerance tests/test_pallas_kernel.py gives that kernel against an f32
oracle). Tests marked `cuda` hold the CUDA kernel against the plain version
on the card and skip without one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.models.chunked_prefill import _history_partial as jax_history_partial
from million_tpu.ops.pq_attention_pallas import (
    pack_codes,
    pack_decode_table,
    pq_chunk_history_attention as jax_chunk_history,
    to_byte_plane,
)
from million_tpu_torch import convert
from million_tpu_torch.models.chunked_prefill import _history_partial
from million_tpu_torch.ops import pq_chunk_attention_kernel as K


def _t(x):
    return torch.from_numpy(np.array(x))


def make_case(rng, *, bs=1, nh_k=2, G=2, nc=12, d=16, M=8, C=32, M_v=None, C_v=None,
              O=0, N=128, OK=None, OV=None):
    """Random inputs in million_tpu's layouts (codes subspace-major (.., M, N))
    with outlier channels whose centroid components are 0: O a side, or OK
    and OV where the two sides differ."""
    M_v, C_v = M_v or M, C_v or C
    OK, OV = (O if OK is None else OK), (O if OV is None else OV)
    c = dict(
        q=rng.standard_normal((bs, nh_k * G, nc, d)).astype(np.float32),
        kc=rng.integers(0, C, (bs, nh_k, M, N)).astype(np.uint8),
        vc=rng.integers(0, C_v, (bs, nh_k, M_v, N)).astype(np.uint8),
        kcent=rng.standard_normal((M, C, d // M)).astype(np.float32),
        vcent=rng.standard_normal((M_v, C_v, d // M_v)).astype(np.float32),
    )
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    if OK:
        c["ko"] = bf(rng.standard_normal((bs, nh_k, N, OK)) * 2)  # (.., N, OK)
    if OV:
        c["vo"] = bf(rng.standard_normal((bs, nh_k, N, OV)) * 2)
    if OK:
        c["koidx"] = np.sort(rng.choice(d, OK, replace=False)).astype(np.int32)
    if OV:
        c["voidx"] = np.sort(rng.choice(d, OV, replace=False)).astype(np.int32)
    for ch in c.get("koidx", ()):
        c["kcent"][ch % M, :, ch // M] = 0.0
    for ch in c.get("voidx", ()):
        c["vcent"][ch % M_v, :, ch // M_v] = 0.0
    return c


def port_args(c, dev="cpu"):
    """The port's arguments: the code arenas carried across from packed words."""
    words_k = np.asarray(pack_codes(jnp.asarray(c["kc"])))
    words_v = np.asarray(pack_codes(jnp.asarray(c["vc"])))
    args = [_t(c["q"]), _t(convert.arena_from_words(words_k)), _t(convert.arena_from_words(words_v)),
            _t(c["kcent"]), _t(c["vcent"])]
    kw = {}
    if "ko" in c:
        kw.update(koidx=_t(c["koidx"]), k_outliers=_t(c["ko"]).bfloat16())
    if "vo" in c:
        kw.update(voidx=_t(c["voidx"]), v_outliers=_t(c["vo"]).bfloat16())
    return [a.to(dev) for a in args], {k: v.to(dev) for k, v in kw.items()}


def numpy_oracle(c, n_prev, scale):
    """Softmax attention over the decoded first n_prev tokens, outlier terms
    included. Returns (out (bs, nh, nc, d), lse (bs, nh, nc))."""
    bs, nh, nc, d = c["q"].shape
    nh_k = c["kc"].shape[1]
    G = nh // nh_k

    def decode(codes, cent):  # (bs, nh_k, M, N) -> (bs, nh_k, n_prev, d), strided split
        M = cent.shape[0]
        g = cent[np.arange(M)[:, None], codes[..., :n_prev]]  # (bs, nh_k, M, n, d_m)
        return np.moveaxis(g, -1, 2).reshape(bs, nh_k, d, n_prev).swapaxes(-1, -2)

    khat, vhat = decode(c["kc"], c["kcent"]), decode(c["vc"], c["vcent"])
    if "vo" in c:
        vhat = vhat.copy()
        vhat[..., c["voidx"]] = c["vo"][:, :, :n_prev]
    qs = (c["q"] * scale).reshape(bs, nh_k, G, nc, d)
    s = np.einsum("bhgqd,bhnd->bhgqn", qs, khat)
    if "ko" in c:
        s = s + np.einsum("bhgqo,bhno->bhgqn", qs[..., c["koidx"]], c["ko"][:, :, :n_prev])
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    out = np.einsum("bhgqn,bhnd->bhgqd", p / l, vhat)
    return out.reshape(bs, nh, nc, d), (m + np.log(l))[..., 0].reshape(bs, nh, nc)


@pytest.mark.parametrize("n_prev", [37, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4])
def test_plain_matches_jax_history_partial(rng, G, n_prev):
    c = make_case(rng, G=G)
    d = c["q"].shape[-1]
    scale = 1.0 / d**0.5
    args, _ = port_args(c)
    out, lse = K.pq_chunk_history_attention(*args, n_prev, scale)
    want_out, want_lse = jax_history_partial(
        jnp.asarray(c["q"]), pack_codes(jnp.asarray(c["kc"])), pack_codes(jnp.asarray(c["vc"])),
        jnp.asarray(c["kcent"]), jnp.asarray(c["vcent"]), jnp.asarray(n_prev), scale,
        nb=4, hist_block=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)
    # the plain history route of chunked_prefill is the same function, blockwise
    out_b, lse_b = _history_partial(*args, n_prev, scale, hist_block=16)
    np.testing.assert_allclose(out_b.numpy(), out.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse_b.numpy(), lse.numpy(), atol=1e-6)


GEOMETRIES = {
    "dm2": dict(M=8, C=32),
    "dm4_outliers": dict(M=4, C=64, O=4),
    "asym_Mv4_outliers": dict(M=8, C=32, M_v=4, C_v=64, O=2),
}


@pytest.mark.parametrize("n_prev", [5, 100])
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_plain_matches_numpy_oracle(rng, geom, n_prev):
    c = make_case(rng, G=3, nc=7, **GEOMETRIES[geom])
    scale = 1.0 / c["q"].shape[-1] ** 0.5
    args, kw = port_args(c)
    want_out, want_lse = numpy_oracle(c, n_prev, scale)
    for hist_block in (1024, 32):
        out, lse = _history_partial(*args, n_prev, scale, hist_block=hist_block, **kw)
        np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)
    out, lse = K.pq_chunk_history_attention(*args, n_prev, scale, **kw)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)


def test_empty_history(rng):
    c = make_case(rng, O=4, M=4, C=64)
    args, kw = port_args(c)
    out, lse = K.pq_chunk_history_attention(*args, 0, 0.25, **kw)
    assert out.shape == c["q"].shape and (out.numpy() == 0).all()
    assert (lse.numpy() == -1e30).all()


def test_grouping_round_trip(rng):
    q = _t(rng.standard_normal((2, 6, 5, 8)).astype(np.float32))
    rows = K.group_rows(q, 2, 0.5)
    assert rows.shape == (2, 2, 15, 8)
    np.testing.assert_array_equal(rows[1, 1, 3 * 4 + 2].numpy(), (q[1, 3 + 2, 4] * 0.5).numpy())
    out, lse = K.ungroup_rows(rows, rows[..., 0], 6)
    np.testing.assert_array_equal(out.numpy(), (q * 0.5).numpy())
    np.testing.assert_array_equal(lse.numpy(), (q[..., 0] * 0.5).numpy())


def test_plain_matches_tpu_kernel_interpret(rng):
    """Loose parity with the TPU kernel itself, outlier terms included."""
    c = make_case(rng, G=2, nc=24, d=32, M=16, C=256, O=4, N=512)
    n_prev, scale = 384, 1.0 / 32**0.5
    out_j, lse_j = jax_chunk_history(
        jnp.asarray(c["q"]), pack_codes(jnp.asarray(c["kc"])), pack_codes(jnp.asarray(c["vc"])),
        pack_decode_table(jnp.asarray(c["kcent"])), pack_decode_table(jnp.asarray(c["vcent"])),
        jnp.asarray(n_prev, jnp.int32), scale, block=128, q_block=16, interpret=True,
        koidx=jnp.asarray(c["koidx"]), voidx=jnp.asarray(c["voidx"]),
        k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(c["ko"], -1, -2), jnp.bfloat16)),
        v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(c["vo"], -1, -2), jnp.bfloat16)),
    )
    args, kw = port_args(c)
    out, lse = K.pq_chunk_history_attention(*args, n_prev, scale, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0.05, atol=0.05)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=0.05, atol=0.05)


def test_bf16_precision_rounds_inputs_only(rng):
    """precision "bf16" (what the tensor-core kernel computes) rounds q, the
    codebooks and the P V weights to bf16 and keeps f32 sums: within 3e-2 of
    the f32 result, equal to it on inputs that bf16 holds exactly up to the
    rounding of the weights, and what 16-bit queries get by default."""
    c = make_case(rng, G=3, nc=9, M=4, C=64, O=4)
    args, kw = port_args(c)
    f32 = K.pq_chunk_history_attention(*args, 100, 0.25, **kw)
    bf = K.pq_chunk_history_attention(*args, 100, 0.25, precision="bf16", **kw)
    for a, b in zip(bf, f32):
        assert 0 < float((a - b).abs().max()) < 3e-2
    auto = K.pq_chunk_history_attention(args[0].bfloat16(), *args[1:], 100, 0.25, **kw)
    rounded = K.pq_chunk_history_attention(args[0].bfloat16().float(), *args[1:], 100, 0.25,
                                           precision="bf16", **kw)
    for a, b in zip(auto, rounded):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert K.history_precision(args[0]) == "f32" and K.history_precision(args[0].half()) == "bf16"
    with pytest.raises(ValueError, match="precision"):
        K.pq_chunk_history_attention(*args, 100, 0.25, precision="fp8", **kw)


def test_wrapper_rejects(rng):
    c = make_case(rng, O=4, M=4, C=64)
    args, kw = port_args(c)
    rows = K.group_rows(args[0], 2, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        K.pq_chunk_attention(rows.to("meta"), *args[1:], 8)
    with pytest.raises(ValueError, match="go together"):
        K.pq_chunk_attention(rows, *args[1:], 8, k_outliers=kw["k_outliers"])


def test_bound_counts():
    assert K.chunk_ops(4, 8, 12288, 128, 28672, 16) == 2 * 32 * 12288 * 28672 * 272
    assert K.chunk_bytes(1, 1, 10, 128, 100, 64, 64) == 10 * 257 * 4 + 100 * 128


def test_bound_counts_admission_shape():
    """The last 512-token chunk of a six-slot admission: 6 x 8 (slot, KV head)
    pairs of 1,536 rows (512 positions x 3 query heads) over 32,256 tokens."""
    pairs, rows, n = 6 * 8, 512 * 3, 32256
    # a multiply-add is 2 operations: q . K_hat over d (+ the exact K channels), P V_hat over d
    assert K.chunk_ops(6, 8, 1536, 128, n) == pairs * rows * n * 2 * (128 + 128)
    assert K.chunk_ops(6, 8, 1536, 128, n, 16) == pairs * rows * n * 2 * (128 + 16 + 128)
    # q read and out written (f32, d wide), lse written (f32), codes (and exact channels) read once
    assert K.chunk_bytes(6, 8, 1536, 128, n, 64, 64) == pairs * (rows * (4 * 128 * 2 + 4) + n * 128)
    assert K.chunk_bytes(6, 8, 1536, 128, n, 32, 32, 16, 16) == pairs * (
        rows * (4 * 128 * 2 + 4) + n * (32 + 32 + 2 * 16 + 2 * 16))


def _staged_row(rb, pad):
    if not pad:
        return (rb + 3) // 4 * 4
    return rb + 16 if rb % 16 == 0 else (rb + 3) // 4 * 4 + 4


# (d, M, C, OK = OV) of the geometries the card runs the tensor-core version
# in, with the (stages, staging slots, padded rows) the plan must give them
PLAN_GEOMETRIES = {
    "dm2": ((128, 64, 256, 0), (2, 3, True)),
    "dm4_outlier": ((128, 32, 256, 16), (2, 2, True)),
    "dm4_outlier_c128": ((128, 32, 128, 16), (3, 3, True)),
    "test-tiny": ((16, 4, 64, 4), (4, 3, True)),
    "dm2_outlier": ((128, 64, 256, 16), (2, 2, False)),
}


@pytest.mark.parametrize("geom", sorted(PLAN_GEOMETRIES))
def test_mma_smem_plan_fits_and_follows_its_formula(geom):
    """The shared-memory plan of the tensor-core version (the mirror of the
    .cu source's mma_plan, which the wrapper holds it against on the card):
    a 256-byte head, both codebooks in bf16, staging slots of a 64-token
    tile's code and exact-channel rows, decoded-tile stages of K_hat, V_hat
    and the exact V channels; it fits the 232,448 bytes a block may take, for
    every geometry of chip_smoke.py and test-tiny."""
    import chip_smoke

    (d, M, C, O), (want_stages, want_slots, pad) = PLAN_GEOMETRIES[geom]
    if geom in chip_smoke.GEOMETRIES:
        g = chip_smoke.GEOMETRIES[geom]
        assert (g["M"], g["C"], g["O"]) == (M, C, O)
    stages, slots, nbytes = K.mma_smem_plan(d, O, C, C, M, M, O)
    op = 16 if O else 0
    slot = 64 * (2 * _staged_row(M, pad) + (2 * _staged_row(2 * O, pad) if O else 0))
    stage = 64 * 2 * (d + op + d + op)
    assert (stages, slots) == (want_stages, want_slots)
    assert nbytes == 256 + 2 * 2 * C * d + slots * slot + stages * stage <= 232448
    assert stages == 4 or nbytes + stage > 232448  # one more stage would not fit


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


CUDA_CASES = {
    "dm2_G3": dict(G=3, nc=100, d=128, M=64, C=256, N=1024),
    "dm4_c128_outliers_G3": dict(G=3, nc=171, d=128, M=32, C=128, O=16, N=1024),
    "asym_G4": dict(G=4, nc=64, d=128, M=64, C=256, M_v=32, C_v=128, O=16, N=512),
    "d64_G8": dict(G=8, nc=40, d=64, M=32, C=256, N=512),
    "test_tiny_G2": dict(G=2, nc=16, d=16, M=4, C=64, O=4, N=128),
    # the edges of the tensor-core version's tiles (64 tokens) and blocks
    # (two warpgroups of 64 rows): 3, 130 and 1,536 rows
    "rows3_dm2_c256": dict(G=3, nc=1, d=128, M=64, C=256, N=512),
    "rows130_dm4_c256_outliers": dict(G=2, nc=65, d=128, M=32, C=256, O=16, N=512),
    "rows1536_dm4_c128_outliers": dict(G=3, nc=512, d=128, M=32, C=128, O=16, N=512),
    "k_exact_only_dm4_c256": dict(G=3, nc=40, d=128, M=32, C=256, OK=16, OV=0, N=512),
    "v_exact_only_dm2_c128": dict(G=3, nc=40, d=128, M=64, C=128, OK=0, OV=16, N=512),
    "d64_dm4_c128_outliers": dict(G=3, nc=50, d=64, M=16, C=128, O=16, N=512),
    "d16_dm2_c256": dict(G=2, nc=30, d=16, M=8, C=256, N=256),
    # shared memory too tight for padded staging rows (PLAN_GEOMETRIES["dm2_outlier"])
    "dm2_outliers_c256_unpadded": dict(G=3, nc=40, d=128, M=64, C=256, O=16, N=512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(rng, cuda_device, case):
    """Ragged query tiles, ragged and empty histories, every geometry: f32
    kernel against f32 plain version, only the summation order differs."""
    c = make_case(rng, bs=2, **CUDA_CASES[case])
    N = c["kc"].shape[-1]
    scale = 1.0 / c["q"].shape[-1] ** 0.5
    args, kw = port_args(c)
    dargs, dkw = port_args(c, cuda_device)
    for n_prev in (0, 1, 127, 128, N - 3, N):
        want = K.pq_chunk_history_attention(*args, n_prev, scale, **kw)
        before = K.pq_chunk_attention.launches
        got = K.pq_chunk_history_attention(*dargs, n_prev, scale, **dkw)
        torch.cuda.synchronize()
        assert K.pq_chunk_attention.launches == before + 1
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4, err_msg=f"n_prev={n_prev}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_tensor_core_kernel_matches_plain(rng, cuda_device, case):
    """The bf16 tensor-core version against the plain version that rounds at
    the same places, over history blocks of the kernel's 64-token tile, so
    that both round the softmax weights against the same running maxima:
    2e-3 on outputs of order 0.1 to 4 (a weight's bf16 rounding can still
    fall the other way on the last bit); and within 2e-2 of the f32 result
    (one bf16 step of a V component of 4 is 1.6e-2). Histories: empty, one
    token, either side of one and of two 64-token tiles, several tiles and a
    ragged tail, and the whole arena."""
    c = make_case(rng, bs=2, **CUDA_CASES[case])
    N = c["kc"].shape[-1]
    scale = 1.0 / c["q"].shape[-1] ** 0.5
    args, kw = port_args(c)
    dargs, dkw = port_args(c, cuda_device)
    for n_prev in sorted({n for n in (0, 1, 63, 64, 65, 127, 129, 3 * 64 + 5) if n <= N} | {N - 3, N}):
        want = K.pq_chunk_history_attention(*args, n_prev, scale, precision="bf16",
                                            hist_block=K.MMA_TILE, **kw)
        exact = K.pq_chunk_history_attention(*args, n_prev, scale, **kw)
        before = K.pq_chunk_attention.launches
        got = K.pq_chunk_history_attention(*dargs, n_prev, scale, precision="bf16", **dkw)
        torch.cuda.synchronize()
        assert K.pq_chunk_attention.launches == before + 1
        for g, w, e in zip(got, want, exact):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=2e-3, err_msg=f"n_prev={n_prev}")
            np.testing.assert_allclose(g.cpu().numpy(), e.numpy(), atol=2e-2, err_msg=f"n_prev={n_prev}")


@pytest.mark.cuda
def test_cuda_tensor_core_kernel_rejects(rng, cuda_device):
    c = make_case(rng, G=2, nc=8, d=32, M=8, C=32, N=128)
    dargs, _ = port_args(c, cuda_device)
    with pytest.raises(ValueError, match="bf16 kernel"):
        K.pq_chunk_history_attention(*dargs, 64, 0.2, precision="bf16")
    out, _ = K.pq_chunk_history_attention(*dargs, 64, 0.2)  # the f32 kernel takes d = 32
    assert out.shape == c["q"].shape


@pytest.mark.parametrize("d,M_v,OK,OV,want", [
    (128, 32, 32, 32, "f32"),  # 32 exact channels a side (pq.outlier_k=32): past the bf16 version's 16
    (128, 32, 16, 16, "bf16"),
    (128, 32, 0, 0, "bf16"),
    (64, 16, 32, 0, "f32"),
    (128, 32, 0, 18, "f32"),
    (128, 32, 3, 3, "f32"),  # odd exact channels
    (128, 30, 0, 0, "f32"),  # M_v % 4 != 0
    (32, 8, 0, 0, "f32"),  # a head dim the bf16 version is not built for
])
def test_history_precision_routes_geometries_the_bf16_version_lacks(d, M_v, OK, OV, want):
    """A 16-bit model takes the tensor-core history partial only where that
    version is built for the geometry, the f32 version (limited by d, M and
    its shared memory alone) elsewhere; f32 models always take the f32 one.
    Both routes ask history_precision, so the card and the CPU agree."""
    q = torch.zeros((1, 6, 4, d), dtype=torch.bfloat16)
    vc = torch.zeros((1, 2, 64, M_v), dtype=torch.uint8)
    slab = lambda o: torch.zeros((1, 2, 64, o), dtype=torch.bfloat16) if o else None  # noqa: E731
    assert K.history_precision(q, vc, slab(OK), slab(OV)) == want
    assert K.mma_geometry(d, M_v, OK, OV) == (want == "bf16")
    assert K.history_precision(q.float(), vc, slab(OK), slab(OV)) == "f32"


def test_c1_geometry_through_both_history_routes(rng):
    """OK = OV = 32 with 16-bit queries: the GQA wrapper and the plain history
    route of the chunked prefill both take the f32 precision and agree."""
    c = make_case(rng, G=3, nc=6, d=64, M=16, C=64, O=32, N=128)
    args, kw = port_args(c)
    q16 = args[0].bfloat16()
    got = K.pq_chunk_history_attention(q16, *args[1:], 100, 0.125, **kw)
    want = K.pq_chunk_history_attention(q16.float(), *args[1:], 100, 0.125, precision="f32", **kw)
    plain = _history_partial(q16, *args[1:], 100, 0.125, hist_block=32, **kw)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        np.testing.assert_allclose(p.numpy(), w.numpy(), atol=1e-5)


# the C1 geometry: 32 exact channels a side, which the bf16 version is not built for
C1_CASES = {
    "c1_dm4_c128_G3": dict(G=3, nc=100, d=128, M=32, C=128, O=32, N=512),
    "c1_d64_c256_G4": dict(G=4, nc=33, d=64, M=16, C=256, O=32, N=256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_cuda_c1_geometry_takes_the_f32_version(rng, cuda_device, case):
    """16-bit queries with OK = OV = 32 launch the f32 version (they raised
    before), which matches the CPU's plain version of the same precision."""
    c = make_case(rng, bs=2, **C1_CASES[case])
    N = c["kc"].shape[-1]
    scale = 1.0 / c["q"].shape[-1] ** 0.5
    args, kw = port_args(c)
    dargs, dkw = port_args(c, cuda_device)
    args[0], dargs[0] = args[0].bfloat16(), dargs[0].bfloat16()
    for n_prev in (1, 127, N):
        want = K.pq_chunk_history_attention(*args, n_prev, scale, **kw)
        before = K.pq_chunk_attention.launches
        got = K.pq_chunk_history_attention(*dargs, n_prev, scale, **dkw)
        torch.cuda.synchronize()
        assert K.pq_chunk_attention.launches == before + 1
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4, err_msg=f"n_prev={n_prev}")

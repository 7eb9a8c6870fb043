"""Subspace widths above 8 (fault C.9): the decode and encode kernels' routes
over every geometry the reference's fused kernels take, and the port's plain
versions against million_tpu's at d_m = 16.

The plain decode (flat and paged) is held against million_tpu's f32 oracle
at atol 1e-4 and against its Pallas kernels in interpret mode, which compute
with int8 tables (the port decoding with the codebook those kernels compute
with, dequantize_table), at the tolerances of tests/test_torch_kernel.py and
tests/test_torch_paged_kernel.py: 5e-2 flat (the mean error of `out` under
2e-2 with exact channels, as the reference's own outlier test holds its
kernel) and 2e-2 paged, that test's tolerance with exact channels, for every
case (at d_m = 16 the reference kernel's int8 q moves it ~4e-3 from its own
oracle, past the 2e-3 that test gives d_m = 2 without exact channels). The plain encode is
held against million_tpu's fused encode in interpret mode and its jnp encode
at the thresholds of tests/test_torch_encode_kernel.py. Every route function
names a CUDA build for every geometry of the target set and raises for none.
Tests marked `cuda` hold the kernels against their plain versions on the
card at d_m = 16 and at the generic widths, and skip without one."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.ops.pq_attention_pallas import (
    GROUP_PAD,
    dequantize_table,
    pack_codes,
    pack_decode_table,
    pq_codes_attention_stacked as jax_stacked,
    pq_paged_attention_stacked as jax_paged_stacked,
    to_byte_plane,
)
from million_tpu.ops.pq_attention_ref import pq_decode_attention_ref as jax_ref
from million_tpu.ops.pq_encode_pallas import pq_encode_fused as jax_fused
from million_tpu.pq.ops import pq_decode as jax_decode, pq_encode as jax_encode
from million_tpu_torch.ops import pq_attention_kernel as K
from million_tpu_torch.ops import pq_chunk_attention_kernel as B3
from million_tpu_torch.ops import pq_encode_kernel as E
from million_tpu_torch.ops import pq_paged_attention_kernel as P

# d_m = 16: (d, M); codebook sizes; exact channels a side
DM16 = [(32, 2), (64, 4)]
CASES = list(itertools.product(DM16, (128, 256), (0, 16)))
IDS = [f"d{d}_M{M}_C{C}_O{O}" for (d, M), C, O in CASES]


def _t(x):
    return torch.from_numpy(np.array(x))


def bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def codebooks(rng, L, M, C, d, O):
    """(L, M, C, d_m) codebooks per side, exact channels (sorted, the same in
    every layer) with zero centroid components."""
    cents = [rng.standard_normal((L, M, C, d // M)).astype(np.float32) for _ in range(2)]
    idx = [np.sort(rng.choice(d, O, replace=False)).astype(np.int32) for _ in range(2)]
    for c, ix in zip(cents, idx):
        for ch in ix:
            c[:, ch % M, :, ch // M] = 0.0
    return cents, idx


def jax_tables(cents, C):
    direct = C <= 128
    tabs = [jax.vmap(lambda x: pack_decode_table(x, direct=direct))(jnp.asarray(c)) for c in cents]
    d_m = cents[0].shape[-1]
    deq = [np.stack([np.asarray(dequantize_table(jax.tree.map(lambda a: a[i], t), C=C, direct=direct, d_m=d_m))
                     for i in range(c.shape[0])]) for t, c in zip(tabs, cents)]
    return tabs, deq, direct


@pytest.mark.parametrize("geom", CASES, ids=IDS)
def test_flat_plain_matches_jax_oracle_and_kernel(rng, geom):
    """B1's plain version at d_m = 16 against million_tpu's f32 oracle (1e-4)
    and its Pallas kernel pq_codes_attention_stacked in interpret mode."""
    (d, M), C, O = geom
    bs, nh_k, G, L, N, n_codes, li = 1, 2, 2, 2, 512, 300, 1
    cents, idx = codebooks(rng, L, M, C, d, O)
    q = rng.standard_normal((bs, nh_k, G, d)).astype(np.float32)
    kc, vc = (rng.integers(0, C, (L, bs, nh_k, N, M)).astype(np.uint8) for _ in range(2))
    ko, vo = (bf16(rng.standard_normal((L, bs, nh_k, N, O)) * 2) for _ in range(2))
    okw = {}
    if O:
        okw = dict(k_outliers=_t(ko).bfloat16(), v_outliers=_t(vo).bfloat16(),
                   k_oidx=_t(np.stack([idx[0]] * L)), v_oidx=_t(np.stack([idx[1]] * L)))
    qs = q / np.sqrt(d)
    out, lse = K.pq_codes_attention_stacked(_t(qs), _t(kc), _t(vc), _t(cents[0]), _t(cents[1]), li, n_codes, **okw)
    # the oracle: the empty residual window leaves the quantized partial
    ookw = {}
    if O:
        ookw = dict(k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(ko[li], -1, -2), jnp.bfloat16)),
                    k_oidx=jnp.asarray(idx[0]),
                    v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(vo[li], -1, -2), jnp.bfloat16)),
                    v_oidx=jnp.asarray(idx[1]))
    zeros = jnp.zeros((bs, nh_k, 8, d), jnp.float32)
    want = jax_ref(jnp.asarray(q.reshape(bs, nh_k * G, d)), jnp.asarray(np.swapaxes(kc[li], -1, -2)),
                   jnp.asarray(np.swapaxes(vc[li], -1, -2)), jnp.asarray(cents[0][li]), jnp.asarray(cents[1][li]),
                   zeros, zeros, jnp.asarray(n_codes), jnp.asarray(0), **ookw)
    np.testing.assert_allclose(out.reshape(bs, nh_k * G, d).numpy(), np.asarray(want), atol=1e-4)
    # the TPU kernel in interpret mode, the port decoding with the codebook it computes with
    tabs, deq, direct = jax_tables(cents, C)
    q_pad = np.zeros((bs, nh_k, GROUP_PAD, d), np.float32)
    q_pad[:, :, :G] = qs
    qj = jnp.asarray(q_pad, jnp.bfloat16)
    jkw = {}
    if O:
        jkw = dict(qo=qj[..., jnp.asarray(idx[0])],
                   k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(ko, -1, -2), jnp.bfloat16)),
                   v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(vo, -1, -2), jnp.bfloat16)))
    res = jax_stacked(qj, pack_codes(jnp.asarray(np.swapaxes(kc, -1, -2))),
                      pack_codes(jnp.asarray(np.swapaxes(vc, -1, -2))), tabs[0], tabs[1], jnp.asarray(li),
                      jnp.asarray(n_codes), block=256, direct=direct, interpret=True, **jkw)
    out_j = np.array(res[0])[:, :, :G]
    if O:
        out_j[..., idx[1]] = np.asarray(res[2])[:, :, :G]
    got, got_lse = K.pq_codes_attention_stacked(
        _t(np.asarray(qj.astype(jnp.float32))[:, :, :G].copy()), _t(kc), _t(vc), _t(deq[0]), _t(deq[1]), li,
        n_codes, **okw)
    if O:
        assert np.abs(got.numpy() - out_j).mean() < 2e-2
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(res[1])[:, :, :G], rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(got.numpy(), out_j, atol=5e-2)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(res[1])[:, :, :G], atol=5e-2)


@pytest.mark.parametrize("geom", CASES, ids=IDS)
def test_paged_plain_matches_jax_oracle_and_kernel(rng, geom):
    """B4's plain version at d_m = 16 over a shuffled page table with -1
    tails and an empty slot, against million_tpu's f32 oracle per sequence
    (1e-4, residual rows merged) and its Pallas kernel
    pq_paged_attention_stacked in interpret mode."""
    (d, M), C, O = geom
    S, nh_k, G, L, ps, pps, n_pages, Lt, li = 3, 2, 2, 2, 128, 4, 14, 8, 1
    lens, rows = np.asarray([300, 129, 0], np.int32), np.asarray([5, 8, 0], np.int32)
    cents, idx = codebooks(rng, L, M, C, d, O)
    q = (rng.standard_normal((S, nh_k, G, d)) / np.sqrt(d)).astype(np.float32)
    kp, vp = (rng.integers(0, C, (L, n_pages + 1, nh_k, ps, M)).astype(np.uint8) for _ in range(2))
    ko, vo = (bf16(rng.standard_normal((L, n_pages + 1, nh_k, ps, O)) * 2) for _ in range(2))
    kres, vres = (rng.standard_normal((L, S, nh_k, Lt, d)).astype(np.float32) for _ in range(2))
    table = rng.permutation(n_pages)[: S * pps].reshape(S, pps).astype(np.int32)
    for b, n in enumerate(lens):
        table[b, -(-n // ps):] = -1
    okw = {}
    if O:
        okw = dict(k_outliers=_t(ko).bfloat16(), v_outliers=_t(vo).bfloat16(),
                   k_oidx=_t(np.stack([idx[0]] * L)), v_oidx=_t(np.stack([idx[1]] * L)))

    def port(qq, kcent, vcent, residual):
        kw = dict(okw)
        if residual:
            kw.update(k_residual=_t(kres), v_residual=_t(vres), r=_t(rows))
        return P.pq_paged_attention_stacked(_t(qq), _t(kp), _t(vp), _t(kcent), _t(vcent), li, _t(table),
                                            _t(lens), **kw)

    def contiguous(pool, b):
        pages = [p for p in table[b] if p >= 0] or [0]
        return np.concatenate([pool[li, p] for p in pages], axis=1)

    out, lse = port(q, cents[0], cents[1], True)
    for b in range(S - 1):
        ookw = {}
        if O:
            ookw = dict(
                k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(contiguous(ko, b), -1, -2), jnp.bfloat16))[None],
                v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(contiguous(vo, b), -1, -2), jnp.bfloat16))[None],
                k_oidx=jnp.asarray(idx[0]), v_oidx=jnp.asarray(idx[1]))
        want = jax_ref(jnp.asarray(q[b:b + 1].reshape(1, nh_k * G, d)),
                       jnp.asarray(np.swapaxes(contiguous(kp, b), -1, -2))[None],
                       jnp.asarray(np.swapaxes(contiguous(vp, b), -1, -2))[None],
                       jnp.asarray(cents[0][li]), jnp.asarray(cents[1][li]), jnp.asarray(kres[li, b:b + 1]),
                       jnp.asarray(vres[li, b:b + 1]), jnp.asarray(lens[b]), jnp.asarray(rows[b]), scale=1.0,
                       **ookw)
        np.testing.assert_allclose(out[b].reshape(nh_k * G, d).numpy(), np.asarray(want)[0], atol=1e-4)
    assert (out[-1].numpy() == 0).all() and (lse[-1].numpy() == -1e30).all()
    # the TPU kernel in interpret mode
    tabs, deq, direct = jax_tables(cents, C)
    q16 = bf16(q)
    q_pad = np.zeros((S, nh_k, GROUP_PAD, d), np.float32)
    q_pad[:, :, :G] = q16
    qj = jnp.asarray(q_pad, jnp.bfloat16)
    jkw = {}
    if O:
        jkw = dict(qo=jnp.take_along_axis(qj, jnp.asarray(idx[0])[None, None, None, :], axis=-1),
                   k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(ko, -1, -2), jnp.bfloat16)),
                   v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(vo, -1, -2), jnp.bfloat16)))
    res = jax_paged_stacked(qj, pack_codes(jnp.asarray(np.swapaxes(kp, -1, -2))),
                            pack_codes(jnp.asarray(np.swapaxes(vp, -1, -2))), tabs[0], tabs[1], jnp.asarray(li),
                            jnp.asarray(table), jnp.asarray(lens), direct=direct, interpret=True, **jkw)
    out_j = np.array(res[0])[:, :, :G]
    if O:
        out_j[..., idx[1]] = np.asarray(res[2])[:, :, :G]
    got, got_lse = port(q16, deq[0], deq[1], False)
    live = lens > 0
    # the paged test's exact-channel tolerance for every case here: at d_m = 16 the TPU kernel's int8
    # q alone moves it ~4e-3 from its own f32 oracle (ROADMAP C.9 measured 4.3e-3 on `out`), past the
    # 2e-3 that test gives d_m = 2 without exact channels
    tol = 2e-2
    np.testing.assert_allclose(got.numpy()[live], out_j[live], atol=tol)
    np.testing.assert_allclose(got_lse.numpy()[live], np.asarray(res[1])[:, :, :G][live], atol=tol)


ENCODE_THRESHOLDS = {"exact": (0.999, 1e-4), "fast": (0.98, 2e-3)}  # tests/test_torch_encode_kernel.py


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("d,C", [(32, 128), (64, 256)])
def test_encode_plain_matches_jax_dm16(rng, d, C, layout, precision):
    """The port's encode (the plain version on the CPU) at d_m = 16 against
    million_tpu's fused Pallas encode (interpret mode) and its jnp encode."""
    M = d // 16
    x = rng.standard_normal((2, 2, 100, d)).astype(np.float32)
    cents = rng.standard_normal((M, C, 16)).astype(np.float32)
    got = E.pq_encode_fused(_t(x), _t(cents), layout, precision).numpy()
    assert got.shape == (2, 2, 100, M) and got.dtype == np.uint8
    min_agree, rtol = ENCODE_THRESHOLDS[precision]

    def mse(codes):
        return ((np.asarray(jax_decode(jnp.asarray(codes), jnp.asarray(cents), layout)) - x) ** 2).mean()

    for name, want in (("pallas", jax_fused(jnp.asarray(x), jnp.asarray(cents), layout, interpret=True,
                                            precision=precision)),
                       ("jnp", jax_encode(jnp.asarray(x), jnp.asarray(cents), layout, precision=precision))):
        want = np.asarray(want)
        assert (got == want).mean() >= min_agree, name
        np.testing.assert_allclose(mse(got), mse(want), rtol=rtol, err_msg=name)


def test_encode_integer_inputs_equal_codes_dm16(rng):
    """Nothing rounds on integer inputs: the port and million_tpu's fused
    encode give the same codes at d_m = 16 and 32, ties to the lowest index."""
    for d_m in (16, 32):
        d, M, C = 64, 64 // d_m, 64
        x = rng.integers(-3, 4, (60, d)).astype(np.float32)
        cents = rng.integers(-3, 4, (M, C, d_m)).astype(np.float32)
        got = E.pq_encode_fused(_t(x), _t(cents), "strided", "fast").numpy()
        want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(cents), "strided", interpret=True))
        np.testing.assert_array_equal(got, want)


# the target set: head dims of the presets, every M dividing d with even d_m (and d_m = 1 for the
# encode), C 128 / 256, 0 or 16 exact channels a side, the presets' GQA groups
TARGET_D = (64, 128)
TARGET_C = (128, 256)
TARGET_O = (0, 16)
PRESET_G = (1, 3, 4, 7, 8)


def target_widths(d, encode=False):
    return [dm for dm in (1, 2, 4, 8, 16, 32, 64, 128) if dm <= d and (encode or dm % 2 == 0)]


def test_decode_route_covers_the_target_set():
    """decode_route names a build of B1 / B4's passes for every geometry of
    the target set: the d_m <= 8 builds where the main paths run them, the
    wide builds (d_m 16 natively, wider in slices) elsewhere."""
    seen = set()
    for d, C, O, G in itertools.product(TARGET_D, TARGET_C, TARGET_O, PRESET_G):
        for dm in target_widths(d):
            M = d // dm
            route = K.decode_route(d, M, M, C, C, G, O, O)
            seen.add(route.name)
            assert route.score == ("lanes" if dm <= 8 else "wide")
            assert route.value == ("dm8" if dm <= 8 else "dm16")
            if dm > 8:
                assert route.slice_width == (16 if G <= 3 else 8)
                assert route.slices * route.slice_width == dm
    assert "score[lanes]+value[dm8x1]" in seen and "score[wide]+value[dm16x1]" in seen
    # asymmetric sides: K at d_m 2, V at d_m 16
    assert K.decode_route(128, 64, 8, 256, 128, 3).name == "score[lanes]+value[dm16x1]"
    for bad in (dict(C_k=512), dict(G=9), dict(M=3)):
        kw = dict(d=128, M=8, M_v=8, C_k=256, C_v=256, G=3)
        kw.update(bad)
        with pytest.raises(ValueError):
            K.decode_route(**kw)


def test_encode_route_covers_the_target_set():
    for d, C in itertools.product(TARGET_D, TARGET_C):
        for dm in target_widths(d, encode=True):
            assert E.encode_route(dm, C) == ("tiled" if dm <= 16 else "generic")
    assert E.encode_route(6, 200) == "generic"  # widths that are not powers of two
    assert E.encode_route(4, 300) == "wide"  # C > 256: the wide build (fault C.10)
    for bad in ((4, 65537), (0, 128)):
        with pytest.raises(ValueError):
            E.encode_route(*bad)


def test_history_route_covers_the_target_set():
    """B3's route: bf16 models take its tensor-core version wherever it is
    built (M % 4 == 0 on both sides, at most 16 exact channels), the f32
    version for fewer than four wide subspaces; never refused."""
    for d, O in itertools.product(TARGET_D, TARGET_O):
        for dm in target_widths(d):
            M = d // dm
            q = torch.zeros((1, 2, 4, d), dtype=torch.bfloat16)
            codes = torch.zeros((1, 1, 8, M), dtype=torch.uint8)
            slab = torch.zeros((1, 1, 8, O)) if O else None
            want = "bf16" if M % 4 == 0 else "f32"
            assert B3.history_precision(q, codes, slab, slab, codes) == want
            assert B3.history_precision(q.float(), codes, slab, slab, codes) == "f32"


def test_bound_counts_the_table_route():
    """The operations in the decode bounds: per side the fewer of the direct
    decode (2 d a token) and the table route (2 C d for q's table or the
    per-centroid weights, then M adds a token); the direct count stands when
    the codebooks are not given, or when the table costs more (few tokens)."""
    n, d = 32353, 128
    tables = dict(M=8, M_v=8, C=256, C_v=256)
    assert K.decode_row_ops(n, d, **tables) == 2 * (2 * 256 * d + n * 8)
    assert K.decode_row_ops(10, d, **tables) == 2 * 2 * 10 * d == K.decode_row_ops(10, d)
    # exact channels: 2 a token on both sides, the value table over the other dims
    want = (2 * 128 * d + n * 8) + 2 * n * 16 + (2 * 128 * (d - 16) + n * (8 + 2 * 16))
    assert K.decode_row_ops(n, d, 16, 16, M=8, M_v=8, C=128, C_v=128) == want
    assert K.decode_flops(4, 8, 3, d, n, **tables) == 4 * 8 * 3 * K.decode_row_ops(n, d, **tables)
    assert P.paged_flops([n, 10, 0], 8, 3, d, **tables) == 8 * 3 * (
        K.decode_row_ops(n, d, **tables) + K.decode_row_ops(10, d, **tables))
    # at d_m = 16 the bytes bind: the direct count had made the operations bind
    HBM, F32 = 3.35e12, 67e12
    nbytes = K.decode_bytes(4, 8, n, 8, 8)
    assert K.decode_flops(4, 8, 3, d, n, **tables) / F32 < nbytes / HBM < K.decode_flops(4, 8, 3, d, n) / F32


def test_wide_plain_versions_on_the_cpu(rng):
    """The wrappers take the wide geometries on the CPU (their plain
    versions): d_m = 64 and 128 at d = 128, where M < 4."""
    for M in (1, 2):
        d, C = 128, 64
        cents = _t(rng.standard_normal((1, M, C, d // M)).astype(np.float32))
        codes = _t(rng.integers(0, C, (1, 1, 2, 256, M)).astype(np.uint8))
        q = _t(rng.standard_normal((1, 2, 3, d)).astype(np.float32))
        out, lse = K.pq_codes_attention_stacked(q, codes, codes, cents, cents, 0, 200)
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        x = _t(rng.standard_normal((50, d)).astype(np.float32))
        assert E.pq_encode_fused(x, cents[0], "strided").shape == (50, M)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# d_m = 16 (M = 8 at d = 128, M = 4 at d = 64) and the generic widths (32: two slices; 64: M = 2,
# code rows read byte by byte)
CUDA_GEOMS = {"d128_dm16": (128, 8, 256, 0), "d128_dm16_c128_o16": (128, 8, 128, 16),
              "d64_dm16": (64, 4, 256, 16), "d128_dm32": (128, 4, 256, 0), "d128_dm64_o16": (128, 2, 128, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("G", [3, 8])
@pytest.mark.parametrize("geom", sorted(CUDA_GEOMS))
def test_cuda_decode_kernels_match_plain(rng, cuda_device, geom, G):
    """B1 and B4 on the card against their plain versions at 1e-4."""
    d, M, C, O = CUDA_GEOMS[geom]
    cents, idx = codebooks(rng, 2, M, C, d, O)
    cents = [_t(c) for c in cents]
    dev = cuda_device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    q = _t((rng.standard_normal((2, 2, G, d)) / np.sqrt(d)).astype(np.float32))
    kc, vc = (_t(rng.integers(0, C, (2, 2, 2, 1024, M)).astype(np.uint8)) for _ in range(2))
    res = torch.randn((2, 2, 2, 32, d), generator=torch.Generator().manual_seed(3)).bfloat16()
    kw = dict(k_residual=res, v_residual=res * 2, r=11)
    if O:
        kw.update(k_outliers=torch.randn((2, 2, 2, 1024, O), generator=torch.Generator().manual_seed(4)).bfloat16(),
                  v_outliers=torch.randn((2, 2, 2, 1024, O), generator=torch.Generator().manual_seed(5)).bfloat16(),
                  k_oidx=_t(np.stack([idx[0]] * 2)), v_oidx=_t(np.stack([idx[1]] * 2)))
    on = lambda v: v.to(dev) if torch.is_tensor(v) else v  # noqa: E731
    args = (q, kc, vc, cents[0], cents[1], 1, 1000)
    want = K.pq_codes_attention_plain(*args, **kw, n_sm=n_sm)
    got = K.pq_codes_attention_stacked(*[on(a) for a in args], **{k: on(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4)
    # B4: two slots over 256-token pages
    table = _t(np.asarray([[3, 0, 5, 1], [2, 4, -1, -1]], np.int32))
    pools = [_t(rng.integers(0, C, (2, 7, 2, 256, M)).astype(np.uint8)) for _ in range(2)]
    pkw = dict(k_residual=res, v_residual=res * 2, r=_t(np.asarray([7, 0], np.int32)))
    if O:
        pkw.update(k_outliers=torch.randn((2, 7, 2, 256, O), generator=torch.Generator().manual_seed(6)).bfloat16(),
                   v_outliers=torch.randn((2, 7, 2, 256, O), generator=torch.Generator().manual_seed(7)).bfloat16(),
                   k_oidx=kw["k_oidx"], v_oidx=kw["v_oidx"])
    pargs = (q, pools[0], pools[1], cents[0], cents[1], 1, table, _t(np.asarray([1000, 300], np.int32)))
    want = P.pq_paged_attention_plain(*pargs, **pkw, n_sm=n_sm)
    got = P.pq_paged_attention_stacked(*[on(a) for a in pargs], **{k: on(v) for k, v in pkw.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d_m", [16, 32, 64, 128])
def test_cuda_encode_matches_plain(rng, cuda_device, d_m):
    """B7 at d_m 16 (the tiled build) and at the generic widths, against the
    plain version: >= 99.9 % equal codes on gaussian inputs, bit-equal on
    integer inputs."""
    d, C = 128, 256
    M = d // d_m
    x = _t(rng.standard_normal((2, 3, 500, d)).astype(np.float32)).bfloat16()
    cents = _t(rng.standard_normal((M, C, d_m)).astype(np.float32))
    want = E.pq_encode_fused(x, cents, "strided", "fast").numpy()
    got = E.pq_encode_fused(x.to(cuda_device), cents.to(cuda_device), "strided", "fast")
    assert (got.cpu().numpy() == want).mean() >= 0.999
    xi = _t(rng.integers(-4, 5, (300, d)).astype(np.float32))
    ci = _t(rng.integers(-4, 5, (M, C, d_m)).astype(np.float32))
    for layout, precision in (("strided", "fast"), ("contiguous", "exact")):
        np.testing.assert_array_equal(
            E.pq_encode_fused(xi.to(cuda_device), ci.to(cuda_device), layout, precision).cpu().numpy(),
            E.pq_encode_fused(xi, ci, layout, precision).numpy())

"""The port's PQ decode-attention kernel module against million_tpu.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
tightly (atol 1e-4) against million_tpu's f32 oracle pq_decode_attention_ref
(with an empty residual window, so the merged output is the quantized
partial) and loosely (5e-2) against the TPU kernel in interpret mode, which
computes with int8 tables and int8 q. Tests marked `cuda` hold the CUDA
kernel against the plain version on the card and skip without one."""

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
    to_byte_plane,
)
from million_tpu.ops.pq_attention_ref import pq_decode_attention_ref as jax_ref
from million_tpu_torch import convert
from million_tpu_torch.ops import pq_attention_kernel as K


def _t(x):
    return torch.from_numpy(np.array(x))


def make_case(rng, *, bs=2, nh_k=2, G=2, d=16, M=8, C=32, M_v=None, C_v=None,
              O=0, N=128, L=2):
    """Random inputs in the port's layouts (numpy). Outlier channels get
    zero centroid components, the production contract."""
    M_v = M_v or M
    C_v = C_v or C
    c = dict(
        q=rng.standard_normal((bs, nh_k * G, d)).astype(np.float32),
        kc=rng.integers(0, C, (L, bs, nh_k, N, M)).astype(np.uint8),
        vc=rng.integers(0, C_v, (L, bs, nh_k, N, M_v)).astype(np.uint8),
        kcent=rng.standard_normal((L, M, C, d // M)).astype(np.float32),
        vcent=rng.standard_normal((L, M_v, C_v, d // M_v)).astype(np.float32),
    )
    if O:
        bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
        c["ko"] = bf(rng.standard_normal((L, bs, nh_k, N, O)) * 2)
        c["vo"] = bf(rng.standard_normal((L, bs, nh_k, N, O)) * 2)
        c["koidx"] = np.stack([np.sort(rng.choice(d, O, replace=False)) for _ in range(L)]).astype(np.int32)
        c["voidx"] = np.stack([np.sort(rng.choice(d, O, replace=False)) for _ in range(L)]).astype(np.int32)
        for li in range(L):
            for ch in c["koidx"][li]:
                c["kcent"][li, ch % M, :, ch // M] = 0.0
            for ch in c["voidx"][li]:
                c["vcent"][li, ch % M_v, :, ch // M_v] = 0.0
    return c


def port_call(c, layer, n_codes, fn=K.pq_codes_attention_stacked, **kw):
    bs, nh, d = c["q"].shape
    nh_k = c["kc"].shape[2]
    qg = _t((c["q"] / np.sqrt(d)).astype(np.float32)).reshape(bs, nh_k, nh // nh_k, d)
    okw = {}
    if "ko" in c:
        okw = dict(k_outliers=_t(c["ko"]).bfloat16(), v_outliers=_t(c["vo"]).bfloat16(),
                   k_oidx=_t(c["koidx"]), v_oidx=_t(c["voidx"]))
    return fn(qg, _t(c["kc"]), _t(c["vc"]), _t(c["kcent"]), _t(c["vcent"]),
              layer, n_codes, **okw, **kw)


def jax_oracle(c, layer, n_codes, r=0):
    bs, nh, d = c["q"].shape
    _, _, nh_k, N, _ = c["kc"].shape
    okw = {}
    if "ko" in c:
        okw = dict(
            k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(c["ko"][layer], -1, -2), jnp.bfloat16)),
            k_oidx=jnp.asarray(c["koidx"][layer]),
            v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(c["vo"][layer], -1, -2), jnp.bfloat16)),
            v_oidx=jnp.asarray(c["voidx"][layer]),
        )
    kres = c.get("kres", np.zeros((c["kc"].shape[0], bs, nh_k, 8, d), np.float32))[layer]
    vres = c.get("vres", np.zeros((c["kc"].shape[0], bs, nh_k, 8, d), np.float32))[layer]
    out = jax_ref(
        jnp.asarray(c["q"]),
        jnp.asarray(np.swapaxes(c["kc"][layer], -1, -2)),
        jnp.asarray(np.swapaxes(c["vc"][layer], -1, -2)),
        jnp.asarray(c["kcent"][layer]), jnp.asarray(c["vcent"][layer]),
        jnp.asarray(kres), jnp.asarray(vres), jnp.asarray(n_codes), jnp.asarray(r), **okw,
    )
    return np.asarray(out)


GEOMETRIES = {
    "dm2_C32": dict(M=8, C=32),
    "dm4_C64_outliers": dict(M=4, C=64, O=4),
    "asym_Mv4": dict(M=8, C=32, M_v=4, C_v=64),
}


@pytest.mark.parametrize("n_codes", [0, 44, 128])
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_plain_matches_jax_oracle(rng, geom, n_codes):
    c = make_case(rng, **GEOMETRIES[geom])
    out, lse = port_call(c, 1, n_codes)
    bs, nh, d = c["q"].shape
    want = jax_oracle(c, 1, n_codes)
    np.testing.assert_allclose(out.reshape(bs, nh, d).numpy(), want, atol=1e-4)
    if n_codes == 0:
        assert (lse.numpy() == -1e30).all()


@pytest.mark.parametrize("n_codes,r", [(0, 3), (44, 1), (128, 8)])
@pytest.mark.parametrize("geom", ["dm2_C32", "dm4_C64_outliers"])
def test_plain_with_residual_matches_jax_oracle(rng, geom, n_codes, r):
    """With the residual window passed in, the call is the whole decode
    attention: codes partial and exact residual rows, LSE-merged."""
    c = make_case(rng, **GEOMETRIES[geom])
    L, bs, nh_k = c["kc"].shape[:3]
    d = c["q"].shape[-1]
    c["kres"] = rng.standard_normal((L, bs, nh_k, 8, d)).astype(np.float32)
    c["vres"] = rng.standard_normal((L, bs, nh_k, 8, d)).astype(np.float32)
    out, _ = port_call(c, 1, n_codes, k_residual=_t(c["kres"]), v_residual=_t(c["vres"]), r=r)
    want = jax_oracle(c, 1, n_codes, r)
    np.testing.assert_allclose(out.reshape(want.shape).numpy(), want, atol=1e-4)


@pytest.mark.parametrize("n_split,want_splits", [(1, 1), (3, 3), (8, 8)])
def test_plain_split_count_does_not_change_result(rng, n_split, want_splits):
    c = make_case(rng, M=4, C=64, O=4, N=2048)
    ref_out, ref_lse = port_call(c, 0, 2000, n_split=1)
    out, lse = port_call(c, 0, 2000, n_split=n_split)
    S, chunk = K.plan_splits(2000, 4, n_split=n_split)
    assert S == want_splits and chunk % K.TILE == 0 and S * chunk >= 2000
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=1e-5)


def test_single_layer_entry_matches_stacked(rng):
    c = make_case(rng, M=4, C=64, O=4)
    one = {k: v[1] for k, v in c.items() if k != "q"}
    one["q"] = c["q"]
    bs, nh, d = c["q"].shape
    qg = _t(c["q"] / np.sqrt(d)).reshape(bs, 2, nh // 2, d)
    out1, lse1 = K.pq_codes_attention(
        qg, _t(one["kc"]), _t(one["vc"]), _t(one["kcent"]), _t(one["vcent"]), 60,
        k_outliers=_t(one["ko"]).bfloat16(), v_outliers=_t(one["vo"]).bfloat16(),
        k_oidx=_t(one["koidx"]), v_oidx=_t(one["voidx"]))
    out2, lse2 = port_call(c, 1, 60)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())
    np.testing.assert_array_equal(lse1.numpy(), lse2.numpy())


def test_plain_matches_tpu_kernel_interpret(rng):
    """Loose parity with the TPU kernel itself (int8 tables, int8 q, bf16 q
    planes), run in interpret mode at one tiny shape."""
    bs, nh_k, G, d, M, C, N, L, n_codes = 1, 2, 2, 16, 8, 32, 256, 2, 200
    c = make_case(rng, bs=bs, nh_k=nh_k, G=G, d=d, M=M, C=C, N=N, L=L)
    scale = 1.0 / np.sqrt(d)
    qg = (c["q"] * scale).reshape(bs, nh_k, G, d)
    q_pad = np.zeros((bs, nh_k, GROUP_PAD, d), np.float32)
    q_pad[:, :, :G] = qg
    tabs = [jax.vmap(lambda x: pack_decode_table(x, direct=True))(jnp.asarray(c[k]))
            for k in ("kcent", "vcent")]
    out_j, lse_j = jax_stacked(
        jnp.asarray(q_pad, jnp.bfloat16),
        pack_codes(jnp.asarray(np.swapaxes(c["kc"], -1, -2))),
        pack_codes(jnp.asarray(np.swapaxes(c["vc"], -1, -2))),
        tabs[0], tabs[1], jnp.asarray(1), jnp.asarray(n_codes),
        block=128, direct=True, interpret=True,
    )
    out, lse = port_call(c, 1, n_codes)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j)[:, :, :G], atol=5e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :G], atol=5e-2)


@pytest.mark.parametrize("O", [1, 7, 8])
def test_plain_with_exact_channels_matches_tpu_kernel_interpret(rng, O):
    """Odd and even exact-channel counts (OK = OV = 1, 7, 8): the port's
    plain decode attention against the TPU kernel in interpret mode, the
    inputs made in the reference's at-rest formats (packed code words,
    byte-plane outlier slabs) and converted with `convert`, the port
    decoding with the codebook that kernel computes with (dequantize_table).
    Tolerance as the reference's own outlier test holds its kernel
    (tests/test_pallas_kernel.py): 2e-2 on the mean error of `out`, 2e-2 on
    `lse`."""
    bs, nh_k, G, d, M, C, L, N, n_codes, li = 1, 2, 2, 32, 8, 128, 2, 512, 300, 1
    q = rng.standard_normal((bs, nh_k, GROUP_PAD, d)).astype(np.float32)
    kc = rng.integers(0, C, (L, bs, nh_k, M, N)).astype(np.uint8)
    vc = rng.integers(0, C, (L, bs, nh_k, M, N)).astype(np.uint8)
    kcent = rng.standard_normal((L, M, C, d // M)).astype(np.float32)
    vcent = rng.standard_normal((L, M, C, d // M)).astype(np.float32)
    ko = (rng.standard_normal((L, bs, nh_k, O, N)) * 2).astype(np.float32)
    vo = (rng.standard_normal((L, bs, nh_k, O, N)) * 2).astype(np.float32)
    koidx = np.sort(rng.choice(d, O, replace=False)).astype(np.int32)
    voidx = np.sort(rng.choice(d, O, replace=False)).astype(np.int32)
    for ch in koidx:
        kcent[:, ch % M, :, ch // M] = 0.0
    for ch in voidx:
        vcent[:, ch % M, :, ch // M] = 0.0
    tabs = [jax.vmap(lambda x: pack_decode_table(x, direct=True))(jnp.asarray(x)) for x in (kcent, vcent)]
    words = [pack_codes(jnp.asarray(x)) for x in (kc, vc)]
    planes = [to_byte_plane(jnp.asarray(x, jnp.bfloat16)) for x in (ko, vo)]
    qj = jnp.asarray(q / np.sqrt(d), jnp.bfloat16)
    out_j, lse_j, co_j = jax_stacked(
        qj, words[0], words[1], tabs[0], tabs[1], jnp.asarray(li), jnp.asarray(n_codes),
        block=256, direct=True, interpret=True, qo=qj[..., jnp.asarray(koidx)],
        k_outliers=planes[0], v_outliers=planes[1])
    want = np.array(out_j)[:, :, :G]
    want[..., voidx] = np.asarray(co_j)[:, :, :G]

    deq = [np.stack([np.asarray(dequantize_table(jax.tree.map(lambda a: a[i], tab), C=C, direct=True,
                                                 d_m=d // M)) for i in range(L)]) for tab in tabs]
    codes = [np.ascontiguousarray(np.swapaxes(convert.unpack_codes(np.asarray(w)), -1, -2)) for w in words]
    slabs = [convert.from_byte_plane(np.asarray(pl.astype(jnp.float32))) for pl in planes]
    out, lse = K.pq_codes_attention_stacked(
        torch.from_numpy(np.asarray(qj.astype(jnp.float32))[:, :, :G].copy()),
        *[_t(x) for x in codes], *[_t(x) for x in deq], li, n_codes,
        k_outliers=_t(slabs[0]).bfloat16(), v_outliers=_t(slabs[1]).bfloat16(),
        k_oidx=_t(np.stack([koidx] * L)), v_oidx=_t(np.stack([voidx] * L)))
    assert np.abs(out.numpy() - want).mean() < 2e-2
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :G], rtol=2e-2, atol=2e-2)


def test_converters_invert_jax_packing(rng):
    codes = rng.integers(0, 256, (2, 3, 8, 64)).astype(np.uint8)  # (.., M, N)
    words = np.asarray(pack_codes(jnp.asarray(codes)))
    np.testing.assert_array_equal(convert.unpack_codes(words), codes)
    np.testing.assert_array_equal(convert.arena_from_words(words), np.swapaxes(codes, -1, -2))
    slab = rng.standard_normal((2, 3, 5, 64)).astype(np.float32)  # (.., O, N)
    planes = np.asarray(to_byte_plane(jnp.asarray(slab)))
    np.testing.assert_array_equal(convert.from_byte_plane(planes), np.swapaxes(slab, -1, -2))


def test_wrapper_rejects_other_devices(rng):
    c = make_case(rng)
    q = torch.zeros((2, 2, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.pq_codes_attention_stacked(q, _t(c["kc"]), _t(c["vc"]), _t(c["kcent"]),
                                     _t(c["vcent"]), 0, 8)
    with pytest.raises(ValueError, match="go together"):
        port_call(c, 0, 8, k_outliers=_t(c["kc"]))


def test_bound_counts():
    assert K.decode_bytes(1, 8, 32768, 64, 64) == 8 * 32768 * 128
    assert K.decode_bytes(1, 8, 32768, 32, 32, 16, 16) == 8 * 32768 * 128
    assert K.decode_flops(1, 1, 3, 128, 10) == 2 * 3 * 10 * 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_cuda_kernel_matches_plain(rng, cuda_device, geom):
    c = make_case(rng, N=1024, **GEOMETRIES[geom])
    bs, nh, d = c["q"].shape
    qg = _t((c["q"] / np.sqrt(d)).astype(np.float32)).reshape(bs, 2, nh // 2, d)
    args = [qg, _t(c["kc"]), _t(c["vc"]), _t(c["kcent"]), _t(c["vcent"])]
    okw = {}
    if "ko" in c:
        okw = dict(k_outliers=_t(c["ko"]).bfloat16(), v_outliers=_t(c["vo"]).bfloat16(),
                   k_oidx=_t(c["koidx"]), v_oidx=_t(c["voidx"]))
    res = torch.randn((2, 2, 2, 16, 16), generator=torch.Generator().manual_seed(0))
    for n_codes, r, rdt in ((0, 0, None), (500, 0, None), (1024, 0, None), (0, 5, torch.bfloat16),
                            (500, 16, torch.float32), (1024, 1, torch.bfloat16)):
        if rdt is not None:
            okw = {**okw, "k_residual": res.to(rdt), "v_residual": (2 * res).to(rdt), "r": r}
        want = K.pq_codes_attention_plain(*args, 1, n_codes, **okw)
        before = K.pq_codes_attention_stacked.launches
        got = K.pq_codes_attention_stacked(
            *[a.to(cuda_device) for a in args], 1, n_codes,
            **{k: v.to(cuda_device) if torch.is_tensor(v) else v for k, v in okw.items()})
        torch.cuda.synchronize()
        assert K.pq_codes_attention_stacked.launches == before + 1
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("G,d,M,O", [(1, 64, 32, 0), (4, 128, 32, 16), (5, 64, 16, 2), (8, 128, 64, 0)])
def test_cuda_kernel_group_sizes(rng, cuda_device, G, d, M, O):
    """Other GQA groups and head dims of the presets (llama-2: G=1, llama-3.1:
    G=4, qwen2: G=7, tinyllama: G=8, d=64), with the residual window."""
    c = make_case(rng, G=G, d=d, M=M, C=256, O=O, N=700)
    bs, nh, _ = c["q"].shape
    qg = _t((c["q"] / np.sqrt(d)).astype(np.float32)).reshape(bs, 2, G, d)
    res = torch.randn((2, bs, 2, 32, d), generator=torch.Generator().manual_seed(1)).bfloat16()
    args = [qg, _t(c["kc"]), _t(c["vc"]), _t(c["kcent"]), _t(c["vcent"]), 0, 652]
    kw = dict(k_residual=res, v_residual=res * 2, r=20)
    if O:
        kw.update(k_outliers=_t(c["ko"]).bfloat16(), v_outliers=_t(c["vo"]).bfloat16(),
                  k_oidx=_t(c["koidx"]), v_oidx=_t(c["voidx"]))
    want = K.pq_codes_attention_plain(*args, **kw)
    got = K.pq_codes_attention_stacked(
        *[a.to(cuda_device) if torch.is_tensor(a) else a for a in args],
        **{k: v.to(cuda_device) if torch.is_tensor(v) else v for k, v in kw.items()})
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("O,N,n_codes", [(7, 1024, 1000), (15, 1024, 517), (1, 700, 652), (7, 701, 701)])
def test_cuda_kernel_odd_exact_channels(rng, cuda_device, O, N, n_codes):
    """Odd exact-channel counts (OK = OV = O): a tile's outlier rows are one
    span of nt * O * 2 bytes, copied whatever its alignment (N = 701 puts
    the spans of most (b, h) rows off 16-byte boundaries), held against the
    plain version at 1e-5 on `out` and `lse` (both f32, the same splits)."""
    c = make_case(rng, G=3, d=32, M=8, C=64, O=O, N=N)
    bs, nh, d = c["q"].shape
    qg = _t((c["q"] / np.sqrt(d)).astype(np.float32)).reshape(bs, 2, 3, d)
    res = torch.randn((2, bs, 2, 16, d), generator=torch.Generator().manual_seed(2)).bfloat16()
    args = [qg, _t(c["kc"]), _t(c["vc"]), _t(c["kcent"]), _t(c["vcent"]), 1, n_codes]
    kw = dict(k_outliers=_t(c["ko"]).bfloat16(), v_outliers=_t(c["vo"]).bfloat16(),
              k_oidx=_t(c["koidx"]), v_oidx=_t(c["voidx"]), k_residual=res, v_residual=res * 2, r=9)
    want = K.pq_codes_attention_plain(
        *args, **kw, n_sm=torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    got = K.pq_codes_attention_stacked(
        *[a.to(cuda_device) if torch.is_tensor(a) else a for a in args],
        **{k: v.to(cuda_device) if torch.is_tensor(v) else v for k, v in kw.items()})
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-5)

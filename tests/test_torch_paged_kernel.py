"""The port's paged PQ decode-attention module against million_tpu.

On the CPU the wrapper runs the kernel's plain PyTorch version. It is held
(a) at 1e-5 against the port's flat plain version on the same codes laid out
contiguously (f32 both, at most the summation order of the splits differs),
(b) at 1e-4 against million_tpu's f32 oracle pq_decode_attention_ref on the
materialised codes, and (c) against the TPU kernel pq_paged_attention_stacked
in interpret mode at that kernel's own tolerance (it computes with int8
tables and int8 q: 2e-3 as tests/test_paged_cache.py holds it, 2e-2 with
outlier pools), the port decoding with the codebook the TPU kernel computes
with (dequantize_table). Ragged lengths, shuffled tables, -1 tails, a slot
with no codes and M_v != M are covered. Tests marked `cuda` hold the CUDA
kernel against the plain version on the card and skip without one."""

from types import SimpleNamespace

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
    pq_paged_attention_stacked as jax_paged_stacked,
    to_byte_plane,
)
from million_tpu.ops.pq_attention_ref import pq_decode_attention_ref as jax_ref
from million_tpu_torch.ops import pq_attention_kernel as K
from million_tpu_torch.ops import pq_paged_attention_kernel as P


def _t(x):
    return torch.from_numpy(np.array(x))


def make_case(rng, *, S=3, nh_k=2, G=2, d=16, M=8, C=32, M_v=None, C_v=None, O=0, ps=128,
              pps=4, n_pages=14, L=2, Lt=8, lens=(300, 129, 0), rows=(5, 8, 0)):
    """Random pools, a shuffled page table with -1 tails, per-slot lengths
    and residual rows, in the port's layouts (numpy). Outlier channels get
    zero centroid components, the production contract."""
    M_v, C_v = M_v or M, C_v or C
    c = dict(
        q=(rng.standard_normal((S, nh_k, G, d)) / np.sqrt(d)).astype(np.float32),
        kp=rng.integers(0, C, (L, n_pages + 1, nh_k, ps, M)).astype(np.uint8),
        vp=rng.integers(0, C_v, (L, n_pages + 1, nh_k, ps, M_v)).astype(np.uint8),
        kcent=rng.standard_normal((L, M, C, d // M)).astype(np.float32),
        vcent=rng.standard_normal((L, M_v, C_v, d // M_v)).astype(np.float32),
        kres=rng.standard_normal((L, S, nh_k, Lt, d)).astype(np.float32),
        vres=rng.standard_normal((L, S, nh_k, Lt, d)).astype(np.float32),
        n_codes=np.asarray(lens, np.int32), r=np.asarray(rows, np.int32),
    )
    table = rng.permutation(n_pages)[: S * pps].reshape(S, pps).astype(np.int32)
    for b, n in enumerate(lens):
        table[b, -(-n // ps):] = -1
    c["table"] = table
    if O:
        bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
        c["ko"] = bf(rng.standard_normal((L, n_pages + 1, nh_k, ps, O)) * 2)
        c["vo"] = bf(rng.standard_normal((L, n_pages + 1, nh_k, ps, O)) * 2)
        c["koidx"] = np.stack([np.sort(rng.choice(d, O, replace=False)) for _ in range(L)]).astype(np.int32)
        c["voidx"] = np.stack([np.sort(rng.choice(d, O, replace=False)) for _ in range(L)]).astype(np.int32)
        for li in range(L):
            for ch in c["koidx"][li]:
                c["kcent"][li, ch % M, :, ch // M] = 0.0
            for ch in c["voidx"][li]:
                c["vcent"][li, ch % M_v, :, ch // M_v] = 0.0
    return c


def port_args(c, dev="cpu", residual=True):
    to = lambda a: _t(a).to(dev)  # noqa: E731
    args = [to(c[k]) for k in ("q", "kp", "vp", "kcent", "vcent")]
    kw = {}
    if residual:
        kw.update(k_residual=to(c["kres"]), v_residual=to(c["vres"]), r=to(c["r"]))
    if "ko" in c:
        kw.update(k_outliers=to(c["ko"]).bfloat16(), v_outliers=to(c["vo"]).bfloat16(),
                  k_oidx=to(c["koidx"]), v_oidx=to(c["voidx"]))
    return args, to(c["table"]), to(c["n_codes"]), kw


def port_call(c, layer, fn=P.pq_paged_attention_stacked, residual=True, **extra):
    args, table, n_codes, kw = port_args(c, residual=residual)
    return fn(*args, layer, table, n_codes, **kw, **extra)


def contiguous(c, key, layer, b):
    """Sequence b's pages of one pool laid out in table order: (nh_k, N, X)."""
    pages = [p for p in c["table"][b] if p >= 0] or [0]
    return np.concatenate([c[key][layer, p] for p in pages], axis=1)


GEOMETRIES = {
    "dm2_C32": dict(M=8, C=32),
    "dm4_C64_outliers": dict(M=4, C=64, O=4),
    "asym_Mv4": dict(M=8, C=32, M_v=4, C_v=64),
}
MODES = {"default": {}, "kpp2": dict(kpp=2), "three_splits": dict(n_split=3)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_plain_matches_flat_plain(rng, geom, mode):
    """Through the page table == over the same codes laid out contiguously."""
    c = make_case(rng, **GEOMETRIES[geom])
    out, lse = port_call(c, 1, **MODES[mode])
    for b, n in enumerate(c["n_codes"]):
        kw = dict(k_residual=_t(c["kres"][1:, b:b + 1]), v_residual=_t(c["vres"][1:, b:b + 1]),
                  r=int(c["r"][b]))
        if "ko" in c:
            kw.update(k_outliers=_t(contiguous(c, "ko", 1, b))[None, None].bfloat16(),
                      v_outliers=_t(contiguous(c, "vo", 1, b))[None, None].bfloat16(),
                      k_oidx=_t(c["koidx"][1:]), v_oidx=_t(c["voidx"][1:]))
        want_out, want_lse = K.pq_codes_attention_plain(
            _t(c["q"][b:b + 1]), _t(contiguous(c, "kp", 1, b))[None, None],
            _t(contiguous(c, "vp", 1, b))[None, None], _t(c["kcent"][1:]), _t(c["vcent"][1:]), 0,
            int(n), **kw)
        np.testing.assert_allclose(out[b].numpy(), want_out[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(lse[b].numpy(), want_lse[0].numpy(), atol=1e-5)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_plain_matches_jax_oracle(rng, geom):
    """Against million_tpu's f32 oracle on the materialised codes, residual
    rows merged; the slot with no codes and no rows is (0, -1e30)."""
    c = make_case(rng, **GEOMETRIES[geom])
    out, lse = port_call(c, 1)
    S, nh_k, G, d = c["q"].shape
    for b in range(S - 1):
        okw = {}
        if "ko" in c:
            okw = dict(
                k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(contiguous(c, "ko", 1, b), -1, -2),
                                                     jnp.bfloat16))[None],
                v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(contiguous(c, "vo", 1, b), -1, -2),
                                                     jnp.bfloat16))[None],
                k_oidx=jnp.asarray(c["koidx"][1]), v_oidx=jnp.asarray(c["voidx"][1]))
        want = jax_ref(
            jnp.asarray(c["q"][b:b + 1].reshape(1, nh_k * G, d)),
            jnp.asarray(np.swapaxes(contiguous(c, "kp", 1, b), -1, -2))[None],
            jnp.asarray(np.swapaxes(contiguous(c, "vp", 1, b), -1, -2))[None],
            jnp.asarray(c["kcent"][1]), jnp.asarray(c["vcent"][1]),
            jnp.asarray(c["kres"][1, b:b + 1]), jnp.asarray(c["vres"][1, b:b + 1]),
            jnp.asarray(c["n_codes"][b]), jnp.asarray(c["r"][b]), scale=1.0, **okw)
        np.testing.assert_allclose(out[b].reshape(nh_k * G, d).numpy(), np.asarray(want)[0], atol=1e-4)
    assert (out[-1].numpy() == 0).all() and (lse[-1].numpy() == -1e30).all()
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("O,tol", [(0, 2e-3), (4, 2e-2), (7, 2e-2), (1, 2e-2)])
def test_plain_matches_tpu_paged_kernel_interpret(rng, O, tol):
    """Against the TPU kernel itself in interpret mode (direct int8 tables,
    int8 q), the port decoding with the codebook that kernel computes with;
    odd exact-channel counts (O = 7, 1) as well as even ones."""
    d, M, C, G = 16, 8, 32, 2
    c = make_case(rng, d=d, M=M, C=C, G=G, O=O)
    q16 = np.asarray(jnp.asarray(c["q"], jnp.bfloat16).astype(jnp.float32))
    S, nh_k = q16.shape[:2]
    q_pad = np.zeros((S, nh_k, GROUP_PAD, d), np.float32)
    q_pad[:, :, :G] = q16
    tabs = [jax.vmap(lambda x: pack_decode_table(x, direct=True))(jnp.asarray(c[k]))
            for k in ("kcent", "vcent")]
    okw = {}
    if O:
        qj = jnp.asarray(q_pad, jnp.bfloat16)
        okw = dict(qo=jnp.take_along_axis(qj, jnp.asarray(c["koidx"][1])[None, None, None, :], axis=-1),
                   k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(c["ko"], -1, -2), jnp.bfloat16)),
                   v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(c["vo"], -1, -2), jnp.bfloat16)))
    res = jax_paged_stacked(
        jnp.asarray(q_pad, jnp.bfloat16), pack_codes(jnp.asarray(np.swapaxes(c["kp"], -1, -2))),
        pack_codes(jnp.asarray(np.swapaxes(c["vp"], -1, -2))), tabs[0], tabs[1], jnp.asarray(1),
        jnp.asarray(c["table"]), jnp.asarray(c["n_codes"]), direct=True, interpret=True, **okw)
    out_j = np.array(res[0])[:, :, :G]
    if O:
        out_j[..., c["voidx"][1]] = np.asarray(res[2])[:, :, :G]
    deq = dict(c, q=q16)
    for key, tab in (("kcent", tabs[0]), ("vcent", tabs[1])):
        deq[key] = np.stack([np.asarray(dequantize_table(jax.tree.map(lambda a: a[li], tab), C=C,
                                                         direct=True, d_m=d // M))
                             for li in range(c[key].shape[0])])
    out, lse = port_call(deq, 1, residual=False)
    live = c["n_codes"] > 0
    np.testing.assert_allclose(out.numpy()[live], out_j[live], atol=tol)
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(res[1])[:, :, :G][live], atol=tol)


@pytest.mark.parametrize("kpp", [2, 4])
def test_kpp_mode_equals_default_mode(rng, kpp):
    """The pages-per-block mode against the default mode on ragged lengths
    and shuffled tables, as tests/test_pallas_kernel.py holds the TPU's
    multi-page kernel against its single-page one (there at 1e-3: int8
    tables; here both are f32 and differ by the splits' summation order)."""
    ps = 128
    c = make_case(rng, S=2, d=32, M=16, C=256, ps=ps, pps=6, n_pages=12, L=3,
                  lens=(5 * ps + 37, 2 * ps), rows=(0, 0))
    out_a, lse_a = port_call(c, 1, residual=False)
    out_b, lse_b = port_call(c, 1, fn=P.pq_paged_attention_stacked_mp, residual=False, kpp=kpp)
    np.testing.assert_allclose(out_b.numpy(), out_a.numpy(), atol=1e-5)
    np.testing.assert_allclose(lse_b.numpy(), lse_a.numpy(), atol=1e-5)
    S, fixed = P.plan_paged_splits(6 * ps, 4, ps, kpp=kpp)
    assert fixed == kpp * ps and S * fixed >= 6 * ps


def test_single_layer_entry_matches_stacked(rng):
    c = make_case(rng, M=4, C=64, O=4)
    args, table, n_codes, kw = port_args(c)
    one = {k: (v[1] if k != "r" else v) for k, v in kw.items()}
    out1, lse1 = P.pq_paged_attention(args[0], *[a[1] for a in args[1:]], table, n_codes, **one)
    out2, lse2 = port_call(c, 1)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())
    np.testing.assert_array_equal(lse1.numpy(), lse2.numpy())


def test_n_bound_only_sizes_the_launch(rng):
    """A tighter host bound that still covers every sequence changes nothing
    but the split plan; a bound below a sequence's length cuts it there."""
    c = make_case(rng, lens=(300, 129, 0))
    ref = port_call(c, 0)
    got = port_call(c, 0, n_bound=384)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=1e-5)
    cut = port_call(c, 0, n_bound=256)
    short = port_call(dict(c, n_codes=np.asarray([256, 129, 0], np.int32)), 0)
    np.testing.assert_allclose(cut[0].numpy(), short[0].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="n_bound"):
        port_call(c, 0, n_bound=10**6)


def test_split_plan_and_bound_counts():
    # six slots of 8 KV heads on 132 SMs: 384 blocks in three waves of 4096 tokens beat one
    # wave of 96 blocks of 16384; one slot: one wave of 128 blocks
    assert P.plan_paged_splits(32768, 48, 2048, n_sm=132) == (8, 0)
    assert P.plan_paged_splits(32768, 8, 2048, n_sm=132) == (16, 0)
    assert P.plan_paged_splits(32768, 48, 2048, n_sm=132, n_split=2) == (2, 0)
    assert P.plan_paged_splits(32768, 48, 2048, kpp=2) == (8, 4096)
    assert P.plan_paged_splits(100, 1, 128) == (1, 0) == P.plan_paged_splits(0, 1, 128)
    assert P.plan_paged_splits(600, 1, 128, n_split=8) == (3, 0)  # never more splits than tiles
    assert P.seq_chunk(32640, 2) == 16384 and P.seq_chunk(516, 2) == 512 and P.seq_chunk(0, 2) == 256
    assert P.seq_chunk(516, 2, 4096) == 4096
    lens = [32640] * 6
    assert P.paged_bytes(lens, 8, 64, 64) == P.paged_bytes(lens, 8, 32, 32, 16, 16) == 6 * 32640 * 8 * 128
    assert P.paged_flops([10, 0], 1, 3, 128) == 2 * 10 * 3 * 256


def test_wrapper_rejects_what_it_cannot_take(rng):
    c = make_case(rng)
    args, table, n_codes, kw = port_args(c)
    with pytest.raises(ValueError, match="unsupported device"):
        P.pq_paged_attention_stacked(torch.zeros((3, 2, 2, 16), device="meta"), *args[1:], 0, table, n_codes)
    with pytest.raises(ValueError, match="go together"):
        P.pq_paged_attention_stacked(*args, 0, table, n_codes, k_residual=kw["k_residual"])
    with pytest.raises(ValueError, match="go together"):
        P.pq_paged_attention_stacked(*args, 0, table, n_codes, k_outliers=args[1])


@pytest.mark.parametrize("d,M,G,O,build", [
    (128, 64, 4, 0, "lanes"), (128, 32, 7, 16, "lanes"), (128, 16, 3, 0, "lanes"), (64, 8, 8, 0, "lanes"),
    (16, 4, 2, 4, "lanes"), (96, 48, 4, 0, "lanes"), (128, 8, 3, 0, "wide"), (24, 6, 2, 0, "wide")])
def test_score_launches_follow_the_route(rng, monkeypatch, d, M, G, O, build):
    """Both wrappers count their score pass's launches by the build that
    decode_route chooses: the lane build for every d_m <= 8 with M % 4 == 0,
    the wide one otherwise. The library's call is stubbed (no card), the
    route and the arguments' checks run; score_lane_share reads None before
    the first launch."""
    stub = SimpleNamespace(pq_paged_attention=lambda *a: 0, pq_decode_attention=lambda *a: 0)
    for mod in (P, K):
        monkeypatch.setattr(mod, "_library", lambda: stub)
        monkeypatch.setattr(mod, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    for fn in (P.pq_paged_attention_stacked, K.pq_codes_attention_stacked):
        monkeypatch.setattr(fn, "score_launches", {"lanes": 0, "wide": 0})
    assert P.score_lane_share() is None
    assert K.decode_route(d, M, M, 16, 16, G, O, O).score == build
    c = make_case(rng, S=2, nh_k=1, G=G, d=d, M=M, C=16, O=O, ps=256, pps=1, n_pages=2, L=1, lens=(200, 0),
                  rows=(0, 0))
    args, table, n_codes, kw = port_args(c, residual=False)
    ko = [kw.get(k) for k in ("k_outliers", "v_outliers", "k_oidx", "v_oidx")]
    P._launch(*args, 0, table, n_codes, None, *ko, None, None, None, None, None)
    K._launch(args[0], args[1][:, :2], args[2][:, :2], args[3], args[4], 0, 200,
              *[None if x is None else x[:, :2] if x.dim() == 5 else x for x in ko], None, None, 0, None)
    want = {"lanes": int(build == "lanes"), "wide": int(build == "wide")}
    assert P.pq_paged_attention_stacked.score_launches == K.pq_codes_attention_stacked.score_launches == want
    assert P.score_lane_share() == float(build == "lanes")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(c, dev, layer, fn=P.pq_paged_attention_stacked, **extra):
    args, table, n_codes, kw = port_args(c, dev)
    before = P.pq_paged_attention_stacked.launches
    got = fn(*args, layer, table, n_codes, **kw, **extra)
    torch.cuda.synchronize()
    assert P.pq_paged_attention_stacked.launches == before + 1
    return [g.cpu().numpy() for g in got]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_cuda_kernel_matches_plain(rng, cuda_device, geom, mode):
    c = make_case(rng, ps=256, pps=5, n_pages=20, lens=(1200, 516, 0), rows=(8, 1, 0),
                  **GEOMETRIES[geom])
    want = port_call(c, 1, fn=P.pq_paged_attention_plain,
                     n_sm=torch.cuda.get_device_properties(cuda_device).multi_processor_count,
                     **MODES[mode])
    for g, w in zip(_on_card(c, cuda_device, 1, **MODES[mode]), want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("G,d,M,O", [(1, 64, 32, 0), (4, 128, 32, 16), (5, 64, 16, 2), (8, 128, 64, 0)])
def test_cuda_kernel_group_sizes(rng, cuda_device, G, d, M, O):
    c = make_case(rng, G=G, d=d, M=M, C=256, O=O, ps=256, pps=3, n_pages=9, Lt=32,
                  lens=(700, 256, 3), rows=(20, 32, 1))
    c["kres"], c["vres"] = (np.asarray(jnp.asarray(c[k], jnp.bfloat16).astype(jnp.float32))
                            for k in ("kres", "vres"))
    want = port_call(c, 0, fn=P.pq_paged_attention_plain,
                     n_sm=torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    for g, w in zip(_on_card(c, cuda_device, 0), want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_page_that_splits_a_tile(rng, cuda_device):
    c = make_case(rng, ps=128)
    args, table, n_codes, kw = port_args(c, cuda_device)
    with pytest.raises(ValueError, match="page_size"):
        P.pq_paged_attention_stacked(*args, 0, table, n_codes, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("O", [1, 7, 15])
def test_cuda_kernel_odd_exact_channels(rng, cuda_device, O):
    """Odd exact-channel pools (OK = OV = O): a tile's outlier rows are one
    span of nt * O * 2 bytes, held against the plain version at 1e-5 on
    `out` and `lse` on ragged lengths, an empty slot included."""
    c = make_case(rng, G=3, d=32, M=8, C=64, O=O, ps=256, pps=5, n_pages=20, lens=(1200, 517, 0),
                  rows=(8, 1, 0))
    want = port_call(c, 1, fn=P.pq_paged_attention_plain,
                     n_sm=torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    got = _on_card(c, cuda_device, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-5)
    assert (got[0][-1] == 0).all() and (got[1][-1] == -1e30).all()


LANE_GEOMETRIES = {  # the score pass's lane build at the paths' width, d = 128
    "dm2_G4": dict(G=4, d=128, M=64, C=256),  # the cell mistral-7b.decode-32k's
    "dm4_outlier_c128_G7": dict(G=7, d=128, M=32, C=128, O=16),  # qwen2-7b's
    "dm8_G3": dict(G=3, d=128, M=16, C=256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("geom", sorted(LANE_GEOMETRIES))
def test_cuda_lane_build_matches_plain_and_repeats(rng, cuda_device, geom):
    """The lane build on ragged lengths with an empty slot, shortened from
    the paths' 32K: `out` and `lse` at 1e-5 of the plain version, a second
    launch on the same inputs bit-identical (the greedy resume needs it)."""
    c = make_case(rng, S=4, ps=256, pps=9, n_pages=40, lens=(2200, 517, 0, 256), rows=(8, 1, 0, 3),
                  **LANE_GEOMETRIES[geom])
    want = port_call(c, 1, fn=P.pq_paged_attention_plain,
                     n_sm=torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    before = P.pq_paged_attention_stacked.score_launches["lanes"]
    got, again = _on_card(c, cuda_device, 1), _on_card(c, cuda_device, 1)
    assert P.pq_paged_attention_stacked.score_launches["lanes"] == before + 2
    for g, a, w in zip(got, again, want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-5)
        assert np.array_equal(g.view(np.uint32), a.view(np.uint32))
    assert (got[0][2] == 0).all() and (got[1][2] == -1e30).all()


def test_knockouts_of_the_passes_apply(tmp_path):
    """The knock-out builds that benchmarks/paged_kernel_ab.py times are text
    edits of this checkout's passes: every edit still finds its text, so each
    build times what its name says."""
    from million_tpu_torch.benchmarks import paged_kernel_ab as A
    from million_tpu_torch.ops import cuda_build

    original = (cuda_build.CSRC / A.SOURCES[0]).read_text()
    for name, edits in A.KNOCKOUTS.items():
        text = (A.write_knockout(name, tmp_path) / A.SOURCES[0]).read_text()
        assert text != original and all(new in text for _, new, _ in edits)

"""The port's in-chunk causal partial against million_tpu.

On the CPU the wrapper (causal_partial) runs the kernel's plain PyTorch
version, a blockwise online softmax over the chunk's keys. It is held at
1e-5 against million_tpu's f32 _causal_partial (the same inputs, made with
numpy), and at 1e-6 against itself at the kernel's key tiles, in f32, where
only the blocking differs. The bound counts at the chunk and admission
shapes and the shared-memory plan of the CUDA source are checked here too.
Tests marked `cuda` hold the CUDA kernel against the plain version on the
card and skip without one."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.models.chunked_prefill import _causal_partial as jax_causal_partial
from million_tpu_torch.models import chunked_prefill as tcp
from million_tpu_torch.ops import causal_attention_kernel as C

SOURCE = Path(__file__).resolve().parent.parent / "million_tpu_torch" / "csrc" / "causal_attention.cu"


def make_qkv(rng, *, bs=2, nh_k=2, G=3, nc=64, d=16):
    """q (bs, nh_k * G, nc, d) and k, v (bs, nh_k, nc, d), f32 numpy."""
    q = rng.standard_normal((bs, nh_k * G, nc, d)).astype(np.float32)
    k = rng.standard_normal((bs, nh_k, nc, d)).astype(np.float32)
    v = rng.standard_normal((bs, nh_k, nc, d)).astype(np.float32)
    return q, k, v


def model_views(q, k, v):
    """The layouts the model's projection gives the partial (llama._qkv): q
    and k head slices of one rotated tensor, v a token-major view."""
    bs, nh, nc, d = q.shape
    qk = torch.cat([q, k], dim=1)
    vt = v.transpose(1, 2).contiguous().transpose(1, 2)
    return qk[:, :nh], qk[:, nh:], vt


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("nc", [4, 64, 200])
def test_plain_matches_jax(rng, nc, G, d):
    q, k, v = make_qkv(rng, G=G, nc=nc, d=d)
    scale = 1.0 / d**0.5
    out, lse = C.causal_partial_plain(*map(torch.from_numpy, (q, k, v)), scale)
    want_out, want_lse = jax_causal_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)


@pytest.mark.parametrize("precision", sorted(C.KEY_TILE))
@pytest.mark.parametrize("nc", [1, 63, 200, 300])
def test_plain_at_the_kernel_key_tile(rng, nc, precision):
    """The kernel's key tile (a ragged last block included) against
    1,024-key blocks, in f32: only the blocking of the online softmax
    differs."""
    q, k, v = map(torch.from_numpy, make_qkv(rng, G=3, nc=nc, d=16))
    want = C.causal_partial_plain(q, k, v, 0.25, block=1024)
    got = C.causal_partial_plain(q, k, v, 0.25, block=C.KEY_TILE[precision])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)


def test_cpu_tensors_take_the_plain_version(rng):
    q, k, v = model_views(*map(torch.from_numpy, make_qkv(rng, G=3, nc=40, d=16)))
    before = C.causal_partial.launches
    got = C.causal_partial(q, k, v, 0.25)
    want = C.causal_partial_plain(q, k, v, 0.25)
    assert C.causal_partial.launches == before == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unsupported device"):
        C.causal_partial(q.to("meta"), k.to("meta"), v.to("meta"), 0.25)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_chunked_prefill_takes_the_partial_use_kernel_asks_for(monkeypatch, use_kernel):
    """use_kernel=False takes the plain version of the causal partial (and of
    the history partial); the default takes the wrapper."""
    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models import llama as tl

    cfg = tl.PRESETS["test-tiny"]
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    cents = cents_from_numpy({"key": rng.standard_normal((2, 8, 32, 2)).astype(np.float32),
                              "value": rng.standard_normal((2, 8, 32, 2)).astype(np.float32)}, device="cpu")
    cache = init_state(PQCacheConfig(bs=1, nh_k=2, d=16, M=8, C=32, Lt=8, N_max=64, dtype=torch.float32),
                       2, device="cpu")
    seen = []
    monkeypatch.setattr(tcp, "causal_partial", lambda *a: seen.append("wrapper") or C.causal_partial(*a))
    monkeypatch.setattr(tcp, "causal_partial_plain",
                        lambda *a: seen.append("plain") or C.causal_partial_plain(*a))
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 24)))
    tcp.chunked_prefill(params, cfg, ids, cache, cents, chunk=8, use_kernel=use_kernel)
    assert seen == ["wrapper" if use_kernel is None else "plain"] * (2 * 3)  # layers x chunks


def test_bound_counts_chunk_shape():
    """One launch of the chunked path: bs 4, 24 / 8 heads, a 4,096-token
    chunk, d 128, bf16 in, f32 out."""
    ops = C.causal_ops(4, 24, 4096, 128)
    assert ops == 2 * 4 * 24 * 4096 * 4097 * 128  # the causal half, diagonal included
    assert ops == pytest.approx(4.1e11, rel=0.01)
    nbytes = C.causal_bytes(4, 24, 8, 4096, 128)
    q, kv, out = 4 * 24 * 4096 * 128 * 2, 2 * 4 * 8 * 4096 * 128 * 2, 4 * 24 * 4096 * 128 * 4
    assert nbytes == q + kv + out + 4 * 24 * 4096 * 4
    assert (q, kv, out) == (pytest.approx(0.10e9, rel=0.01), pytest.approx(0.067e9, rel=0.01),
                            pytest.approx(0.20e9, rel=0.01))
    # the bound: operations at the 989 TFLOP/s bf16 peak against bytes at 3.35 TB/s
    t_ops, t_bytes = ops / 989e12 * 1e3, nbytes / 3.35e12 * 1e3
    assert t_ops == pytest.approx(0.42, abs=0.005) and t_ops > t_bytes


def test_bound_counts_admission_shape():
    """One launch of the serving admission: 6 slots x a 512-token chunk."""
    ops = C.causal_ops(6, 24, 512, 128)
    assert ops == 2 * 6 * 24 * 512 * 513 * 128 and ops == pytest.approx(9.7e9, rel=0.01)
    nbytes = C.causal_bytes(6, 24, 8, 512, 128)
    out = 6 * 24 * 512 * 128 * 4
    assert nbytes == 6 * 512 * 128 * 2 * (24 + 16) + out + 6 * 24 * 512 * 4
    assert nbytes == pytest.approx(69e6, rel=0.01) and out == pytest.approx(38e6, rel=0.01)
    t_ops, t_bytes = ops / 989e12 * 1e3, nbytes / 3.35e12 * 1e3
    assert t_bytes == pytest.approx(0.021, abs=0.0005) and t_bytes > t_ops


def _defines():
    return {m.group(1): m.group(2).strip() for m in re.finditer(r"^#define (\w+) \(?([\w +*]+)\)?",
                                                                 SOURCE.read_text(), re.M)}


def test_tiles_mirror_the_source():
    """The wrapper's tiles and plan constants are the .cu source's."""
    defs = _defines()
    assert int(defs["BQ"]) == C.Q_BLOCK and defs["MQ"] == "64 * NCONS" and int(defs["NCONS"]) * 64 == C.Q_BLOCK
    assert int(defs["BN"]) == C.KEY_TILE["f32"] and int(defs["NT"]) == C.KEY_TILE["bf16"]
    assert int(defs["STAGES"]) == C.STAGES and int(defs["SMEM_HEAD"]) == C.SMEM_HEAD
    assert int(defs["MAX_D"]) == C.MAX_D and int(defs["LDV"]) == 128
    assert (defs["LDQ"], defs["LDK"], defs["LDP"]) == ("BQ", "BN", "BQ + 4")
    assert "d == 128" in SOURCE.read_text() and set(C.MMA_HEAD_DIMS) == {
        int(x) for x in re.findall(r"if \(d == (\d+)\) return \(int\)launch_mma", SOURCE.read_text())}


def test_cluster_plan_mirrors_the_source():
    """The tensor-core version's clusters and TMA boxes: the constants are
    the source's, the grid pads an odd row-block count to whole clusters of
    two, and the longer block of a pair is its rank 0."""
    defs = _defines()
    assert int(defs["CLUSTER"]) == C.CLUSTER == 2
    assert int(defs["SWIZZLE_MAX"]) == C.SWIZZLE_MAX
    # boxes of 64 dims (128 bytes, the 128-byte swizzle) at d = 64 and 128, 16 (32 bytes) at d = 16
    assert [C.swizzle_bytes(d) for d in C.MMA_HEAD_DIMS] == [32, 128, 128]
    assert "__cluster_dims__(CLUSTER, 1, 1)" in SOURCE.read_text()
    # nc 200 at G = 3: 600 rows, five blocks and a padding block
    assert C.grid_blocks(200, 3) == 6
    assert [C.block_tiles(200, 3, bx) for bx in range(6)] == [4, 3, 2, 2, 1, 0]
    # nc 130 at G = 1: two blocks, one pair; one token: one block and its padding
    assert [C.block_tiles(130, 1, bx) for bx in range(C.grid_blocks(130, 1))] == [3, 2]
    assert [C.block_tiles(1, 3, bx) for bx in range(C.grid_blocks(1, 3))] == [1, 0]
    for nc, G in ((4096, 3), (512, 3), (380, 3), (300, 1), (97, 4)):
        tiles = [C.block_tiles(nc, G, bx) for bx in range(C.grid_blocks(nc, G))]
        assert tiles == sorted(tiles, reverse=True) and tiles[0] == -(-nc // 64)
        assert all(tiles[j] >= tiles[j + 1] for j in range(0, len(tiles), 2))


def tile_copies(nc, G):
    """(tiles the row blocks of one (b, KV head) need, tiles L2 hands out
    with each cluster's shared tiles copied once by multicast)."""
    need = [C.block_tiles(nc, G, bx) for bx in range(C.grid_blocks(nc, G))]
    shared = sum(min(need[j], need[j + 1]) for j in range(0, len(need), C.CLUSTER))
    return sum(need), sum(need) - shared


def test_multicast_halves_the_tile_copies():
    """Shared tiles are copied once per cluster: at the chunk shape the row
    blocks of one (b, KV head) need 3,136 tiles of 64 keys and L2 hands out
    1,584 (32 (b, KV head) x 32 KB each: 3.29 GB -> 1.66 GB); at the
    admission shape 56 -> 30."""
    assert tile_copies(4096, 3) == (3136, 1584)
    assert tile_copies(512, 3) == (56, 30)
    tile_bytes = 2 * 64 * 128 * 2
    need, copied = (4 * 8 * n * tile_bytes for n in tile_copies(4096, 3))
    assert need == pytest.approx(3.29e9, rel=0.01) and copied == pytest.approx(1.66e9, rel=0.01)


def test_tma_view_takes_the_model_layouts_and_rejects_misaligned_ones():
    """The host side of the tensor maps: the model's K (a head slice) and V
    (token-major) views give rank-4 maps (d, nc, heads, bs) with byte
    strides; a row stride off 16 bytes, a base off 16 bytes or strided dims
    are refused."""
    q, k, v = model_views(*(torch.from_numpy(a).bfloat16() for a in make_qkv(
        np.random.default_rng(0), bs=2, nh_k=2, G=3, nc=64, d=64)))
    assert C.tma_view(k) == ((64, 64, 2, 2), (128, 64 * 128, 8 * 64 * 128))
    assert C.tma_view(v) == ((64, 64, 2, 2), (2 * 128, 128, 64 * 2 * 128))
    wide = torch.zeros((2, 2, 64, 68), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="whole 16 bytes"):
        C.tma_view(wide[..., :64])  # rows 136 bytes apart
    with pytest.raises(ValueError, match="byte offset 8"):
        C.tma_view(torch.zeros((2, 2, 64, 72), dtype=torch.bfloat16)[..., 4:68])
    with pytest.raises(ValueError, match="contiguous dims"):
        C.tma_view(torch.zeros((2, 2, 64, 128), dtype=torch.bfloat16)[..., ::2])


@pytest.mark.parametrize("d", [16, 64, 128])
def test_smem_plan_fits_and_follows_its_formula(d):
    """The shared memory of a block (the mirror of causal_attention_smem,
    which the wrapper holds it against on the card): the tensor-core version
    a head of 64 bytes of mbarriers and up to 1,023 bytes that align the
    tiles to the swizzle's 1024-byte period, and four stages of a 64-key K
    and V tile in bf16, the f32 version the query tile, one K or V tile and
    the weights in f32; both fit the 232,448 bytes a block may take."""
    assert C.causal_smem_plan(d, "bf16") == 1088 + 4 * 2 * 64 * d * 2 <= 232448
    assert C.causal_smem_plan(d, "f32") == 4 * (d * 128 + 128 * 128 + 128 * 132) <= 232448
    assert C.causal_smem_plan(128, "bf16") == 132160


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (bs, nh_k, G, nc, d): ragged chunks (not a multiple of either key tile or of
# the 128-row block), one token, every group size of the repository's models,
# every head dim of the tensor-core version, the admission batch of six
CUDA_CASES = {
    "ragged_G3_d128": (2, 2, 3, 200, 128),
    "one_token_G3_d128": (2, 2, 3, 1, 128),
    "G1_d64": (2, 2, 1, 130, 64),
    "G4_d64": (1, 2, 4, 97, 64),
    "G3_d16": (2, 2, 3, 300, 16),
    "test_tiny_G2_d16": (2, 2, 2, 4, 16),
    "tiles_G3_d128": (1, 8, 3, 1024, 128),
    "admission_6x512": (6, 8, 3, 512, 128),
    # row blocks in cluster pairs and a lone last block (an odd count), and
    # chunks that are no multiple of the 64-key tile
    "odd_blocks_G1_d128": (2, 2, 1, 300, 128),
    "odd_blocks_G3_d64": (2, 2, 3, 380, 64),
    "pairs_G3_d64": (1, 4, 3, 1000, 64),
    "chunk_rows_G3_d128": (1, 8, 3, 4096, 128),
}
# kernel against plain, `out` and `lse` apart, about 10x what an H100
# measured on these cases: f32 only the summation order differs (<= 6.0e-7,
# 9.5e-7); bf16 both round q, P at the same places and P against the same
# running maxima (the plain version at the kernel's 64-key tile), but a
# weight's bf16 rounding may still fall the other way where the two sums of
# q . k differ in the last f32 bit, which at rows of few keys moves `out` by
# up to 2^-9 |v| / l (<= 2.2e-3; `lse` <= 1.9e-6)
CUDA_TOL = {"f32": (1e-5, 1e-5), "bf16": (2e-2, 2e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(rng, cuda_device, case, dtype):
    bs, nh_k, G, nc, d = CUDA_CASES[case]
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    q, k, v = model_views(*(torch.from_numpy(a).to(cuda_device, tdt)
                            for a in make_qkv(rng, bs=bs, nh_k=nh_k, G=G, nc=nc, d=d)))
    scale = 1.0 / d**0.5
    before = C.causal_partial.launches
    got = C.causal_partial(q, k, v, scale)
    torch.cuda.synchronize()
    assert C.causal_partial.launches == before + 1
    want = C.causal_partial_plain(q, k, v, scale, block=C.KEY_TILE[dtype])
    for g, w, tol in zip(got, want, CUDA_TOL[dtype]):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=tol)
    # contiguous inputs give the same result as the model's strided views
    again = C.causal_partial(q.contiguous(), k.contiguous(), v.contiguous(), scale)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_cuda_kernel_rejects(rng, cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in make_qkv(rng, nc=16, d=32))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    with pytest.raises(ValueError, match="bf16 kernel"):
        C.causal_partial(qb, kb, vb, 0.2)
    with pytest.raises(ValueError, match="bf16 or f32"):
        C.causal_partial(q.half(), k.half(), v.half(), 0.2)
    with pytest.raises(ValueError, match="aligned"):  # k rows start 2 bytes off a 16-byte boundary
        C.causal_partial(qb[..., :16], kb[..., 1:17], vb[..., :16], 0.2)
    v_wide = torch.zeros((*vb.shape[:3], 18), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="whole 16 bytes"):  # v rows 36 bytes apart: no tensor map
        C.causal_partial(qb[..., :16], kb[..., :16], v_wide[..., :16], 0.2)
    out, _ = C.causal_partial(q, k, v, 0.2)  # the f32 kernel takes d = 32
    assert out.shape == q.shape

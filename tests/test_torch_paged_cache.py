"""The port's paged PQ cache against million_tpu's on the CPU.

The cases of tests/test_paged_cache.py on the port (allocate / free, code
round trips through the page table, appends that straddle a page, the
encoding prefill), and the same allocate / write / free sequence run in both
packages: page tables, `used`, counters and pool contents must be equal once
million_tpu's state is carried over by convert.paged_state_from_numpy (its
pools are word-packed and subspace-major, the port's token-major bytes).
Integer state: everything here is compared for equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache import paged_pq_cache as jpc
from million_tpu.ops.pq_attention_pallas import pack_codes, to_byte_plane
from million_tpu_torch import convert
from million_tpu_torch.cache import paged_pq_cache as tpc
from million_tpu_torch.pq.ops import RUNTIME_ENCODE_PRECISION, pq_encode

GEOM = dict(num_layers=2, nh_k=2, d=32, M=16, C=64, Lt=16, page_size=128, n_pages=16, max_seqs=3,
            pages_per_seq=4)
CFG = tpc.PagedPQCacheConfig(dtype=torch.float32, **GEOM)
JCFG = jpc.PagedPQCacheConfig(dtype=jnp.float32, **GEOM)


def codes(rng, n, M=CFG.M):
    return rng.integers(0, 64, (CFG.num_layers, CFG.nh_k, n, M)).astype(np.uint8)


def read_tokens(st, pool, seq_id, n):
    """The first n tokens of a slot, token by token through the page table:
    (L, nh_k, n, X)."""
    table = st["page_table"][seq_id].tolist()
    t = np.arange(n)
    pages = np.asarray([table[i] for i in t // CFG.page_size])
    return st[pool][:, pages, :, t % CFG.page_size].permute(1, 2, 0, 3).numpy()


def assert_states_equal(jst, tst):
    conv = convert.paged_state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, CFG, device="cpu")
    assert set(conv) == set(tst)
    for k in ("used", "page_table", "seq_n_codes", "seq_n_pages", "seq_r", "seq_active"):
        np.testing.assert_array_equal(conv[k].numpy(), tst[k].numpy(), err_msg=k)
    for k in ("key_pool", "value_pool"):
        # every allocated page, whole; the scratch page may differ
        np.testing.assert_array_equal(conv[k][:, :-1].numpy(), tst[k][:, :-1].numpy(), err_msg=k)


def test_allocate_and_free():
    st = tpc.init_paged_state(CFG, device="cpu")
    assert tpc.allocate_pages(st, 0, 2) is st  # in place
    tpc.allocate_pages(st, 1, 3)
    assert st["seq_n_pages"].tolist() == [2, 3, 0]
    assert int(st["used"].sum()) == 5
    pages0, pages1 = set(st["page_table"][0, :2].tolist()), set(st["page_table"][1, :3].tolist())
    assert pages0 == {0, 1} and pages1 == {2, 3, 4}  # the lowest-numbered free pages
    tpc.free_sequence(st, 0)
    assert int(st["used"].sum()) == 3 and int(st["seq_n_pages"][0]) == 0
    assert (st["page_table"][0] == -1).all()
    tpc.allocate_pages(st, 2, 4)  # freed pages are reused, lowest first
    assert int(st["used"].sum()) == 7
    assert st["page_table"][2].tolist() == [0, 1, 5, 6]


def test_allocation_fails_soft_when_the_pool_is_dry():
    cfg = tpc.PagedPQCacheConfig(dtype=torch.float32, **{**GEOM, "n_pages": 3})
    st = tpc.init_paged_state(cfg, device="cpu")
    tpc.allocate_pages(st, 0, 2)
    tpc.allocate_pages(st, 1, 2)  # only one page is left
    assert st["page_table"][1, :2].tolist() == [-1, -1]
    assert int(st["used"].sum()) == 2 and int(st["seq_n_pages"][1]) == 0
    st["seq_active"][1] = 1
    st["seq_n_pages"][1] = 2
    assert tpc.paged_cache_stats(st, cfg)["page_table_errors"] == 2
    with pytest.raises(ValueError, match="pool of 3"):
        tpc.allocate_pages(st, 2, 4)


def test_write_codes_roundtrip(rng):
    st = tpc.init_paged_state(CFG, device="cpu")
    tpc.allocate_pages(st, 0, 3)
    kc, vc = codes(rng, 256), codes(rng, 256)  # two pages' worth
    tpc.write_codes_to_pages(st, 0, torch.from_numpy(kc), torch.from_numpy(vc), CFG)
    assert int(st["seq_n_codes"][0]) == 256
    np.testing.assert_array_equal(read_tokens(st, "key_pool", 0, 256), kc)
    np.testing.assert_array_equal(read_tokens(st, "value_pool", 0, 256), vc)
    kc2 = codes(rng, 128)  # a second append lands in the third page
    tpc.write_codes_to_pages(st, 0, torch.from_numpy(kc2), torch.from_numpy(kc2), CFG)
    page3 = int(st["page_table"][0, 2])
    np.testing.assert_array_equal(st["key_pool"][:, page3].numpy(), kc2)
    with pytest.raises(ValueError, match="4-aligned"):
        tpc.write_codes_to_pages(st, 0, torch.from_numpy(codes(rng, 6)), torch.from_numpy(codes(rng, 6)), CFG)


def test_write_codes_unaligned_append(rng):
    """Appends that straddle a page boundary must split correctly."""
    st = tpc.init_paged_state(CFG, device="cpu")
    tpc.allocate_pages(st, 0, 2)
    a, b = codes(rng, 96), codes(rng, 96)
    tpc.write_codes_to_pages(st, 0, torch.from_numpy(a), torch.from_numpy(a), CFG)
    tpc.write_codes_to_pages(st, 0, torch.from_numpy(b), torch.from_numpy(b), CFG)
    p0, p1 = st["page_table"][0, :2].tolist()
    page0, page1 = st["key_pool"][:, p0].numpy(), st["key_pool"][:, p1].numpy()
    np.testing.assert_array_equal(page0[:, :, :96], a)
    np.testing.assert_array_equal(page0[:, :, 96:128], b[:, :, :32])
    np.testing.assert_array_equal(page1[:, :, :64], b[:, :, 32:])


def test_paged_prefill_encodes(rng):
    st = tpc.init_paged_state(CFG, device="cpu")
    tpc.allocate_pages(st, 1, 2)
    n = 130  # 128 to pages, a ragged tail of 2 to the residual window
    k = torch.from_numpy(rng.standard_normal((CFG.num_layers, CFG.nh_k, n, CFG.d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((CFG.num_layers, CFG.nh_k, n, CFG.d)).astype(np.float32))
    kcent = torch.from_numpy(rng.standard_normal((CFG.num_layers, CFG.M, CFG.C, 2)).astype(np.float32))
    vcent = torch.from_numpy(rng.standard_normal((CFG.num_layers, CFG.M, CFG.C, 2)).astype(np.float32))
    tpc.paged_prefill(st, 1, k, v, kcent, vcent, CFG)
    assert (int(st["seq_n_codes"][1]), int(st["seq_r"][1]), int(st["seq_active"][1])) == (128, 2, 1)
    want = pq_encode(k[0, :, :128], kcent[0], "strided", precision=RUNTIME_ENCODE_PRECISION)
    page = int(st["page_table"][1, 0])
    np.testing.assert_array_equal(st["key_pool"][0, page].numpy(), want.numpy())
    np.testing.assert_array_equal(st["key_residual"][:, 1, :, :2].numpy(), k[:, :, 128:].numpy())


def test_stats_account_for_the_pool(rng):
    st = tpc.init_paged_state(CFG, device="cpu")
    tpc.allocate_pages(st, 0, 2)
    tpc.write_codes_to_pages(st, 0, torch.from_numpy(codes(rng, 200)), torch.from_numpy(codes(rng, 200)), CFG)
    st["seq_active"][0] = 1
    s = tpc.paged_cache_stats(st, CFG)
    assert (s["pages_used"], s["pages_free"], s["active_seqs"], s["page_table_errors"]) == (2, 14, 1, 0)
    assert s["per_seq"][0] == {"slot": 0, "active": True, "n_codes": 200, "n_pages": 2, "residual_len": 0}
    assert s["live_code_bytes"] == 200 * 2 * 2 * (16 + 16)
    assert abs(s["compression_x"] - 8.0) < 1e-9  # f32 dense KV, 2 * 32 * 4 B, against 32 code bytes
    assert s["pool_reserved_bytes"] == 2 * 2 * 17 * 2 * 128 * 16


def test_config_rejects_wide_codes_and_ragged_pages():
    with pytest.raises(NotImplementedError, match="8-bit codes in both packages"):
        tpc.PagedPQCacheConfig(**{**GEOM, "C": 512})
    with pytest.raises(ValueError, match="multiples of 4"):
        tpc.PagedPQCacheConfig(**{**GEOM, "page_size": 130})


def test_same_sequence_of_calls_gives_million_tpu_state(rng):
    """allocate, write (with a straddling append), free, allocate again, in
    both packages: tables, `used`, counters and pools agree page by page."""
    jst, tst = jpc.init_paged_state(JCFG), tpc.init_paged_state(CFG, device="cpu")
    steps = [("alloc", 0, 2), ("alloc", 1, 3), ("write", 0, 96), ("write", 0, 96), ("write", 1, 260),
             ("free", 0, None), ("alloc", 2, 4), ("write", 2, 128), ("alloc", 1, 1), ("write", 1, 100)]
    for op, sid, arg in steps:
        if op == "alloc":
            jst = jpc.allocate_pages(jst, jnp.asarray(sid), arg)
            tpc.allocate_pages(tst, sid, arg)
        elif op == "free":
            jst = jpc.free_sequence(jst, jnp.asarray(sid))
            tpc.free_sequence(tst, sid)
        else:
            kc, vc = codes(rng, arg), codes(rng, arg)
            jst = jpc.write_codes_to_pages(jst, jnp.asarray(sid), jnp.asarray(np.swapaxes(kc, -1, -2)),
                                           jnp.asarray(np.swapaxes(vc, -1, -2)), JCFG)
            tpc.write_codes_to_pages(tst, sid, torch.from_numpy(kc), torch.from_numpy(vc), CFG)
        assert_states_equal(jst, tst)
    assert tst["page_table"][2].tolist() == [0, 1, 5, 6]
    assert tst["seq_n_codes"].tolist() == [0, 360, 128]


def test_converter_translates_pools_and_outlier_pools(rng):
    """paged_state_from_numpy: word-packed pools and byte-plane outlier pools
    become token-major bytes and bf16 rows; bookkeeping arrays carry over."""
    cfg = tpc.PagedPQCacheConfig(dtype=torch.float32, OK=4, OV=2, **GEOM)
    jst = {k: np.asarray(v) for k, v in jpc.init_paged_state(
        jpc.PagedPQCacheConfig(dtype=jnp.float32, OK=4, OV=2, **GEOM)).items()}
    P, ps = cfg.n_pages + 1, cfg.page_size
    kc = rng.integers(0, 64, (2, P, 2, ps, 16)).astype(np.uint8)
    ko = np.asarray(jnp.asarray(rng.standard_normal((2, P, 2, ps, 4)), jnp.bfloat16).astype(jnp.float32))
    jst["key_pool"] = np.asarray(pack_codes(jnp.asarray(np.swapaxes(kc, -1, -2))))
    jst["key_outlier_pool"] = np.asarray(to_byte_plane(jnp.asarray(np.swapaxes(ko, -1, -2), jnp.bfloat16)))
    jst["page_table"] = rng.integers(-1, 16, jst["page_table"].shape).astype(np.int32)
    jst["seq_n_codes"] = np.asarray([4, 0, 260], np.int32)
    tst = convert.paged_state_from_numpy(jst, cfg, device="cpu")
    assert tst["key_pool"].dtype == torch.uint8 and tst["key_outlier_pool"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tst["key_pool"].numpy(), kc)
    np.testing.assert_array_equal(tst["key_outlier_pool"].float().numpy(), ko)
    assert tst["value_outlier_pool"].shape == (2, P, 2, ps, 2)
    np.testing.assert_array_equal(tst["page_table"].numpy(), jst["page_table"])
    assert tst["seq_n_codes"].tolist() == [4, 0, 260] and tst["seq_n_codes"].dtype == torch.int32
    with pytest.raises(ValueError, match="does not match"):
        convert.paged_state_from_numpy(jst, tpc.PagedPQCacheConfig(**{**GEOM, "n_pages": 8}), device="cpu")

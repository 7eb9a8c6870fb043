"""The port's mesh paths (million_tpu_torch/parallel) against million_tpu, on
the CPU.

The ranks are processes (parallel/launch.run_ranks: spawned, one gloo group
through a file:// store under the test's tmp_path, one torch thread each);
their bodies are in tests/torch_mesh_ranks.py, which imports no JAX. Two
spawns serve every test of this file: one of 2 ranks, one of 4 (a dcn axis,
or tp x sp). The inputs are made with numpy from a seed and carried to both
packages (million_tpu's test-tiny weights, f32).

Tolerances: against million_tpu's single-device functions (the f32 "pq"
oracle, causal attention, the flat and chunked prefill) 1e-4, as the port's
single-device tests hold them; against million_tpu's own mesh functions on
the conftest's 8 virtual devices: the ring (plain jnp) 1e-5, and the
sharded decode kernel, which runs Pallas in interpret mode with int8 tables,
5e-2 (tests/test_torch_c9_widths.py's flat limit)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import chunked_prefill as jcp
from million_tpu.models import llama as jl
from million_tpu.ops.pq_attention_pallas import GROUP_PAD, pack_codes, pack_decode_table
from million_tpu.ops.pq_attention_ref import causal_attention as j_causal
from million_tpu.ops.pq_attention_ref import pq_decode_attention_ref as j_oracle
from million_tpu.parallel import mesh as jmesh
from million_tpu.parallel.ring_attention import ring_causal_attention as j_ring
from million_tpu.parallel.sharded_decode import sharded_pq_codes_attention_stacked as j_sharded
from million_tpu.parallel.sp_prefill import prefill_sp as j_prefill_sp
from million_tpu_torch import convert
from million_tpu_torch.benchmarks.scaling_bench import mesh_parity
from million_tpu_torch.dryrun import dryrun_multichip
from million_tpu_torch.ops.pq_attention_kernel import pq_codes_attention_stacked
from million_tpu_torch.parallel import distributed as tdist
from million_tpu_torch.parallel import mesh as tmesh
from million_tpu_torch.parallel.launch import run_ranks

import torch_mesh_ranks as R

JCFG = jl.PRESETS["test-tiny"]
L, D, NH, NH_K = JCFG.num_layers, JCFG.head_dim, JCFG.num_heads, JCFG.num_kv_heads
BS, LT, N_MAX, FLUSH, N_PROMPT, N_STEPS = 2, 8, 64, 4, 37, 14

# ---------------------------------------------------------------------------
# inputs (numpy, from seeds)
# ---------------------------------------------------------------------------


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


PARAMS = np_tree(jl.init_params(JCFG, jax.random.PRNGKey(0)))


def make_cents(geom, seed=1):
    rng = np.random.default_rng(seed)
    if geom == "dm2":
        M, C, dm, O = D // 2, 32, 2, 0
    else:
        M, C, dm, O = D // 4, 64, 4, 4
    c = {"key": rng.standard_normal((L, M, C, dm)).astype(np.float32),
         "value": rng.standard_normal((L, M, C, dm)).astype(np.float32)}
    for side, name in (("key", "k_outlier_idx"), ("value", "v_outlier_idx")) if O else ():
        idx = np.stack([np.sort(rng.choice(D, O, replace=False)) for _ in range(L)]).astype(np.int32)
        c[name] = idx
        for li in range(L):
            for ch in idx[li]:
                c[side][li, ch % M, :, ch // M] = 0.0
    return c, dict(M=M, C=C, OK=O, OV=O)


RNG = np.random.default_rng(7)
IDS = RNG.integers(0, JCFG.vocab_size, (BS, N_PROMPT))
TOKENS = RNG.integers(0, JCFG.vocab_size, (N_STEPS, BS))


def flat_task(mesh, route, geom, n=N_PROMPT):
    cents, g = make_cents(geom)
    return ("flat_rank", dict(mesh=mesh, params=PARAMS, cents=cents, geom=g, Lt=LT, N_max=N_MAX,
                              ids=IDS[:, :n], tokens=TOKENS, flush=FLUSH, chunk=16, route=route))


def attention_case(O=0, N=256, seed=3):
    """Random codes, codebooks, q and a residual window in the port's layouts."""
    rng = np.random.default_rng(seed)
    G, M, C = NH // NH_K, (8 if not O else 4), (32 if not O else 64)
    a = dict(q=(rng.standard_normal((1, NH_K, G, D)) / np.sqrt(D)).astype(np.float32),
             kc=rng.integers(0, C, (L, 1, NH_K, N, M)).astype(np.uint8),
             vc=rng.integers(0, C, (L, 1, NH_K, N, M)).astype(np.uint8),
             kcent=rng.standard_normal((L, M, C, D // M)).astype(np.float32),
             vcent=rng.standard_normal((L, M, C, D // M)).astype(np.float32),
             kres=rng.standard_normal((L, 1, NH_K, LT, D)).astype(np.float32),
             vres=rng.standard_normal((L, 1, NH_K, LT, D)).astype(np.float32))
    if O:
        bf = lambda x: np.asarray(torch.from_numpy(x).bfloat16().float())  # noqa: E731
        a["ko"] = bf(rng.standard_normal((L, 1, NH_K, N, O)).astype(np.float32))
        a["vo"] = bf(rng.standard_normal((L, 1, NH_K, N, O)).astype(np.float32))
        a["koidx"] = np.stack([np.sort(rng.choice(D, O, replace=False)) for _ in range(L)]).astype(np.int32)
        a["voidx"] = np.stack([np.sort(rng.choice(D, O, replace=False)) for _ in range(L)]).astype(np.int32)
    return a


ATT = attention_case()
ATT_O = attention_case(O=4, seed=4)
# (layer, n_codes, residual rows): both shards and the window; the last shard(s) empty; no codes at
# all, the window alone; the whole arena without a window
CASES = [(1, 200, 5), (0, 100, 3), (1, 0, 4), (0, 256, 0), (1, 200, 0)]
RING = {k: RNG.standard_normal((1, NH if k == "q" else NH_K, 64, D)).astype(np.float32) for k in "qkv"}

W2 = {  # name -> task of the 2-rank spawn
    "att_sp2": ("attention_rank", dict(mesh=dict(sp=2), arrays=ATT, cases=CASES)),
    "att_o_sp2": ("attention_rank", dict(mesh=dict(sp=2), arrays=ATT_O, cases=CASES[:3])),
    "ring_sp2": ("ring_rank", dict(mesh=dict(sp=2), **RING)),
    "sp2-flat-outlier": flat_task(dict(sp=2), "flat", "outlier"),
    "tp2-flat-dm2": flat_task(dict(tp=2), "flat", "dm2"),
    "dp2-flat-dm2": flat_task(dict(dp=2), "flat", "dm2"),
    "sp2-sp-outlier": flat_task(dict(sp=2), "sp", "outlier", n=36),
    "sp2-sp-dm2": flat_task(dict(sp=2), "sp", "dm2", n=36),
    "sp2-chunked-dm2": flat_task(dict(sp=2), "chunked", "dm2"),
}
W4 = {
    "att_dcn2sp2": ("attention_rank", dict(mesh=dict(dcn=2, sp=2), arrays=ATT, cases=CASES)),
    "ring_dcn2sp2": ("ring_rank", dict(mesh=dict(dcn=2, sp=2), axis="seq", **RING)),
    "sp2tp2-flat-outlier": flat_task(dict(sp=2, tp=2), "flat", "outlier"),
    "dp2tp2-flat-dm2": flat_task(dict(dp=2, tp=2), "flat", "dm2"),
    "dcn2sp2-sp-dm2": flat_task(dict(dcn=2, sp=2), "sp", "dm2", n=36),
    "dcn2sp2-chunked-outlier": flat_task(dict(dcn=2, sp=2), "chunked", "outlier"),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every task of this file: one spawn of 2 ranks, one of 4."""
    out = {}
    for world, tasks in ((2, W2), (4, W4)):
        res = run_ranks(R.many, world, (list(tasks.values()),), device="cpu",
                        work_dir=str(tmp_path_factory.mktemp(f"w{world}")))
        for j, name in enumerate(tasks):
            out[name] = [r[j] for r in res]
    return out


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


def jax_flat(route, geom, n=N_PROMPT):
    """million_tpu single device: the flat (or chunked) prefill, then the
    teacher-forced "pq" oracle steps with the same flush schedule."""
    cents, g = make_cents(geom)
    jc = {k: jnp.asarray(v) for k, v in cents.items()}
    jp = jax.tree.map(jnp.asarray, PARAMS)
    cache = j_init_state(JPQCfg(bs=BS, nh_k=NH_K, d=D, Lt=LT, N_max=N_MAX, dtype=jnp.float32, **g), L)
    ids = jnp.asarray(IDS[:, :n], jnp.int32)
    if route == "chunked":
        last, cache = jcp.chunked_prefill(jp, JCFG, ids, cache, jc, chunk=16, use_kernel=False)
    else:
        lg, cache = jl.prefill(jp, JCFG, ids, cache, jc, mode="pq", last_logit_only=True)
        last = lg[:, -1]
    logits = [np.asarray(last)]
    r = n % 4
    for t, tok in enumerate(TOKENS):
        if r >= LT:
            cache = jl.flush_windows(cache, jc, n=FLUSH)
            r -= FLUSH
        lg, cache = jl.decode_step(jp, JCFG, jnp.asarray(tok, jnp.int32), jnp.asarray(n + t, jnp.int32),
                                   cache, jc, mode="pq")
        r += 1
        logits.append(np.asarray(lg))
    arena = convert.arena_from_numpy(np.asarray(cache["key_codes"]))  # (L, bs, nh_k, N, M)
    return np.stack(logits), np.swapaxes(arena, 0, 1)


_JAX = {}


def jax_ref(route, geom, n=N_PROMPT):
    key = (route, geom, n)
    if key not in _JAX:
        _JAX[key] = jax_flat(route, geom, n)
    return _JAX[key]


def oracle(a, layer, n_codes, r):
    """million_tpu's f32 oracle for one case: out (1, nh, d)."""
    kw = {}
    if "ko" in a:
        from million_tpu.ops.pq_attention_pallas import to_byte_plane

        kw = dict(k_outliers=to_byte_plane(jnp.asarray(np.swapaxes(a["ko"][layer], -1, -2), jnp.bfloat16)),
                  k_oidx=jnp.asarray(a["koidx"][layer]),
                  v_outliers=to_byte_plane(jnp.asarray(np.swapaxes(a["vo"][layer], -1, -2), jnp.bfloat16)),
                  v_oidx=jnp.asarray(a["voidx"][layer]))
    q = a["q"].reshape(1, NH, D) * np.sqrt(D)
    return np.asarray(j_oracle(
        jnp.asarray(q), jnp.asarray(np.swapaxes(a["kc"][layer], -1, -2)),
        jnp.asarray(np.swapaxes(a["vc"][layer], -1, -2)), jnp.asarray(a["kcent"][layer]),
        jnp.asarray(a["vcent"][layer]), jnp.asarray(a["kres"][layer]), jnp.asarray(a["vres"][layer]),
        jnp.asarray(n_codes), jnp.asarray(r), **kw))


def single(a, layer, n_codes, r):
    """The port's own one-device call (the kernel's plain version)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    kw = dict(k_residual=t["kres"], v_residual=t["vres"], r=r) if r else {}
    if "ko" in t:
        kw.update(k_outliers=t["ko"].bfloat16(), v_outliers=t["vo"].bfloat16(), k_oidx=t["koidx"],
                  v_oidx=t["voidx"])
    out, lse = pq_codes_attention_stacked(t["q"], t["kc"], t["vc"], t["kcent"], t["vcent"], layer, n_codes,
                                          **kw)
    return out.numpy(), lse.numpy()


# ---------------------------------------------------------------------------
# the mesh, its layouts (no ranks)
# ---------------------------------------------------------------------------


def test_one_rank_mesh_without_process_group():
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"dcn": 1, "dp": 1, "tp": 1, "sp": 1} and m.n_seq == 1 and m.seq_index == 0
    t = torch.arange(4.0)
    assert m.all_reduce(t, "seq") is t and m.all_gather(t, "tp", 0) is t and m.ring_shift(t) is t
    assert tmesh.make_mesh().device.type == "cuda"  # the card unless the caller asks for the CPU
    with pytest.raises(ValueError, match="processes"):
        tmesh.make_mesh(sp=2, device="cpu")


def test_launcher_ranks_choose_their_card_and_backend(monkeypatch):
    """torchrun's ranks on a machine with a card a rank take their own card
    (LOCAL_RANK) and NCCL; ranks that share a card take card 0 and gloo, CPU
    ranks gloo. The entry points take the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    dev = tdist.rank_device("cuda", 2, 4)
    assert dev == torch.device("cuda", 2) and tdist.choose_backend(dev, 4) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    dev = tdist.rank_device("cuda", 1, 2)
    assert dev == torch.device("cuda", 0) and tdist.choose_backend(dev, 2) == "gloo"
    assert tdist.choose_backend(tdist.rank_device("cpu", 1, 2), 2) == "gloo"
    for fn in (tdist.initialize, run_ranks, dryrun_multichip, mesh_parity):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_initialize_under_a_launcher_environment(monkeypatch, tmp_path):
    """initialize() with torchrun's variables set: the rank and the world
    come from the environment, the device and the backend from the devices,
    and make_mesh takes the device initialize chose."""
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    dev = tdist.initialize(init_method=f"file://{tmp_path}/store", device="cpu")
    try:
        assert dev == torch.device("cpu") and tdist.backend() == "gloo"
        m = tmesh.make_mesh()
        assert m.device == dev and m.rank == 0
        t = torch.arange(4.0)
        assert torch.equal(m.all_reduce(t.clone(), "seq", "max"), t) and m.routes == {"all_reduce": "gloo"}
    finally:
        tdist.shutdown()


def test_param_and_cache_layouts_match_reference():
    """The dims each layout splits, and over which axis, are million_tpu's
    PartitionSpecs (mesh.py:46-98), the sequence axes as ("dcn", "sp")."""
    jm = jmesh.make_mesh(dp=2, tp=2, sp=1, dcn=2)
    seq = ("dcn", "sp")

    def spec_dims(sh):
        return {i: (a if a != seq and a != "sp" else "seq") for i, a in enumerate(sh.spec) if a is not None}

    jp = jmesh.param_shardings(jm, attn_bias=True)
    tp = tmesh.param_shardings(None, attn_bias=True)
    for k in ("embed", "final_norm", "lm_head"):
        assert spec_dims(jp[k]) == tp[k] == {}
    for k, sh in jp["layers"].items():
        assert spec_dims(sh) == tp["layers"][k], k
    jc, tc = jmesh.pq_cache_shardings(jm), tmesh.pq_cache_shardings(None)
    for k in ("key_codes", "value_codes", "key_residual", "value_residual"):
        want = spec_dims(jc[k])
        if k.endswith("codes"):  # (L, bs, nh_k, M, NW) -> the port's token-major (L, bs, nh_k, N, M)
            want = {1: "dp", 2: "tp", 3: "seq"}
        assert tc[k] == want, k


def test_shard_params_cuts_megatron_blocks():
    """Rank (tp 1, sp 0) of a tp = 2 x sp = 2 mesh, built by hand (no
    process group): its heads and MLP columns, and its arena shard."""
    keys = ("dcn", "dp", "tp", "sp", "seq", "world")
    m = tmesh.Mesh({"dcn": 1, "dp": 1, "tp": 2, "sp": 2}, 2, torch.device("cpu"), {k: None for k in keys},
                   {"dcn": [2], "dp": [2], "tp": [0, 2], "sp": [2, 3], "seq": [2, 3], "world": [0, 1, 2, 3]})
    assert m.coords == {"dcn": 0, "dp": 0, "tp": 1, "sp": 0} and m.index("tp") == 1 and m.seq_index == 0
    p = convert.params_from_numpy(PARAMS, torch.float32, device="cpu")
    s = tmesh.shard_params(p, m)
    lay = p["layers"]
    np.testing.assert_array_equal(s["layers"]["wq"], lay["wq"][:, NH // 2 * D:])
    np.testing.assert_array_equal(s["layers"]["wk"], lay["wk"][:, NH_K // 2 * D:])
    np.testing.assert_array_equal(s["layers"]["wo"], lay["wo"][:, :, NH // 2 * D:])
    I = JCFG.intermediate_size
    np.testing.assert_array_equal(s["layers"]["w_gate"], lay["w_gate"][:, :, I // 2:])
    np.testing.assert_array_equal(s["layers"]["w_down"], lay["w_down"][:, I // 2:])
    np.testing.assert_array_equal(s["embed"], p["embed"])
    cache = {"key_codes": torch.arange(L * 2 * NH_K * 8 * 3).reshape(L, 2, NH_K, 8, 3), "n_codes": 5}
    c = tmesh.shard_cache(cache, m)
    np.testing.assert_array_equal(c["key_codes"], cache["key_codes"][:, :, 1:, :4])
    assert c["n_codes"] == 5
    assert tmesh.overlap(m, 4, 2, 4) == (0, 2, 2)  # tokens 2..5 of the global arena: 2, 3 live here


# ---------------------------------------------------------------------------
# sequence-sharded decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["att_sp2", "att_dcn2sp2", "att_o_sp2"])
def test_sharded_attention_matches_reference_oracle(ranks, name):
    a = ATT_O if name == "att_o_sp2" else ATT
    for rank_res in ranks[name]:
        for (layer, n_codes, r), (out, lse) in zip(CASES, rank_res["outs"]):
            want = oracle(a, layer, n_codes, r)
            np.testing.assert_allclose(out.reshape(1, NH, D), want, atol=1e-4, err_msg=str((layer, n_codes, r)))
            _, want_lse = single(a, layer, n_codes, r)
            np.testing.assert_allclose(lse, want_lse, atol=1e-5)


def test_sharded_attention_empty_shard_and_window_folded_once(ranks):
    """n_codes = 100 leaves the last shard(s) empty and n_codes = 0 every
    shard: the merge gives them weight 0 and stays finite; the window, which
    every shard holds, counts once (the one-device result)."""
    for name in ("att_sp2", "att_dcn2sp2"):
        res = ranks[name]
        assert [r["seq_index"] for r in res] == list(range(res[0]["n_seq"]))
        for case in (1, 2):
            layer, n_codes, r = CASES[case]
            want_out, want_lse = single(ATT, layer, n_codes, r)
            for rr in res:
                out, lse = rr["outs"][case]
                assert np.isfinite(out).all() and np.isfinite(lse).all()
                np.testing.assert_allclose(out, want_out, atol=1e-5)
                np.testing.assert_allclose(lse, want_lse, atol=1e-5)


def test_sharded_attention_matches_reference_mesh_kernel(ranks):
    """million_tpu's sharded_pq_codes_attention_stacked itself on 2 virtual
    devices (the Pallas kernel in interpret mode, int8 tables), no window."""
    layer, n_codes = 1, 200
    mesh = jmesh.make_mesh(dp=1, tp=1, sp=2)
    G = NH // NH_K
    q_pad = np.zeros((1, NH_K, GROUP_PAD, D), np.float32)
    q_pad[:, :, :G] = ATT["q"]
    tabs = [jax.vmap(lambda x: pack_decode_table(x, direct=True))(jnp.asarray(ATT[k])) for k in ("kcent", "vcent")]
    out_j, lse_j = j_sharded(
        mesh, jnp.asarray(q_pad, jnp.bfloat16), pack_codes(jnp.asarray(np.swapaxes(ATT["kc"], -1, -2))),
        pack_codes(jnp.asarray(np.swapaxes(ATT["vc"], -1, -2))), tabs[0], tabs[1], jnp.asarray(layer),
        jnp.asarray(n_codes), block=128, direct=True, interpret=True)
    out, lse = ranks["att_sp2"][0]["outs"][CASES.index((1, 200, 0))]
    np.testing.assert_allclose(out, np.asarray(out_j)[:, :, :G], atol=5e-2)
    np.testing.assert_allclose(lse, np.asarray(lse_j)[:, :, :G], atol=5e-2)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ring_sp2", "ring_dcn2sp2"])
def test_ring_matches_reference(ranks, name):
    got = np.concatenate(ranks[name], axis=2)
    want = np.asarray(j_causal(*[jnp.asarray(RING[k]) for k in "qkv"]))
    np.testing.assert_allclose(got, want, atol=1e-4)
    P = 2 if name == "ring_sp2" else 4
    jm = jmesh.make_mesh(dp=1, tp=1, sp=P)
    ref_ring = np.asarray(j_ring(jm, *[jnp.asarray(RING[k]) for k in "qkv"]))
    np.testing.assert_allclose(got, ref_ring, atol=1e-5)


# ---------------------------------------------------------------------------
# prefill + decode on meshes: flat, sequence-parallel, chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sp2-flat-outlier", "tp2-flat-dm2", "dp2-flat-dm2", "sp2tp2-flat-outlier",
                                  "dp2tp2-flat-dm2"])
def test_flat_mesh_route_matches_reference(ranks, name):
    """Flat prefill, then teacher-forced decode steps (sub-window flushes
    that straddle the sequence shards): every step's logits on every rank
    within 1e-4 of million_tpu's single-device oracle, the arena equal."""
    geom = name.split("-")[-1]
    want, arena = jax_ref("flat", geom)
    for r in ranks[name]:
        np.testing.assert_allclose(r["logits"], want, atol=1e-4)
        np.testing.assert_array_equal(r["key_codes"], arena)
        assert r["n_codes"] + r["r"] == N_PROMPT + N_STEPS


@pytest.mark.parametrize("name", ["sp2-sp-outlier", "sp2-sp-dm2", "dcn2sp2-sp-dm2"])
def test_sp_prefill_matches_reference(ranks, name):
    """prefill_sp (ring attention, per-shard encode, one gather of codes a
    layer; padded to 4 x 4 shards on the dcn mesh) and the decode steps:
    against million_tpu's flat single-device prefill, logits 1e-4, arena
    equal (the exact outlier channels kept, as in the flat prefill)."""
    geom = name.split("-")[-1]
    want, arena = jax_ref("flat", geom, n=36)
    for r in ranks[name]:
        np.testing.assert_allclose(r["logits"], want, atol=1e-4)
        np.testing.assert_array_equal(r["key_codes"], arena)


def test_sp_prefill_matches_reference_mesh_function(ranks):
    """million_tpu's prefill_sp itself on 2 virtual devices (no exact
    channels: the reference writes none)."""
    cents, g = make_cents("dm2")
    jm = jmesh.make_mesh(dp=1, tp=1, sp=2)
    cache = jmesh.shard_pytree(j_init_state(JPQCfg(bs=BS, nh_k=NH_K, d=D, Lt=LT, N_max=N_MAX, dtype=jnp.float32,
                                                   **g), L), jmesh.pq_cache_shardings(jm))
    last, jc = j_prefill_sp(jax.tree.map(jnp.asarray, PARAMS), JCFG, jnp.asarray(IDS[:, :36], jnp.int32), cache,
                            {k: jnp.asarray(v) for k, v in cents.items()}, jm)
    for r in ranks["sp2-sp-dm2"]:
        np.testing.assert_allclose(r["logits"][0], np.asarray(last), atol=1e-4)
    arena = np.swapaxes(convert.arena_from_numpy(np.asarray(jc["key_codes"])), 0, 1)
    assert (ranks["sp2-sp-dm2"][0]["key_codes"][:, :, :, :36] == arena[:, :, :, :36]).all()


@pytest.mark.parametrize("name", ["sp2-chunked-dm2", "dcn2sp2-chunked-outlier"])
def test_chunked_mesh_route_matches_reference(ranks, name):
    """Chunked prefill on the mesh (each rank's history shard through the
    history partial, merged): against million_tpu's chunked_prefill
    (use_kernel=False) at 1e-4. With exact channels, whose terms the
    reference's plain history route leaves out, against the port's one-rank
    run (held to the reference by tests/test_torch_chunked_prefill.py)."""
    if name.endswith("dm2"):
        want, arena = jax_ref("chunked", "dm2")
    else:
        one = R.flat_rank(0, dict(W4[name][1], mesh={}))
        want, arena = one["logits"], one["key_codes"]
    for r in ranks[name]:
        np.testing.assert_allclose(r["logits"], want, atol=1e-4)
        np.testing.assert_array_equal(r["key_codes"], arena)


def test_collectives_take_gloo_on_the_cpu(ranks):
    routes = ranks["sp2-sp-dm2"][0]["routes"]
    assert routes == {"all_gather": "gloo", "send/recv": "gloo", "all_reduce": "gloo"}
    assert set(ranks["tp2-flat-dm2"][0]["routes"].values()) == {"gloo"}

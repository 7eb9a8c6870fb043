"""The port's sharded serving (parallel/paged_sharded.py, runtime.scheduler.
ShardedScheduler, the mesh branch of runtime/checkpoint.py) against
million_tpu, on the CPU.

The ranks are spawned processes (parallel/launch.run_ranks, gloo through a
file:// store under tmp_path); their bodies are in tests/torch_mesh_ranks.py.
Two requests (a 70-token prompt admitted in chunks of 32, a 20-token one in
one shot) run on meshes of sp = 2, tp = 2 x sp = 2 and dcn = 2 x sp = 2: the
slots' tokens straddle the sequence shards, a window flush lands in the
second shard, and a session is saved after three steps, dropped and resumed
on the mesh. Greedy tokens equal million_tpu's single-device generate
(the "pq" oracle, the chunked prefill for the chunked admission, full-window
flushes) exactly; one teacher-forced tick after admission matches the port's
one-device tick at 1e-4 (f32, test-tiny); the shard layout's numbers are
million_tpu's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache.paged_pq_cache import PagedPQCacheConfig as JPagedCfg
from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import llama as jl
from million_tpu.parallel import mesh as jmesh
from million_tpu.parallel import paged_sharded as jps
from million_tpu.runtime.generate import generate as j_generate
from million_tpu_torch import convert
from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
from million_tpu_torch.models import llama as tl
from million_tpu_torch.models.paged_decode import paged_decode_step
from million_tpu_torch.parallel import mesh as tmesh
from million_tpu_torch.parallel import paged_sharded as tps
from million_tpu_torch.parallel.launch import run_ranks
from million_tpu_torch.runtime.scheduler import Request, Scheduler, ShardedScheduler

import torch_mesh_ranks as R

JCFG = jl.PRESETS["test-tiny"]
JCFG_T = tl.PRESETS["test-tiny"]
L, D, NH_K = JCFG.num_layers, JCFG.head_dim, JCFG.num_kv_heads
M, C, LT, PS, CHUNK = D // 2, 32, 8, 16, 32
POOL = dict(num_layers=L, nh_k=NH_K, d=D, M=M, C=C, Lt=LT, page_size=PS, n_pages=16, max_seqs=2,
            pages_per_seq=8)
PARAMS = jax.tree.map(lambda a: np.asarray(a, np.float32), jl.init_params(JCFG, jax.random.PRNGKey(0)))
RNG = np.random.default_rng(11)
CENTS = {k: RNG.standard_normal((L, M, C, 2)).astype(np.float32) for k in ("key", "value")}
REQUESTS = [(0, RNG.integers(0, JCFG.vocab_size, 70), 12), (1, RNG.integers(0, JCFG.vocab_size, 20), 6)]
TICK_TOKENS = RNG.integers(0, JCFG.vocab_size, 2)
MESHES = {"sp2": dict(sp=2), "tp2sp2": dict(tp=2, sp=2), "dcn2sp2": dict(dcn=2, sp=2)}


def session(tmp, name):
    return str(tmp / f"session_{name}.npz")


def task(name, tmp):
    return ("serving_rank", dict(mesh=MESHES[name], params=PARAMS, cents=CENTS, pcfg=POOL, requests=REQUESTS,
                                 admit_chunk=CHUNK, save_after=3, tick_tokens=TICK_TOKENS,
                                 path=session(tmp, name)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """sp2 on 2 ranks; tp2sp2 and dcn2sp2 on 4, which also resume sp2's
    snapshot on tp 2 x sp 2 (the same shard layout, other heads a rank)."""
    tmp = tmp_path_factory.mktemp("serve")
    out = {}
    resume = ("resume_rank", dict(mesh=MESHES["tp2sp2"], params=PARAMS, cents=CENTS, pcfg=POOL,
                                  path=session(tmp, "sp2")))
    for world, names in ((2, ["sp2"]), (4, ["tp2sp2", "dcn2sp2", "resume"])):
        tasks = [resume if n == "resume" else task(n, tmp) for n in names]
        res = run_ranks(R.many, world, (tasks,), device="cpu", work_dir=str(tmp))
        for j, n in enumerate(names):
            out[n] = [r[j] for r in res]
    return out


@pytest.fixture(scope="module")
def reference():
    """million_tpu single device: each request through generate ("pq"
    oracle; the 70-token prompt through chunked_prefill in chunks of 32,
    the admission's)."""
    jp = jax.tree.map(jnp.asarray, PARAMS)
    jc = {k: jnp.asarray(v) for k, v in CENTS.items()}
    out = {}
    for rid, prompt, n_new in REQUESTS:
        cache = j_init_state(JPQCfg(bs=1, nh_k=NH_K, d=D, M=M, C=C, Lt=LT, N_max=128, dtype=jnp.float32), L)
        chunk = CHUNK if len(prompt) > CHUNK else 0
        res, _ = j_generate(jp, JCFG, jnp.asarray(prompt[None], jnp.int32), cache, jc, mode="pq",
                            max_new_tokens=n_new, prefill_chunk=chunk, prefill_hist_block=16)
        out[rid] = np.asarray(res.tokens)[0]
    return out


def one_device_tick():
    """The port's one-device scheduler after the same admission, and its
    teacher-forced tick."""
    p = convert.params_from_numpy(PARAMS, torch.float32, device="cpu")
    cents = convert.cents_from_numpy(CENTS, device="cpu")
    pcfg = PagedPQCacheConfig(dtype=torch.float32, **POOL)
    s = Scheduler(p, JCFG_T, pcfg, cents, admit_chunk=CHUNK, tick_chain=1, device="cpu")
    for rid, prompt, n in REQUESTS:
        s.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    s._try_admit()
    s.drain()
    return paged_decode_step(p, JCFG_T, pcfg, torch.from_numpy(TICK_TOKENS), None, s.state, cents).numpy()


def hand_mesh(shape, rank):
    """A rank's Mesh built by hand (no process group): its coordinates and
    groups' members, for the layout arithmetic."""
    keys = ("dcn", "dp", "tp", "sp")
    full = {k: shape.get(k, 1) for k in keys}
    grid = np.arange(int(np.prod(list(full.values())))).reshape([full[k] for k in keys])
    coords = np.unravel_index(rank, grid.shape)
    members = {}
    for key, axes in tmesh.GROUP_AXES.items():
        idx = tuple(slice(None) if keys[i] in axes else coords[i] for i in range(4))
        members[key] = grid[idx].reshape(-1).tolist()
    return tmesh.Mesh(full, rank, torch.device("cpu"), {k: None for k in members}, members)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_paged_shard_info_and_layout_match_reference(name):
    """paged_shard_info's (n_sp, P_l, pps_l, cap_l) are million_tpu's on the
    same mesh, and the global layout a snapshot holds has the reference's
    sharded state's page and slot axes."""
    shape = MESHES[name]
    jm = jmesh.make_mesh(**{k: shape.get(k, 1) for k in ("dp", "tp", "sp", "dcn")})
    jcfg = JPagedCfg(dtype=jnp.float32, **POOL)
    tcfg = PagedPQCacheConfig(dtype=torch.float32, **POOL)
    want = jps.paged_shard_info(jcfg, jm)
    jst = jps.init_sharded_paged_state(jcfg, jm)
    n = int(np.prod(list(shape.values())))
    slabs = []
    for rank in range(n):
        m = hand_mesh(shape, rank)
        assert tps.paged_shard_info(tcfg, m) == want
        slabs.append((m, tps.init_sharded_paged_state(tcfg, m)))
    n_sp, P_l, pps_l, _ = want
    tp = shape.get("tp", 1)
    m, st = slabs[0]
    assert st["key_pool"].shape[:3] == (L, P_l + 1, NH_K // tp) and st["page_table"].shape == (2, pps_l)
    assert jst["key_pool"].shape[:3] == (L, n_sp * (P_l + 1), NH_K) and jst["used"].shape == (n_sp, P_l)
    assert jst["page_table"].shape == (2, n_sp * pps_l)


def test_slab_of_the_global_layout():
    """slice_paged_state cuts rank (tp 1, seq 1)'s slab: its own pages with
    their scratch page, its table columns, its `used` row, its heads."""
    tcfg = PagedPQCacheConfig(dtype=torch.float32, **POOL)
    m = hand_mesh({"tp": 2, "sp": 2}, 3)
    n_sp, P_l, pps_l, _ = tps.paged_shard_info(tcfg, m)
    glob = {"key_pool": torch.arange(L * n_sp * (P_l + 1) * NH_K).reshape(L, n_sp * (P_l + 1), NH_K, 1, 1),
            "page_table": torch.arange(2 * n_sp * pps_l).reshape(2, -1).int(),
            "used": torch.arange(n_sp * P_l).reshape(n_sp, P_l).int(), "seq_r": torch.ones(2, dtype=torch.int32)}
    s = tps.slice_paged_state(glob, tcfg, m)
    np.testing.assert_array_equal(s["key_pool"], glob["key_pool"][:, P_l + 1:, 1:])
    np.testing.assert_array_equal(s["page_table"], glob["page_table"][:, pps_l:])
    np.testing.assert_array_equal(s["used"], glob["used"][1])
    np.testing.assert_array_equal(s["seq_r"], glob["seq_r"])


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_scheduler_matches_reference(ranks, reference, name):
    """Every rank's greedy tokens, through a session saved mid-run and
    resumed on the mesh, are million_tpu's single-device generate's."""
    for r in ranks[name]:
        assert sorted(r["tokens"]) == [0, 1]
        for rid, want in reference.items():
            np.testing.assert_array_equal(r["tokens"][rid], want, err_msg=f"rid {rid}")
        assert not r["h_used"].any() and r["stats"]["page_table_errors"] == 0


def test_session_resumes_on_another_mesh(ranks, reference):
    """sp2's snapshot (2 ranks, both heads a rank) resumed on tp 2 x sp 2."""
    for r in ranks["resume"]:
        for rid, want in reference.items():
            np.testing.assert_array_equal(r[rid], want)


def test_sharded_tick_matches_one_device(ranks):
    want = one_device_tick()
    for name in MESHES:
        for r in ranks[name]:
            np.testing.assert_allclose(r["tick_logits"], want, atol=1e-4)


def test_session_saved_mid_run_holds_the_tokens_so_far(ranks, reference):
    for name in MESHES:
        for r in ranks[name]:
            for slot, toks in r["mid"].items():
                if toks:  # a slot admitted and stepped before the save
                    rid = next(rid for rid, p, n in REQUESTS if list(reference[rid][:len(toks)]) == toks)
                    assert rid in (0, 1)
    assert all(set(r["routes"].values()) == {"gloo"} for n in MESHES for r in ranks[n])


def test_sharded_scheduler_refusals():
    p = convert.params_from_numpy(PARAMS, torch.float32, device="cpu")
    cents = convert.cents_from_numpy(CENTS, device="cpu")
    pcfg = PagedPQCacheConfig(dtype=torch.float32, **POOL)
    with pytest.raises(ValueError, match="requires a mesh"):
        ShardedScheduler(p, JCFG_T, pcfg, cents)
    with pytest.raises(ValueError, match="not divisible"):
        tps.paged_shard_info(dataclasses.replace(pcfg, n_pages=15), hand_mesh({"sp": 2}, 0))
    one = ShardedScheduler(p, JCFG_T, pcfg, cents, mesh=tmesh.make_mesh(device="cpu"), admit_chunk=CHUNK)
    one.submit(Request(rid=0, prompt=REQUESTS[1][1], max_new_tokens=3))
    done = one.run_to_completion()
    assert [f.rid for f in done] == [0] and not one.h_used.any()

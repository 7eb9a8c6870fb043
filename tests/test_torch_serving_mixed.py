"""serving_bench's mixed-length mode (the reference's default protocol,
million_tpu/benchmarks/serving_bench.py:326-414) at a tiny size on the CPU.

The port's mode serves every request of a stream drawn from 4 word-aligned
prompt buckets, samples the pool from the host mirrors (peak pages within
the pool) and prints the reference's fields. The same request stream through
million_tpu's Scheduler, on the same weights (carried by convert.py), tables
and prompts, gives the same greedy token streams. Prompts stay above
max_new_tokens=1 (ROADMAP C.2)."""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.cache.paged_pq_cache import PagedPQCacheConfig as JPagedCfg
from million_tpu.models import llama as jl
from million_tpu.runtime.scheduler import Request as JRequest, Scheduler as JScheduler
from million_tpu_torch import convert
from million_tpu_torch.benchmarks import serving_bench as SB
from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
from million_tpu_torch.models import llama as tl
from million_tpu_torch.runtime.scheduler import Scheduler

GEOM = dict(num_layers=2, hidden_size=64, num_heads=4, num_kv_heads=2, head_dim=32,
            intermediate_size=128, vocab_size=300)
JCFG = dataclasses.replace(jl.PRESETS["test-tiny"], dtype=jnp.float32, **GEOM)
CFG = dataclasses.replace(tl.PRESETS["test-tiny"], dtype=torch.float32, **GEOM)
M, C = 16, 64
POOL = dict(num_layers=2, nh_k=2, d=32, M=M, C=C, Lt=8, page_size=128, n_pages=12, max_seqs=3,
            pages_per_seq=4)
ARGS = argparse.Namespace(requests=6, min_prompt=16, max_prompt=64, max_new=10, seed=3, preset="test-tiny")


@pytest.fixture(scope="module")
def models():
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                                       torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    cents = {"key": rng.standard_normal((2, M, C, 2)).astype(np.float32),
             "value": rng.standard_normal((2, M, C, 2)).astype(np.float32)}
    return jparams, params, cents


def test_prompt_buckets():
    assert SB.prompt_buckets(128, 1024) == [128, 424, 724, 1024]  # the reference's defaults
    assert SB.prompt_buckets(16, 64) == [16, 32, 48, 64]


def test_mixed_mode_serves_every_request_like_million_tpu(models, capsys):
    jparams, params, cents = models
    tables = convert.cents_from_numpy(cents, device="cpu")
    pcfg = PagedPQCacheConfig(**POOL, dtype=torch.float32)
    row, sched = SB.mixed(ARGS, CFG, pcfg, lambda: Scheduler(params, CFG, pcfg, tables, device="cpu"), "cpu")
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert printed == [row]
    assert sorted(row) == sorted(["metric", "value", "unit", "requests_per_s", "pool_pages", "peak_pages_used",
                                  "mean_in_flight", "preemptions", "worst_case_overcommit", "card"])
    assert row["pool_pages"] == 12 and 0 < row["peak_pages_used"] <= row["pool_pages"]
    assert 0 < row["mean_in_flight"] <= 3 and row["worst_case_overcommit"] >= 1
    got = {f.rid: f.tokens for f in sched.finished}
    assert sorted(got) == list(range(ARGS.requests))
    assert all(len(t) == ARGS.max_new for t in got.values())
    assert int(sched.state["used"].sum()) == 0
    # the same stream (the mode's draws from its seed) through million_tpu's Scheduler
    rng = np.random.default_rng(ARGS.seed)
    buckets = SB.prompt_buckets(ARGS.min_prompt, ARGS.max_prompt)
    js = JScheduler(jparams, JCFG, JPagedCfg(**POOL, dtype=jnp.float32),
                    jl.build_tables({k: jnp.asarray(v) for k, v in cents.items()}))
    for rid in range(ARGS.requests):
        n = int(rng.choice(buckets))
        js.submit(JRequest(rid=rid, prompt=rng.integers(0, CFG.vocab_size, n).astype(np.int32),
                           max_new_tokens=ARGS.max_new))
    want = {f.rid: f.tokens for f in js.run_to_completion(max_ticks=400)}
    assert sorted(want) == sorted(got)
    for rid in got:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"rid {rid}")

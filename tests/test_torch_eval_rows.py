"""The port's measured-row runner (benchmarks/eval_rows.py): task rows and
multiple-choice items equal to million_tpu's on the same corpus array and
seed, their schemas, and the PQ-tracks-dense multiple-choice gate.

Differences by design from million_tpu's gate (tests/test_eval_rows.py,
ROADMAP C.5 and C.7): it reads tiny_lm.build_corpus_frozen() where
million_tpu's reads build_corpus(), a stream that joins this repository's
markdown and test files, so that every edit of them re-draws its items; the
frozen stream is the same bytes on every machine and commit. On the frozen
stream the gate runs the anchor that stream was held out for, lm_l_v1 (the
quality phase's model): the small anchor scores 8/24 there, dense, below the
gate's 0.4 floor, so it gives the gate no signal. K/V from 2 windows of 512
tokens, 4,096 rows a layer and side as million_tpu's gate samples."""

import numpy as np
import pytest
import torch

from million_tpu.benchmarks import eval_rows as jer
from million_tpu_torch.benchmarks import eval_rows as ter
from million_tpu_torch.benchmarks import tiny_lm
from million_tpu_torch.benchmarks.lm_eval_adapter import evaluate_multiple_choice
from million_tpu_torch.benchmarks.longbench import dataset2metric, dataset2prompt, retrieval_score
from million_tpu_torch.benchmarks.quality_ladder import sample_kv, train_cents
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state

TASKS = ("lcc", "passage_count", "passage_retrieval_en", "needle_retrieval", "repobench-p")


@pytest.fixture(scope="module")
def corpus():
    return tiny_lm.build_corpus_frozen()


@pytest.mark.parametrize("task", TASKS)
def test_task_rows_equal_million_tpus(corpus, task):
    for ctx in (1024, 3072):
        got = ter.build_task_rows(corpus, task, 3, np.random.default_rng(5), ctx_bytes=ctx)
        want = jer.build_task_rows(corpus, task, 3, np.random.default_rng(5), ctx_bytes=ctx)
        assert got == want
    assert len(got) == 3 and task in dataset2metric
    tok = ter.ByteTokenizer()
    for r in got:
        assert {"context", "input", "answers", "all_classes"} <= set(r)
        assert r["answers"] and isinstance(r["answers"][0], str)
    # one prompt length per task (one prefill shape per mode)
    assert len({len(tok(dataset2prompt[task].format(**r))["input_ids"]) for r in got}) == 1
    if task == "needle_retrieval":
        gt = got[0]["answers"][0]
        assert retrieval_score(gt.split()[-1] + ".", gt) == 1.0 and retrieval_score("99.", gt) == 0.0


def test_mc_and_cloze_items_equal_million_tpus(corpus):
    for ctx_len in (192, 512):
        got = ter.build_mc_items(corpus, 10, np.random.default_rng(1), ctx_len=ctx_len)
        assert got == jer.build_mc_items(corpus, 10, np.random.default_rng(1), ctx_len=ctx_len)
        for it in got:
            assert len(it["context_ids"]) == ctx_len and len(it["choices_ids"]) == 4 and 0 <= it["label"] < 4
    got = ter.build_cloze_items(corpus, 6, np.random.default_rng(0))
    assert got == jer.build_cloze_items(corpus, 6, np.random.default_rng(0))
    for it in got:
        true = it["choices_ids"][it["label"]]
        assert sum(c == true for c in it["choices_ids"]) == 1
    tok = ter.ByteTokenizer()
    assert tok.decode(tok("abc\xe9")["input_ids"]) == "abc\xe9"


def test_mc_gate_pq_tracks_dense(corpus):
    """tests/test_eval_rows.py's gate on the port, over the frozen stream:
    the trained anchor beats the 0.25 chance floor (> 0.4) and PQ tracks
    dense within 0.21."""
    if not tiny_lm.checkpoint_path_l().exists():
        pytest.skip("lm_l_v1 checkpoint missing")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, cfg = tiny_lm.load_checkpoint(tiny_lm.checkpoint_path_l(), device="cpu")
        kv_k, kv_v = sample_kv(params, cfg, corpus[: 2 * 512], windows=2)
        M = cfg.head_dim // 2
        cents = {"key": train_cents(kv_k, M, 8, device="cpu")[0], "value": train_cents(kv_v, M, 8, device="cpu")[0]}
        items = ter.build_mc_items(corpus, 24, np.random.default_rng(1))
        mk_dense = lambda: init_dense_state(DenseCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim,
                                                             N_max=256, dtype=cfg.dtype), cfg.num_layers, device="cpu")
        mk_pq = lambda: init_state(PQCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M, C=256, Lt=128,
                                                 N_max=256, dtype=cfg.dtype), cfg.num_layers, device="cpu")
        acc_d = evaluate_multiple_choice(params, cfg, mk_dense, cents, items, mode="dense")["acc"]
        acc_p = evaluate_multiple_choice(params, cfg, mk_pq, cents, items, mode="pq")["acc"]
    finally:
        torch.set_num_threads(n)
    print(f"byte MC on the frozen stream: dense {acc_d}, PQ {acc_p}")
    assert acc_d > 0.4, f"trained anchor should beat 0.25 chance: {acc_d}"
    assert acc_p >= acc_d - 0.21, f"PQ acc {acc_p} fell too far below dense {acc_d}"


def test_main_writes_rows(tmp_path):
    """eval_rows.main end to end on the CPU at a small size (the small
    anchor, one lcc row, four MC items): one longbench and one lm_eval row
    in the given ledger, PQ mode "pq" on the CPU."""
    from million_tpu_torch.utils.ledger import read_results

    if not tiny_lm.checkpoint_path().exists():
        pytest.skip("tiny_lm_v1 checkpoint missing")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ter.main(["--small", "--device", "cpu", "--rows", "1", "--mc-items", "4", "--tasks", "lcc",
                  "--code-ctx", "256", "--out", str(tmp_path / "rows.jsonl")])
    finally:
        torch.set_num_threads(n)
    rows = read_results(tmp_path / "rows.jsonl")
    assert [r["stage"] for r in rows] == ["longbench", "lm_eval"]
    assert rows[0]["pq_mode"] == "pq" and rows[0]["backend"] == "cpu" and rows[0]["ctx_bytes"] == 256
    assert 0.0 <= rows[0]["score_pq"] <= 1.0 and rows[1]["n"] == 4

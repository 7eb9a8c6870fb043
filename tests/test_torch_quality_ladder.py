"""The port's quality ladder on the pinned tiny_lm_v1 checkpoint, on the CPU,
held to the envelope million_tpu's ladder is held to (tests/test_quality_ladder.py:
dense ppl finite and < 25, the nbits=8 rung at M=d/2 under 0.9 ppl and 7 %
relative), and to million_tpu's own dense ppl on the same text (1e-4). The
text is run_ladder's, the tail of build_corpus: the last of this
repository's test files, so it moves with every edit of them. The rungs are
evaluated over 16 windows of 511 positions: over 1 or 2 windows their ratio
to dense moved with that text by more than the envelope's margin (the
nbits 8 rung 0.98-1.075 over 2 windows, the nbits_v10 rung 0.97-1.10 over
1), over 16 windows it read 1.01-1.04 (nbits 8), 1.00-1.03 (nbits 9) and
1.01-1.06 (nbits_v10) on 30 such 64 KB texts (20 cut from build_corpus's
tail, 10 from the frozen stream). The reference's lower bound, Δppl > 0, is
not asserted: the k-means seed can move Δppl across 0 on a short text (on
one tree `python -m million_tpu.benchmarks.quality_ladder --fast --windows
2` itself gave a negative Δppl). The envelope's upper bounds are what a
broken encode or codebook would cross; the wide rungs (nbits 9-12, int16
codes) are held to the same relative bound. The OPQ rung runs in
tests/test_torch_opq.py."""

import json

import numpy as np
import pytest

from million_tpu_torch.benchmarks import quality_ladder as tql
from million_tpu_torch.benchmarks.tiny_lm import checkpoint_path, load_checkpoint

WINDOWS = 16  # windows of 511 positions each rung is evaluated over (module docstring)


@pytest.fixture(scope="module")
def tiny_lm():
    if not checkpoint_path().exists():
        pytest.skip("tiny_lm_v1 checkpoint missing")
    return load_checkpoint(checkpoint_path(), device="cpu")


@pytest.fixture
def one_thread():
    """The ladder on one intra-op thread: under pytest-xdist every worker
    takes a thread per core by default, and the oversubscribed CPU slows the
    k-means++ draws and small products of this test tenfold."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dppl_nbits8_in_envelope(one_thread):
    from million_tpu.benchmarks.perplexity import perplexity as j_perplexity
    from million_tpu.benchmarks.tiny_lm import load_checkpoint as j_load
    from million_tpu.cache.dense_cache import DenseCacheConfig, init_dense_state

    out = tql.run_ladder(fast=True, max_windows=WINDOWS, device="cpu")
    dense = out["dense_ppl"]
    (row,) = out["rows"]
    assert np.isfinite(dense) and dense < 25, f"dense ppl degenerated: {dense}"
    jp, jcfg = j_load(checkpoint_path())
    want = j_perplexity(jp, jcfg, tql.build_corpus()[-(1 << 16):], lambda: init_dense_state(
        DenseCacheConfig(bs=1, nh_k=jcfg.num_kv_heads, d=jcfg.head_dim, N_max=512, dtype=jcfg.dtype),
        jcfg.num_layers), None, mode="dense", max_length=512, distort_recent=False, max_windows=WINDOWS)
    assert abs(dense - want["ppl"]) <= 1e-4 * want["ppl"], (dense, want)
    assert (row["M"], row["nbits"]) == (16, 8)
    assert row["dppl"] != 0.0 and row["dppl"] < 0.9, f"Δppl(nbits=8) = {row['dppl']} (dense {dense})"
    assert row["ppl"] / dense < 1.07, "relative ppl regression > 7%"
    assert row["train_s"] > 0 and row["eval_s"] > 0


@pytest.mark.parametrize("rung", [dict(M_k=16, nbits_k=9), dict(M_k=16, nbits_k=8, M_v=8, nbits_v=10)],
                         ids=["nbits9", "nbits_v10"])
def test_later_rungs_raise(tiny_lm, rung, one_thread):
    """The wide rungs run (they raised before wide codes were ported): a
    symmetric nbits 9 rung and an asymmetric one whose V side is nbits 10,
    on the tiny model's own K/V, each on int16 arenas, within the nbits=8
    rung's 7 % relative envelope of the dense ppl."""
    import torch

    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state

    params, cfg = tiny_lm
    tokens = tql.build_corpus()
    kv_k, kv_v = tql.sample_kv(params, cfg, tokens[:8 * 512], windows=8, ctx=512)
    ev = tokens[-(1 << 16):]
    dense = tql.dense_perplexity(params, cfg, ev, max_length=512, max_windows=WINDOWS)["ppl"]
    row = tql.ladder_rung(params, cfg, ev, kv_k, kv_v, max_length=512, max_windows=WINDOWS, train_iters=3, **rung)
    want_v = (rung.get("M_v", rung["M_k"]), rung.get("nbits_v", rung["nbits_k"]))
    assert (row["M"], row["nbits"], row["M_v"], row["nbits_v"]) == (rung["M_k"], rung["nbits_k"], *want_v)
    assert np.isfinite(row["ppl"]) and row["ppl"] / dense < 1.07, (row["ppl"], dense)
    cents = tql.rung_cents(cfg, kv_k, kv_v, train_iters=1, device="cpu", **rung)
    assert cents["value"].shape[2] == 2 ** want_v[1]
    cache = init_state(PQCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=rung["M_k"],
                                     M_v=want_v[0], C=2 ** max(rung["nbits_k"], want_v[1])), 1, "cpu")
    assert cache["key_codes"].dtype == cache["value_codes"].dtype == torch.int16


def test_full_ladder_rungs():
    """The full ladder lists the reference's rungs, the nbits 9-12 rungs at
    M = d/2 among them, and the coarse sweep the M = d/4 rungs at nbits
    8-12."""
    from million_tpu_torch.benchmarks.tiny_lm import QUALITY_CFG

    rungs = tql.ladder_rungs(QUALITY_CFG)
    assert [r["nbits_k"] for r in rungs[:5]] == [8, 9, 10, 11, 12]
    assert sum(bool(r.get("opq")) for r in rungs) == 1 and len(rungs) == 11
    assert tql.ladder_rungs(QUALITY_CFG, fast=True) == [dict(M_k=16, nbits_k=8)]
    assert tql.ladder_rungs(QUALITY_CFG, coarse_sweep=True) == [dict(M_k=8, nbits_k=nb) for nb in range(8, 13)]


def test_main_appends_to_the_port_ledger(tmp_path, monkeypatch):
    fake = {"dense_ppl": 7.0, "rows": [{"ppl": 7.3, "dppl": 0.3}]}
    monkeypatch.setattr(tql, "run_ladder", lambda **kw: fake)
    path = tmp_path / "results_torch.jsonl"
    tql.main(["--fast", "--device", "cpu", "--results", str(path)])
    (rec,) = [json.loads(line) for line in path.read_text().splitlines()]
    assert rec["backend"] == "cpu" and rec["stage"] == "quality_ladder" and rec["result"] == fake
    assert "not a device measurement" in rec["card"]


def test_frozen_stream_is_fixed():
    """The quality phase's text: the reference package's sources and docs,
    which the port's rules freeze; chip_smoke.py's reference numbers hold
    only for these bytes."""
    import hashlib

    from million_tpu_torch.benchmarks.tiny_lm import build_corpus_frozen

    tokens = build_corpus_frozen()
    assert len(tokens) == 608927 and tokens.min() >= 0 and tokens.max() < 256
    digest = hashlib.sha256(tokens.astype(np.uint8).tobytes()).hexdigest()
    assert digest == "1c9a3cf0f456312b6df93bde1eec354d850b4997e2da381c0fb61fdc72393556"
    sample, ev = tql.frozen_split(tokens)
    assert len(sample) == 16 * 1024 and len(ev) == 32 * 1024
    assert len(sample) + len(ev) < len(tokens)  # the two regions do not overlap


def test_frozen_ladder_seeds(tiny_lm, one_thread):
    """The seed-spread ladder (`--frozen --seeds N`) at a small size: seed 0
    is the ladder's own rung (rung_cents at seed 0), each seed's Δppl is
    against the same dense ppl, and the mean and standard deviation are those
    of the seeds' Δppl (tolerance 1e-12, the same floats)."""
    params, cfg = tiny_lm
    tokens = tql.build_corpus_frozen()
    rung = dict(M_k=cfg.head_dim // 2, nbits_k=4)
    kw = dict(sample_windows=2, eval_windows=1, ctx=256, train_iters=3)
    out = tql.frozen_ladder(params, cfg, tokens, seeds=2, rungs={"r": rung}, **kw)
    (row,) = out["rows"]
    sample, ev = tokens[:2 * 256], tokens[-256:]
    kv_k, kv_v = tql.sample_kv(params, cfg, sample, windows=2, ctx=256)
    dense = tql.dense_perplexity(params, cfg, ev, max_length=256, max_windows=1)["ppl"]
    seed0 = tql.rung_perplexity(params, cfg, ev, tql.rung_cents(cfg, kv_k, kv_v, train_iters=3, device="cpu",
                                                                  **rung), max_length=256, max_windows=1)["ppl"]
    assert out["dense_ppl"] == dense
    assert row["dppl_by_seed"][0] == seed0 - dense
    assert row["dppl_by_seed"][0] != row["dppl_by_seed"][1]  # the seed reaches the k-means init
    assert abs(row["mean"] - np.mean(row["dppl_by_seed"])) <= 1e-12
    assert abs(row["std"] - np.std(row["dppl_by_seed"], ddof=1)) <= 1e-12

"""The port's evaluation harnesses against million_tpu's (tests/
test_eval_harnesses.py): LongBench metrics equal on the same strings, the
prediction loop on tests/fixtures/longbench_fixture.jsonl (the same greedy
text and score as million_tpu's on the same weights), loglikelihood within
1e-4 of million_tpu's (dense and PQ, f32 test-tiny), the profiling helpers
(StepTimer, Ticker, the speedtest breakdown through torch.profiler's CPU
events), the OOM guard (only torch.cuda.OutOfMemoryError is caught) and the
lm_eval adapter through a stub package."""

import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu.benchmarks import lm_eval_adapter as jlm
from million_tpu.benchmarks import longbench as jlb
from million_tpu.cache.dense_cache import DenseCacheConfig as JDenseCfg, init_dense_state as j_init_dense
from million_tpu.cache.pq_cache import PQCacheConfig as JPQCfg, init_state as j_init_state
from million_tpu.models import llama as jl
from million_tpu_torch import convert
from million_tpu_torch.benchmarks import lm_eval_adapter as tlm
from million_tpu_torch.benchmarks import longbench as tlb
from million_tpu_torch.benchmarks import speedtest as tst
from million_tpu_torch.benchmarks.registry import ByteTokenizer
from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
from million_tpu_torch.models import llama as tl
from million_tpu_torch.utils.profiling import StepTimer, Ticker, device_memory_report, trace, trace_op_breakdown

JCFG, TCFG = jl.PRESETS["test-tiny"], tl.PRESETS["test-tiny"]
L, D, NH_K = JCFG.num_layers, JCFG.head_dim, JCFG.num_kv_heads
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "longbench_fixture.jsonl"

PAIRS = [
    ("Paris is the capital", "Paris"), ("the answer is Paris", "the answer is Paris"), ("London", "Paris"),
    ("a b c d", "a b c d"), ("a b x d", "a b c d"), ("", "x"), ("The, Cat; sat!", "cat sat"),
    ("label: sports", "sports"), ("politics", "sports"), ("Paragraph 7 or maybe 9", "Paragraph 7"),
    ("the answer is 7", "Paragraph 7"), ("12 or 13 or 14", "13"), ("none", "13"),
    ("# comment\nreturn x\n", "return x"), ("```\nall commented #\n", "return x"), ("return x + 1", "return x + 1"),
]


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, convert.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), torch.float32,
                                         device="cpu")


@pytest.fixture(scope="module")
def cents():
    rng = np.random.default_rng(3)
    c = {"key": rng.standard_normal((L, D // 2, 32, 2)).astype(np.float32),
         "value": rng.standard_normal((L, D // 2, 32, 2)).astype(np.float32)}
    return {k: jnp.asarray(v) for k, v in c.items()}, convert.cents_from_numpy(c, device="cpu")


def test_metrics_equal_million_tpus():
    classes = ["sports", "politics"]
    for name in ("qa_f1_score", "rouge_l_score", "classification_score", "retrieval_score", "count_score",
                 "code_sim_score"):
        for pred, gt in PAIRS:
            assert getattr(tlb, name)(pred, gt, all_classes=classes) == getattr(jlb, name)(
                pred, gt, all_classes=classes), (name, pred, gt)
    assert tlb.retrieval_score("Paragraph 7 or maybe 9", "Paragraph 7") == 0.5
    assert abs(tlb.count_score("12 or 13 or 14", "13") - 1 / 3) < 1e-12


def test_metric_tables_equal_million_tpus():
    assert set(tlb.dataset2metric) == set(tlb.dataset2prompt) == set(tlb.dataset2maxlen)
    assert tlb.dataset2prompt == jlb.dataset2prompt and tlb.dataset2maxlen == jlb.dataset2maxlen
    assert {k: f.__name__ for k, f in tlb.dataset2metric.items()} == {
        k: f.__name__ for k, f in jlb.dataset2metric.items()}


def test_pred_longbench_on_the_fixture(params):
    """The fixture's passage_count rows through both harnesses and both
    models (dense, greedy, the same f32 weights): the same predictions and
    score; and a scripted generator scores alike in both."""
    from million_tpu.runtime.generate import generate as j_generate
    from million_tpu.runtime.sampling import SamplingConfig as JSampling
    from million_tpu_torch.runtime.generate import generate
    from million_tpu_torch.runtime.sampling import SamplingConfig

    jp, tp = params
    rows = tlb.load_longbench_rows("passage_count", str(FIXTURE))
    assert rows == jlb.load_longbench_rows("passage_count", str(FIXTURE)) and len(rows) == 3
    tok = ByteTokenizer()
    scripted = lambda prompt, n: f"there are {len(prompt) % 5} paragraphs, maybe 3"
    assert tlb.pred_longbench(scripted, tok, "passage_count", rows, max_length=700) == jlb.pred_longbench(
        scripted, tok, "passage_count", rows, max_length=700)
    preds = {"j": [], "t": []}

    def t_gen(prompt, n):
        ids = torch.tensor([tok(prompt)["input_ids"]])
        cache = init_dense_state(DenseCacheConfig(bs=1, nh_k=NH_K, d=D, N_max=1024, dtype=torch.float32), L,
                                 device="cpu")
        res, _ = generate(tp, TCFG, ids, cache, None, mode="dense", max_new_tokens=n,
                          sampling=SamplingConfig(temperature=0.0), device="cpu")
        preds["t"].append(tok.decode(res.tokens[0]))
        return preds["t"][-1]

    def j_gen(prompt, n):
        ids = jnp.asarray([tok(prompt)["input_ids"]], jnp.int32)
        cache = j_init_dense(JDenseCfg(bs=1, nh_k=NH_K, d=D, N_max=1024, dtype=jnp.float32), L)
        res, _ = j_generate(jp, JCFG, ids, cache, None, mode="dense", max_new_tokens=n,
                            sampling=JSampling(temperature=0.0))
        preds["j"].append(tok.decode(np.asarray(res.tokens[0])))
        return preds["j"][-1]

    got = tlb.pred_longbench(t_gen, tok, "passage_count", rows, max_length=700)
    want = jlb.pred_longbench(j_gen, tok, "passage_count", rows, max_length=700)
    assert preds["t"] == preds["j"] and len(preds["t"]) == 3
    assert got == want and got["n"] == 3


@pytest.mark.parametrize("mode", ["dense", "pq"])
def test_loglikelihood_matches_million_tpu(params, cents, mode):
    jp, tp = params
    jc, tc = cents
    if mode == "dense":
        mk_j = lambda: j_init_dense(JDenseCfg(bs=1, nh_k=NH_K, d=D, N_max=64, dtype=jnp.float32), L)
        mk_t = lambda: init_dense_state(DenseCacheConfig(bs=1, nh_k=NH_K, d=D, N_max=64, dtype=torch.float32),
                                        L, device="cpu")
        jc = tc = None
    else:
        mk_j = lambda: j_init_state(JPQCfg(bs=1, nh_k=NH_K, d=D, M=D // 2, C=32, Lt=8, N_max=64,
                                           dtype=jnp.float32), L)
        mk_t = lambda: init_state(PQCacheConfig(bs=1, nh_k=NH_K, d=D, M=D // 2, C=32, Lt=8, N_max=64,
                                                dtype=torch.float32), L, device="cpu")
    for ctx, cont in (([1, 2, 3], [5]), ([1, 2, 3], [5, 7]), (list(range(9, 30)), [4, 4, 8, 200])):
        want = jlm.loglikelihood(jp, JCFG, mk_j, jc, ctx, cont, mode=mode)
        got = tlm.loglikelihood(tp, TCFG, mk_t, tc, ctx, cont, mode=mode)
        assert np.isfinite(got) and got < 0
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (ctx, cont, got, want)
    examples = [{"context_ids": [1, 2, 3], "choices_ids": [[5], [6], [7, 8]], "label": 0},
                {"context_ids": [9, 9], "choices_ids": [[1], [2]], "label": 1}]
    assert tlm.evaluate_multiple_choice(tp, TCFG, mk_t, tc, examples, mode=mode) == \
        jlm.evaluate_multiple_choice(jp, JCFG, mk_j, jc, examples, mode=mode)


def test_step_timer_and_ticker():
    t = StepTimer()
    with t.phase("a", result=torch.ones(3)):
        sum(range(1000))
    with t.phase("a"):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2 and rep["a"]["total_s"] > 0
    tk = Ticker()
    assert np.isnan(tk.tpot_ttft()["ttft_s"])
    for _ in range(4):
        tk.tick()
    assert len(tk.intervals) == 3
    d = tk.tpot_ttft()
    assert np.isfinite(d["ttft_s"]) and np.isfinite(d["tpot_s"])
    if not torch.cuda.is_available():
        assert device_memory_report() is None


def test_trace_and_breakdown_on_cpu(tmp_path):
    with trace(str(tmp_path / "t.json")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert (tmp_path / "t.json").exists() and prof.key_averages()
    bd = trace_op_breakdown(lambda: torch.randn(128, 128) @ torch.randn(128, 128), device="cpu", top=5)
    assert "breakdown_error" not in bd and 0 < len(bd) <= 5
    assert any("mm" in k for k in bd) and all(v >= 0 for v in bd.values())


def _pq_factory():
    cfg = PQCacheConfig(bs=1, nh_k=NH_K, d=D, M=D // 2, C=32, Lt=8, N_max=128, dtype=torch.float32)
    return lambda *_: init_state(cfg, L, device="cpu")


def test_speedtest_breakdown(params, cents):
    _, tp = params
    res = tst.speedtest(tp, TCFG, _pq_factory(), cents[1], prefill_lengths=[32], decode_length=4, breakdown=True)
    row = res["results"][0]
    assert res["mode"] == "pq_kernel" and row["tpot_s"] > 0 and row["ttft_s"] > 0
    bd = row["breakdown_ms"]
    assert isinstance(bd, dict) and bd and "breakdown_error" not in bd
    assert all(v >= 0 for v in bd.values())


def test_speedtest_oom_guard(params, cents, monkeypatch):
    """An out-of-memory error at one length gives an {"oom": true} row and the
    sweep goes on; any other error propagates."""
    _, tp = params
    real, calls = tst.generate, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (synthetic)")
        return real(*a, **kw)

    monkeypatch.setattr(tst, "generate", flaky)
    rows = tst.speedtest(tp, TCFG, _pq_factory(), cents[1], mode="pq", prefill_lengths=[16, 24],
                         decode_length=4)["results"]
    assert rows[0] == {"prefill_length": 16, "oom": True, "error": "CUDA out of memory (synthetic)"}
    assert rows[1]["prefill_length"] == 24 and np.isfinite(rows[1]["tpot_s"])
    assert tst.is_oom_error(torch.cuda.OutOfMemoryError("x")) and not tst.is_oom_error(RuntimeError("OOM"))

    def broken(*a, **kw):
        raise RuntimeError("pq_decode_attention: kernel launch failed (out of memory)")

    monkeypatch.setattr(tst, "generate", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tst.speedtest(tp, TCFG, _pq_factory(), cents[1], prefill_lengths=[16], decode_length=4)


def test_lm_eval_adapter_via_stub(params, cents, monkeypatch):
    api = types.ModuleType("lm_eval.api")
    model_mod = types.ModuleType("lm_eval.api.model")

    class LM:
        def __init__(self):
            pass

    class Instance:
        def __init__(self, args):
            self.args = args

    model_mod.LM = LM
    root = types.ModuleType("lm_eval")
    root.api = api
    for name, mod in (("lm_eval", root), ("lm_eval.api", api), ("lm_eval.api.model", model_mod)):
        monkeypatch.setitem(sys.modules, name, mod)
    _, tp = params
    tok = ByteTokenizer()
    mk = lambda: init_state(PQCacheConfig(bs=1, nh_k=NH_K, d=D, M=D // 2, C=32, Lt=8, N_max=128,
                                          dtype=torch.float32), L, device="cpu")
    lm = tlm.make_lm_eval_model(tp, TCFG, mk, cents[1], tok, mode="pq")
    reqs = [Instance(("Hello wor", "ld")), Instance(("abc", "def"))]
    out = lm.loglikelihood(reqs)
    assert len(out) == 2
    for (ll, greedy), req in zip(out, reqs):
        assert np.isfinite(ll) and ll < 0 and greedy is False
        want = tlm.loglikelihood(tp, TCFG, mk, cents[1], tok(req.args[0])["input_ids"],
                                 tok(req.args[1])["input_ids"], "pq")
        assert ll == want
    with pytest.raises(NotImplementedError):
        lm.generate_until([])
    monkeypatch.setitem(sys.modules, "lm_eval.api.model", None)
    with pytest.raises(RuntimeError, match="lm_eval is not installed"):
        tlm.make_lm_eval_model(tp, TCFG, mk, cents[1], tok)

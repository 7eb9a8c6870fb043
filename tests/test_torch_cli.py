"""The port's pipeline CLI (million_tpu_torch.cli) on the CPU at test-tiny:
the counterparts of the eight tests of tests/test_cli.py (`--device cpu`),
then parity with million_tpu.cli on the same params and files:
  * the sampling stage on million_tpu's weights, converted, writes the rows
    million_tpu writes (the same indices; bf16 k/v, atol 1e-2);
  * the native trainer on the same .fvecs gives bit-equal codebooks;
  * the k-means trainer: the two draw different k-means++ inits, so the
    codebooks are held by their reconstruction error on the samples (summed
    over layers and sides) within 1 %;
  * an artifact trained by either package loads and evaluates in the other;
  * load_cents's `_synthetic` tables are bit-equal, with and without OPQ and
    outlier channels;
  * the perplexity kind on the same params and tables: ppl within 1e-3
    relative, dense and PQ.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from million_tpu import cli as jcli
from million_tpu.models import llama as jl
from million_tpu.utils.config import load_config as j_load_config
from million_tpu_torch import cli as tcli
from million_tpu_torch import convert
from million_tpu_torch.utils.config import load_config
from million_tpu_torch.utils.fvecs import read_fvecs
from million_tpu_torch.utils.ledger import read_results

TINY = str(Path(__file__).resolve().parent.parent / "configs" / "test-tiny.json")


def run(tmp_path, *stages, overrides=(), results="results_torch.jsonl"):
    tcli.main(["-f", TINY, "-p", *stages, "--device", "cpu",
               "-o", f"run.results={tmp_path}/{results}", "-o", f"run.artifacts={tmp_path}/artifacts",
               *[a for o in overrides for a in ("-o", o)]])
    return read_results(tmp_path / results)


SPEED = ("run.prefill_lengths=[64]", "run.decode_length=8")
ART = "artifacts/test-tiny/_synthetic"


# --- the counterparts of tests/test_cli.py -------------------------------------------------------

def test_full_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = run(tmp_path, "baseline", "sampling", "training", "evaluation", overrides=SPEED)
    assert [r["stage"] for r in rows] == ["baseline", "evaluation"]
    assert [r["mode"] for r in rows] == ["dense", "pq_kernel"]
    assert all(r["backend"] == "cpu" for r in rows)
    for r in rows:
        assert r["result"]["results"][0]["tpot_s"] > 0
    assert rows[1]["centroids"] == str(tmp_path / ART / "cents_M8_nbits5.npz")  # the trained tables
    z = np.load(tmp_path / ART / "cents_M8_nbits5.npz")
    assert z["key"].shape == (2, 8, 32, 2)  # (L, M, C, d_m)
    assert np.isfinite(z["key"]).all()
    assert (tmp_path / ART / "layer0.key.fvecs").exists()
    assert not Path("results.jsonl").exists()  # the port never writes the reference's ledger


def test_perplexity_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    np.save(tmp_path / "stream.npy", np.random.default_rng(0).integers(0, 256, 512).astype(np.int32))
    rows = run(tmp_path, "baseline", "evaluation", results="r.jsonl", overrides=(
        f"run.dataset={tmp_path}/stream.npy", "run.max_length=128", "run.max_windows=2"))
    base, ev = rows[0]["result"], rows[1]["result"]
    assert base["ppl"] > 0 and np.isfinite(base["ppl"])
    assert ev["ppl"] > 0 and np.isfinite(ev["ppl"])
    assert ev["windows"] == 2
    assert rows[1]["centroids"] == "_synthetic"  # no artifact under this dataset's directory


def test_longbench_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = [
        {"context": "The capital of France is Paris.", "input": "What is the capital?",
         "answers": ["Paris"], "all_classes": []},
        {"context": "Two plus two equals four.", "input": "What is 2+2?", "answers": ["four"],
         "all_classes": []},
    ]
    p = tmp_path / "hotpotqa.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows))
    res = run(tmp_path, "evaluation", results="lb.jsonl", overrides=(
        "run.dataset=longbench:hotpotqa", f"run.data_path={p}", "run.max_length=192"))[0]["result"]
    assert res["dataset"] == "hotpotqa" and res["n"] == 2
    assert 0.0 <= res["score"] <= 1.0


def test_lm_eval_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = [
        {"context": "The sky is", "choices": [" blue", " a potato"], "label": 0},
        {"context": "Water is", "choices": [" wet", " dry"], "label": 0},
    ]
    p = tmp_path / "mc.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows))
    res = run(tmp_path, "evaluation", results="mc_res.jsonl", overrides=(f"run.dataset=lm_eval:{p}",))[0]["result"]
    assert res["n"] == 2
    assert 0.0 <= res["acc"] <= 1.0


def test_asymmetric_geometry_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = run(tmp_path, "sampling", "training", "evaluation", results="asym.jsonl",
               overrides=("pq.M_v=4", "pq.nbits_v=5", *SPEED))
    assert rows[0]["result"]["results"][0]["tpot_s"] > 0
    z = np.load(tmp_path / ART / "cents_M8_nbits5_V4_5.npz")
    assert z["key"].shape == (2, 8, 32, 2)  # K: d_m=2
    assert z["value"].shape == (2, 4, 32, 4)  # V: d_m=4


def test_opq_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = run(tmp_path, "sampling", "training", "evaluation", results="opq.jsonl",
               overrides=("pq.opq=true", "pq.train_iters=6", *SPEED))
    assert rows[0]["result"]["results"][0]["tpot_s"] > 0
    z = np.load(tmp_path / ART / "cents_M8_nbits5_opq.npz")
    assert z["Rk"].shape == z["Rv"].shape == (2, 16, 16)
    np.testing.assert_allclose(z["Rk"][0] @ z["Rk"][0].T, np.eye(16), atol=1e-4)


def test_native_trainer_pipeline(tmp_path, monkeypatch):
    from million_tpu_torch.native import native_available

    if not native_available():
        pytest.skip("no native toolchain")
    monkeypatch.chdir(tmp_path)
    rows = run(tmp_path, "sampling", "training", "evaluation", results="nat.jsonl",
               overrides=("pq.native_trainer=true", *SPEED))
    assert rows[0]["result"]["results"][0]["tpot_s"] > 0
    z = np.load(tmp_path / ART / "cents_M8_nbits5.npz")
    assert np.isfinite(z["key"]).all()


def test_outlier_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = run(tmp_path, "sampling", "training", "evaluation", results="out.jsonl",
               overrides=("pq.M=4", "pq.outlier_k=2", "pq.outlier_v=2", *SPEED))
    assert rows[0]["result"]["results"][0]["tpot_s"] > 0
    z = np.load(tmp_path / ART / "cents_M4_nbits5_ok2_ov2.npz")
    assert z["k_outlier_idx"].shape == z["v_outlier_idx"].shape == (2, 2)
    assert z["k_outlier_idx"].dtype == np.int32
    for L in range(2):  # the zeroed-channel contract, strided layout
        for c in z["k_outlier_idx"][L]:
            assert abs(z["key"][L, c % 4, :, c // 4]).max() == 0.0


# --- the port's own contract ---------------------------------------------------------------------

def test_refusals_and_mode_mapping(tmp_path, monkeypatch):
    """OPQ with the native trainer or with outlier channels is refused, as in
    million_tpu.cli; run.mode "pq_pallas" runs (and records) "pq_kernel"; the
    card is the default device and its absence raises."""
    monkeypatch.chdir(tmp_path)
    run(tmp_path, "sampling", overrides=SPEED)
    for bad in (("pq.opq=true", "pq.native_trainer=true"), ("pq.opq=true", "pq.outlier_k=2")):
        with pytest.raises(ValueError):
            run(tmp_path, "training", overrides=bad)
    rows = run(tmp_path, "evaluation", results="pallas.jsonl", overrides=("run.mode=pq_pallas", *SPEED))
    assert rows[0]["mode"] == rows[0]["result"]["mode"] == "pq_kernel"
    assert rows[0]["config"]["run"]["mode"] == "pq_pallas"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(["-f", TINY, "-p", "evaluation"])


def test_python_m_entry_point(tmp_path):
    """`python -m million_tpu_torch.cli` runs from the repository root."""
    import subprocess
    import sys

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "million_tpu_torch.cli", "-f", TINY, "-p", "evaluation", "--device", "cpu",
         "-o", f"run.results={tmp_path}/r.jsonl", "-o", f"run.artifacts={tmp_path}/a", *[
             a for o in SPEED for a in ("-o", o)]],
        cwd=root, capture_output=True, text=True, timeout=300, env={**__import__("os").environ,
                                                                     "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert read_results(tmp_path / "r.jsonl")[0]["mode"] == "pq_kernel"


# --- parity with million_tpu.cli ------------------------------------------------------------------

def configs(tmp_path, *overrides):
    ov = [f"run.artifacts={tmp_path}/artifacts", *overrides]
    return (j_load_config([TINY], ov, base=jcli.DEFAULTS), load_config([TINY], ov, base=tcli.DEFAULTS))


@pytest.fixture(scope="module")
def params():
    cfg = jl.PRESETS["test-tiny"]
    jp = jl.init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, convert.params_from_numpy(tree, torch.float32, device="cpu")


MCFG_J, MCFG_T = jl.PRESETS["test-tiny"], tcli.llama.PRESETS["test-tiny"]


def test_config_defaults_match_the_reference():
    j, t = dict(jcli.DEFAULTS), dict(tcli.DEFAULTS)
    assert j["run"]["mode"] == "pq_pallas" and t["run"]["mode"] == "pq_kernel"
    assert j["run"]["results"] == "results.jsonl" and t["run"]["results"] == "results_torch.jsonl"
    strip = lambda d: {**d, "run": {k: v for k, v in d["run"].items() if k not in ("mode", "results")}}
    assert strip(j) == strip(t)


def test_sampling_writes_million_tpus_rows(tmp_path, params):
    jp, tp = params
    jcfg, _ = configs(tmp_path / "j")
    _, tcfg = configs(tmp_path / "t")
    jcli.stage_sampling(jcfg, MCFG_J, jp)
    out = tcli.stage_sampling(tcfg, MCFG_T, tp)
    assert out["rows_per_layer"] == 512
    for L in range(2):
        for side in ("key", "value"):
            a = read_fvecs(tmp_path / "j" / ART / f"layer{L}.{side}.fvecs")
            b = read_fvecs(tmp_path / "t" / ART / f"layer{L}.{side}.fvecs")
            assert a.shape == b.shape == (512, 16)
            # row by row: the same indices were drawn (rows of other indices differ by O(1))
            np.testing.assert_allclose(b, a, atol=1e-2)


@pytest.fixture(scope="module")
def sampled(tmp_path_factory, params):
    """million_tpu's sample files, shared by the training parity tests."""
    root = tmp_path_factory.mktemp("sampled")
    jcfg, _ = configs(root)
    jcli.stage_sampling(jcfg, MCFG_J, params[0])
    return root


def _train_both(root, tmp_path, params, *overrides):
    """Train on the same .fvecs with each package; returns their npz arrays."""
    out = []
    for pkg, mcfg, p in ((jcli, MCFG_J, params[0]), (tcli, MCFG_T, params[1])):
        j, t = configs(root, *overrides)
        cfg = j if pkg is jcli else t
        pkg.stage_training(cfg, mcfg, p)
        path = pkg.cents_path(cfg, mcfg)
        with np.load(path) as z:
            out.append({k: z[k] for k in z.files})
        path.rename(tmp_path / f"{pkg.__name__}.npz")
    return out


def test_native_trainer_bit_equal(tmp_path, sampled, params):
    from million_tpu.native import native_available as j_native
    from million_tpu_torch.native import native_available

    if not (native_available() and j_native()):
        pytest.skip("no native toolchain")
    a, b = _train_both(sampled, tmp_path, params, "pq.native_trainer=true")
    for k in ("key", "value"):
        np.testing.assert_array_equal(a[k], b[k])


def _recon_error(cents, samples, M):
    from million_tpu_torch.pq.ops import pq_decode, pq_encode

    c, x = torch.from_numpy(cents), torch.from_numpy(samples)
    return float((pq_decode(pq_encode(x, c, "strided"), c, "strided") - x).square().sum())


def test_kmeans_trainer_tracks_million_tpu(tmp_path, sampled, params):
    from million_tpu_torch.utils.fvecs import reservoir_sample_fvecs

    a, b = _train_both(sampled, tmp_path, params)
    err = {"j": 0.0, "t": 0.0}
    for L in range(2):
        for side, seed in (("key", L), ("value", 1000 + L)):
            x = reservoir_sample_fvecs(sampled / ART / f"layer{L}.{side}.fvecs", 512, seed=seed)
            err["j"] += _recon_error(a[side][L], x, 8)
            err["t"] += _recon_error(b[side][L], x, 8)
    print("reconstruction error, million_tpu / port:", err)
    assert abs(err["t"] - err["j"]) <= 0.01 * err["j"]


@pytest.mark.parametrize("overrides", [(), ("pq.opq=true", "pq.train_iters=4"),
                                       ("pq.M=4", "pq.outlier_k=2", "pq.outlier_v=2")],
                         ids=["pq", "opq", "outliers"])
def test_artifacts_cross_load(tmp_path, sampled, params, overrides):
    """Each package's trained artifact loads in the other with the same
    arrays, and the other's evaluation stage runs on it."""
    jp, tp = params
    for trainer, loader in ((jcli, tcli), (tcli, jcli)):
        j, t = configs(sampled, *overrides, *SPEED, f"run.results={tmp_path}/x.jsonl")
        mine, theirs = (j, t) if trainer is jcli else (t, j)
        trainer.stage_training(mine, MCFG_J if trainer is jcli else MCFG_T, jp if trainer is jcli else tp)
        with np.load(trainer.cents_path(mine, MCFG_J)) as z:
            saved = {k: z[k] for k in z.files}
        if loader is tcli:
            loaded = {k: v.numpy() for k, v in tcli.load_cents(theirs, MCFG_T, device="cpu").items()}
            tcli.stage_evaluation(theirs, MCFG_T, tp)
        else:
            loaded = {k: np.asarray(v) for k, v in jcli.load_cents(theirs, MCFG_J).items()
                      if k not in ("kpack", "vpack")}
            jcli.stage_evaluation(theirs, MCFG_J, jp)
        for k, v in saved.items():
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)
        trainer.cents_path(mine, MCFG_J).unlink()
    rows = read_results(tmp_path / "x.jsonl")
    assert len(rows) == 2 and all(r["result"]["results"][0]["tpot_s"] > 0 for r in rows)


@pytest.mark.parametrize("overrides", [(), ("pq.opq=true",), ("pq.M=4", "pq.outlier_k=2", "pq.outlier_v=3"),
                                       ("pq.M_v=4", "pq.nbits_v=4")],
                         ids=["pq", "opq", "outliers", "asymmetric"])
def test_synthetic_tables_bit_equal(tmp_path, overrides):
    j, t = configs(tmp_path, *overrides)
    want = {k: np.asarray(v) for k, v in jcli.load_cents(j, MCFG_J).items() if k not in ("kpack", "vpack")}
    got = {k: v.numpy() for k, v in tcli.load_cents(t, MCFG_T, device="cpu").items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_perplexity_kind_matches_million_tpu(tmp_path, params):
    jp, tp = params
    np.save(tmp_path / "stream.npy", np.random.default_rng(1).integers(0, 256, 400).astype(np.int32))
    j, t = configs(tmp_path, f"run.dataset={tmp_path}/stream.npy", "run.max_length=128", "run.max_windows=3")
    jt = jcli.load_cents(j, MCFG_J)
    tt = tcli.load_cents(t, MCFG_T, device="cpu")
    for jmode, tmode, cents in (("dense", "dense", None), ("pq_pallas", "pq_pallas", "tables")):
        want = jcli.run_benchmark(j, MCFG_J, jp, jmode, jt if cents else None)
        got = tcli.run_benchmark(t, MCFG_T, tp, tmode, tt if cents else None)
        assert got["windows"] == want["windows"] == 3
        assert abs(got["ppl"] - want["ppl"]) <= 1e-3 * want["ppl"], (jmode, got, want)

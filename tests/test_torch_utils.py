"""The port's copies of million_tpu's JAX-free utilities against the
originals: config layering and overrides, the results ledger, .fvecs files
(bit-compatible both ways), the reservoir sample (the same rows from the same
file), partition_ranges, and the benchmark registry (dataset kinds, token
streams, the byte tokenizer)."""

import json

import numpy as np
import pytest

from million_tpu.benchmarks import registry as jreg
from million_tpu.utils import config as jconfig
from million_tpu.utils import fvecs as jfvecs
from million_tpu_torch.benchmarks import registry as treg
from million_tpu_torch.utils import fvecs as tfvecs
from million_tpu_torch.utils.config import Config, load_config
from million_tpu_torch.utils.ledger import RESULTS, append_result, read_results


def test_config_layering_matches_million_tpu(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps({"x": {"a": 1, "b": 2}, "y": 1, "z": {"w": {}}}))
    (tmp_path / "b.json").write_text(json.dumps({"x": {"b": 3}}))
    files = [str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    ov = ["x.c=[1,2]", "y=hello", "z.w.deep=true", "run.mode=pq_pallas", "n=3.5"]
    base = {"run": {"mode": "pq_kernel", "k": 1}}
    cfg = load_config(files, ov, base=base)
    assert cfg.x.a == 1 and cfg.x.b == 3 and cfg.x.c == [1, 2]
    assert cfg.y == "hello" and cfg.z.w.deep is True and cfg.n == 3.5
    assert cfg.run.mode == "pq_pallas" and cfg.run.k == 1
    assert base == {"run": {"mode": "pq_kernel", "k": 1}}  # overrides leave the base as it was
    # (million_tpu's shallow copy writes the override into base["run"]: give it its own)
    assert cfg.to_dict() == jconfig.load_config(files, ov, base=json.loads(json.dumps(base))).to_dict()
    with pytest.raises(AttributeError):
        _ = cfg.missing  # no auto-vivification
    with pytest.raises(TypeError):
        cfg.y = 2  # immutable
    assert isinstance(cfg.x, Config) and cfg.get("missing", 7) == 7 and len(cfg) == 5


def test_config_roundtrip():
    cfg = load_config(base={"a": {"b": [1, 2]}})
    assert cfg.to_dict() == {"a": {"b": [1, 2]}}
    assert json.loads(json.dumps(cfg.to_dict())) == cfg.to_dict()
    assert load_config(base=cfg.to_dict()).to_dict() == cfg.to_dict()


def test_ledger(tmp_path):
    assert RESULTS == "results_torch.jsonl"
    p = tmp_path / "res.jsonl"
    append_result(p, {"stage": "s1", "v": 1})
    append_result(p, {"stage": "s2", "v": 2})
    rows = read_results(p)
    assert [r["stage"] for r in rows] == ["s1", "s2"] and all("ts" in r for r in rows)
    assert read_results(tmp_path / "none.jsonl") == []


@pytest.mark.parametrize("writer,reader", [(jfvecs, tfvecs), (tfvecs, jfvecs)], ids=["jax_to_port", "port_to_jax"])
def test_fvecs_cross_package_bit_equal(tmp_path, rng, writer, reader):
    x = rng.standard_normal((37, 12)).astype(np.float32)
    a, b = tmp_path / "a.fvecs", tmp_path / "b.fvecs"
    writer.write_fvecs(a, x[:20])
    writer.write_fvecs(a, x[20:])  # appends
    reader.write_fvecs(b, x, append=False)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(reader.read_fvecs(a), x)
    np.testing.assert_array_equal(reader.read_fvecs(a, max_n=5), x[:5])
    got = np.concatenate(list(reader.read_fvecs_batched(a, batch=8)))
    np.testing.assert_array_equal(got, x)
    with pytest.raises(ValueError):
        reader.write_fvecs(b, x[0])


@pytest.mark.parametrize("k", [10, 64, 500])
def test_reservoir_picks_million_tpus_rows(tmp_path, rng, k):
    x = rng.standard_normal((300, 8)).astype(np.float32)
    tfvecs.write_fvecs(tmp_path / "s.fvecs", x, append=False)
    for seed in (0, 3):
        want = jfvecs.reservoir_sample_fvecs(tmp_path / "s.fvecs", k, seed=seed, batch=64)
        got = tfvecs.reservoir_sample_fvecs(tmp_path / "s.fvecs", k, seed=seed, batch=64)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (min(k, 300), 8)


def test_partition_ranges():
    for n, parts in ((10, 3), (7, 7), (0, 2), (5, 8)):
        assert list(tfvecs.partition_ranges(n, parts)) == list(jfvecs.partition_ranges(n, parts))
    with pytest.raises(ValueError):
        list(tfvecs.partition_ranges(3, 0))


def test_registry_matches_million_tpu(tmp_path):
    for name in ("_synthetic", "wikitext-2", "ptb", "a.txt", "b.npy", "longbench:lcc", "lm_eval:x.jsonl",
                 "lm_eval:task:arc", "other"):
        assert treg.select_benchmark(name) == jreg.select_benchmark(name), name
    np.testing.assert_array_equal(treg.load_tokens("_synthetic", vocab_size=300),
                                  jreg.load_tokens("_synthetic", vocab_size=300))
    (tmp_path / "t.txt").write_text("héllo world, twice: héllo world\n")
    np.save(tmp_path / "s.npy", np.arange(50, dtype=np.int64))
    for name in ("t.txt", "s.npy"):
        p = str(tmp_path / name)
        np.testing.assert_array_equal(treg.load_tokens(p, treg.ByteTokenizer(), vocab_size=100),
                                      jreg.load_tokens(p, jreg.ByteTokenizer(), vocab_size=100))
    tok = treg.load_tokenizer("byte")
    assert tok("héllo")["input_ids"] == jreg.ByteTokenizer()("héllo")["input_ids"]
    assert tok.decode(tok("héllo")["input_ids"]) == "héllo"
    with pytest.raises(ValueError, match="unknown dataset"):
        treg.load_tokens("no-such-dataset")
    with pytest.raises(ValueError, match="tokenizer"):
        treg.load_tokens(str(tmp_path / "t.txt"))

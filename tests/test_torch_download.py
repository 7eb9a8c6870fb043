"""The port's offline fetchers (million_tpu_torch/utils/download.py) against
million_tpu's: with the network probe replaced (no test reaches the network),
each gives the same pinned fixture, or the same refusal for a model."""

from pathlib import Path

import pytest

from million_tpu.utils import download as jd
from million_tpu_torch.utils import download as td


@pytest.fixture
def offline(monkeypatch):
    for mod in (jd, td):
        monkeypatch.setattr(mod, "have_network", lambda *a, **k: False)


def test_ppl_fetch_gives_the_reference_fixture(offline, tmp_path):
    got = td.fetch_ppl_dataset("wikitext-2", tmp_path)
    assert got == jd.fetch_ppl_dataset("wikitext-2", tmp_path) and got.name == "realtext.txt" and got.exists()
    assert td.FIXTURES == jd.FIXTURES and set(td.PPL_SETS) == set(jd.PPL_SETS)


def test_longbench_fetch_gives_the_reference_fixture(offline, tmp_path):
    got = td.fetch_longbench_task("passage_count", tmp_path)
    assert got == jd.fetch_longbench_task("passage_count", tmp_path)
    assert got.name == "longbench_fixture.jsonl" and got.exists()


def test_cached_copy_is_returned_first(offline, tmp_path):
    (tmp_path / "ptb.txt").write_text("cached")
    assert td.fetch_ppl_dataset("ptb", tmp_path) == jd.fetch_ppl_dataset("ptb", tmp_path) == tmp_path / "ptb.txt"


def test_model_fetch_raises_offline(offline):
    for mod in (td, jd):
        with pytest.raises(RuntimeError, match="no network"):
            mod.fetch_model("TinyLlama/TinyLlama-1.1B-Chat-v1.0", Path("/nonexistent"))


def test_main_prints_the_fixture(offline, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["download", "--dataset", "longbench:qasper", "--out", str(tmp_path)])
    td.main()
    assert capsys.readouterr().out.strip().endswith("longbench_fixture.jsonl")

"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import manifest

ROOT = manifest.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p and (ROOT / p).is_dir()
        assert not p.endswith("_torch")


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"] == []
        assert body["head_dim"] * body["num_attention_heads"] == body["hidden_size"]
        # its architecture's two sides, found by name
        for kind in ("reference", "programs"):
            assert (manifest.PACKAGE / kind / f"{body['architecture']}.py").exists(), (c["name"], kind)
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench" / "cells" / f"{w['name']}.json").exists()


def test_metrics_entries():
    e2e, pl = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    assert "setup_s" in E2E
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cells
    layers = {}
    for m in pl:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in E2E
        assert set(m.get("workloads", [])) <= cells
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    # one layer, one name, letter for letter
    assert all(len(v) == 1 for v in layers.values()), layers


def test_moves_targets_reported_where_the_layer_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for cell in (w["name"] for w in BENCH["workloads"] if reports(m, w["name"])):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, w["name"])]
        pl = [m for m in BENCH["per_layer"] if reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2 and pl, w["name"]
        # a kernel's roofline share stands beside the whole step's share of the peak
        for m in pl:
            if m["name"].endswith("_roofline"):
                assert any("mfu" in o["name"] and o["moves"] == m["moves"] for o in pl), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(cell):
    c = manifest.load_cell(cell)
    names = [m.name for m in c.metrics]
    assert "setup_s" in names and all(callable(m.read) for m in c.metrics)
    assert c.traffic["kind"] in ("closed", "open") and c.config["name"] == c.name.split(".")[0]
    assert c.limits["limits"]["logit_gap_max"] > 0
    # the number the control fails: it reads 1 there
    assert 0 < c.limits["limits"]["logit_err_vs_fp8"] < 1
    if c.traffic["kind"] == "open":
        assert c.traffic["rate_per_s"] > 0


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(KeyError):
        manifest.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        manifest.load_reader("no_such_metric", [tmp_path])

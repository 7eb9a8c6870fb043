"""On the card, at each cell's own size: the control of the correctness
limits (the reference computed with fp8 products, put in the program's
place over the same prompts and served tokens) has to come out not correct
through the harness's own comparison, while the program's own numbers on
those tokens pass; and a fault (every fifth sampled token altered) has to
fail the gap. Marked `cuda`: skipped without a card (decided inside the
test)."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench.manifest import ROOT, load_cell
from perfbench.run import passes, run_cell
from perfbench.tests.faults import token_altered

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = run_cell(load_cell(cell), 2**31 + 99, 50.0, False, "cuda", control=True)
    assert not res["correct"], res["check"]
    assert res["check"]["logit_err_vs_fp8"]["value"] > res["check"]["logit_err_vs_fp8"]["max"]
    assert passes(res["program"]), res["program"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_token_fails_the_gap(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with token_altered():
        res = run_cell(load_cell(cell), 2**31 + 98, 5.0, False, "cuda")
    assert not res["correct"]
    assert res["check"]["logit_gap_max"]["value"] > res["check"]["logit_gap_max"]["max"], res["check"]

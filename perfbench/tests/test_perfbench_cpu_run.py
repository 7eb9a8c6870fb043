"""A whole run on the CPU at tiny widths, through the harness's run path:
the port's Scheduler against the plain reference, with the harness finding
a throwaway configuration, mix and metric in a temporary directory; then
the same run with the timed path broken underneath, and with the control in
the program's place, where `correct` has to come out false."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench.manifest import load_cell
from perfbench.run import run_cell
from perfbench.tests import tiny
from perfbench.tests.faults import FAULTS

THROWAWAY = {"name": "throwaway.steps", "unit": "steps", "better": "higher", "source": "program_span",
             "layer": "harness", "moves": "setup_s"}
READER = '''"""Steps in the window (a reader that lives only in a test's directory)."""


def read(run):
    return len(run.phase_steps("window"))
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.write_root(tmp_path_factory.mktemp("bench"), extra_per_layer=[THROWAWAY])
    (r / "perfbench" / "metrics" / "throwaway.steps.py").write_text(READER)
    return r


@pytest.mark.parametrize("cell", ["tiny-dm2.tiny-closed", "tiny-outlier.tiny-closed",
                                  "tiny-dm2.tiny-open", "tiny-outlier.tiny-open"])
def test_program_agrees_with_the_reference(root, cell):
    c = load_cell(cell, root)
    res = run_cell(c, 2**31 + 5, 1.0, False, device="cpu")
    assert res["correct"], res["check"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    want = {"setup_s"} | ({"decode_tok_s"} if "closed" in cell else {"ttft_p90_s", "tpot_p90_ms"})
    assert set(res["metrics"]) == want
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["check"]["tokens_compared"]["value"] >= 20
    json.dumps(res)


def test_traced_run_reads_the_layer_metrics(root):
    res = run_cell(load_cell("tiny-dm2.tiny-closed", root), 17, 1.0, True, device="cpu")
    assert res["correct"]
    assert {"host_ms_per_tick.decode", "mfu.decode", "throwaway.steps"} <= set(res["metrics"])
    assert res["metrics"]["throwaway.steps"]["value"] > 0
    assert "breakdown" in res and "window_s" in res["device"]


def _fast_roundtrip(x, cents, oidx):
    """pq_roundtrip with the nearest centroid found from bf16-rounded inputs,
    as the program's "fast" encode finds it; decoded from the f32 codebook."""
    M, C, dm = cents.shape
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    xs = flat.to(torch.bfloat16).float().reshape(-1, dm, M).transpose(1, 2)
    cb = cents.to(torch.bfloat16).float()
    dist = torch.baddbmm((cb * cb).sum(-1)[:, None, :], xs.transpose(0, 1), cb.transpose(1, 2), alpha=-2.0)
    out = cents[torch.arange(M)[None, :], dist.argmin(-1).t()].transpose(1, 2).reshape(-1, d)
    if oidx is not None:
        out[:, oidx.long()] = flat[:, oidx.long()]
    return out.reshape(x.shape)


@pytest.mark.parametrize("cell", ["tiny-dm2.tiny-closed", "tiny-dm2.tiny-open", "tiny-outlier.tiny-closed"])
def test_reference_attends_what_the_program_quantized(tmp_path, monkeypatch, cell):
    """In f32, with the reference's encode rounding its inputs as the
    program's does, every served token is the reference's argmax and its
    logit the reference's to f32 rounding (the exact channels, which the
    program stores in bf16, aside): the reference attends quantized exactly
    the tokens the program did, chunk by chunk and window by window."""
    c = load_cell(cell, tiny.write_root(tmp_path, dtype="float32"))
    monkeypatch.setattr(c.plain, "pq_roundtrip", _fast_roundtrip)
    res = run_cell(c, 2**31 + 3, 1.0, False, device="cpu")
    tol = 2e-2 if "outlier" in cell else 1e-4
    assert res["check"]["logit_err_max"]["value"] < tol, res["check"]
    if "outlier" not in cell:
        assert res["check"]["logit_gap_max"]["value"] == 0.0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny-dm2.tiny-closed", "tiny-dm2.tiny-open"])
def test_a_broken_path_is_not_correct(root, cell, fault):
    with FAULTS[fault]():
        res = run_cell(load_cell(cell, root), 2**31 + 5, 1.0, False, device="cpu")
    assert not res["correct"]
    assert max(res["check"][k]["value"] - tiny.LIMITS[k] for k in ("logit_gap_max", "logit_err_vs_fp8")) > 0


@pytest.mark.parametrize("cell", ["tiny-dm2.tiny-closed", "tiny-outlier.tiny-open"])
def test_the_control_in_the_programs_place_is_not_correct(root, cell):
    """The fp8 reference put in the program's place fails the run through
    the harness's own comparison, on the tokens the program served, which
    pass it."""
    res = run_cell(load_cell(cell, root), 2**31 + 5, 1.0, False, device="cpu", control=True)
    assert not res["correct"]
    assert res["check"]["logit_err_vs_fp8"]["value"] == 1.0 > tiny.LIMITS["logit_err_vs_fp8"]
    assert all(c["value"] <= c.get("max", float("inf")) and c["value"] >= c.get("min", 0)
               for c in res["program"].values()), res["program"]
    assert list(res)[-1] == "check"

"""The readers of the program's own spans and counters (program_trace.py and
four metrics) on a traced CPU run of the tiny closed cell, and on a program
without a tracer, where each finds nothing and raises nothing."""

from __future__ import annotations

import types

import pytest

from perfbench import program_trace, system
from perfbench.manifest import ROOT, load_cell, load_reader
from perfbench.run import run_cell
from perfbench.tests import tiny

NAMES = ("dispatch_ms_per_tick.decode", "readback_wait_ms_per_tick.decode", "device_ms_per_tick.decode",
         "admit_ms_per_ktok.decode")
LAYERS = {"dispatch_ms_per_tick.decode": "scheduler", "readback_wait_ms_per_tick.decode": "scheduler",
          "device_ms_per_tick.decode": "paged model step", "admit_ms_per_ktok.decode": "admission"}
CELL = "tiny-dm2.tiny-closed"


def entries():
    return [{"name": n, "unit": "ms/ktok" if "ktok" in n else "ms/tick", "better": "lower",
             "source": "program_span", "layer": LAYERS[n],
             "moves": "setup_s" if "admit" in n else "decode_tok_s", "workloads": [CELL]} for n in NAMES]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = tiny.write_root(tmp_path_factory.mktemp("bench"), extra_per_layer=entries())
    tracer = program_trace.tracer()
    tracer.reset()  # the counters of this process's earlier runs
    try:
        yield run_cell(load_cell(CELL, root), 2**31 + 9, 1.0, True, device="cpu")
    finally:
        tracer.reset()


def test_traced_run_reads_the_programs_spans(traced):
    assert traced["correct"], traced["check"]
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    assert {"dispatch_ms_per_tick.decode", "readback_wait_ms_per_tick.decode", "admit_ms_per_ktok.decode",
            "host_ms_per_tick.decode"} <= set(m)
    assert "device_ms_per_tick.decode" not in m  # no device events on the CPU
    assert m["readback_wait_ms_per_tick.decode"] == 0.0  # nothing to wait on here
    assert 0 < m["dispatch_ms_per_tick.decode"] and m["admit_ms_per_ktok.decode"] > 0
    assert traced["metrics"]["admit_ms_per_ktok.decode"]["unit"] == "ms/ktok"


def test_only_the_traced_segment_is_recorded(traced):
    tr = program_trace.tracer()
    assert not tr.named("scheduler.admit")  # the set-up's admissions ran before the profiler
    assert tr.named("scheduler.dispatch") and tr.counters["admissions"] == 4


def test_admission_reader_wants_the_setups_tokens(traced):
    read = load_reader("admit_ms_per_ktok.decode", [ROOT])
    assert read(types.SimpleNamespace(phase_steps=lambda phase: [])) is None


@pytest.mark.parametrize("name", NAMES)
def test_readers_find_nothing_in_a_program_without_a_tracer(monkeypatch, name):
    monkeypatch.setattr(system, "sched_mod", types.SimpleNamespace())
    assert load_reader(name, [ROOT])(types.SimpleNamespace(phase_steps=lambda phase: [])) is None

"""A configuration names its architecture, and the harness takes the
weights, the reference, the PQ layers, the operation counts and the port's
configuration from that architecture's files:

- the llama architecture draws the same weights and codebooks and computes
  the same reference logits as the harness did before it was split by
  architecture (constants from that harness, at tiny widths on the CPU), and
  its readers read the same numbers from the same record;
- a throwaway architecture that lives only in a test's directory runs a
  whole cell, correct, touching no file of the benchmark;
- a configuration without an architecture, or naming one without files, is
  refused by name.
"""

from __future__ import annotations

import json
import math
import types

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.manifest import PACKAGE, ROOT, load_cell, load_module, load_reader
from perfbench.run import run_cell
from perfbench.tests import tiny

# math.fsum of each tensor, from the harness before the split (its
# inputs.make_weights / make_codebooks and reference/model.py), seed 2**31 + 5
WEIGHTS = {
    "embed": -6.253367841243744, "final_norm": 64.0, "layers.attn_norm": 128.0, "layers.mlp_norm": 128.0,
    "layers.wq": -20.081480264663696, "layers.wk": -11.291886329650879, "layers.wv": -14.554551482200623,
    "layers.wo": 9.271898418664932, "layers.w_gate": 3.399665594100952, "layers.w_up": 3.756564199924469,
    "layers.w_down": -2.297963708639145, "layers.bq": -0.3435211181640625, "layers.bk": 4.092720687389374,
    "layers.bv": -2.9835205078125,
}
PINNED = {
    "tiny-dm2": {
        "weights": {**WEIGHTS, "lm_head": -2.2990410029888153},
        "codebooks": {"key": -9.648175618378446, "value": 38.483464012504555},
        # (sum, sum of magnitudes) of the logits
        "logits": {"f32": (19.201940179395024, 1568.04078505683), "fp8": (36.318002845393494, 1567.5464100155514)},
    },
    "tiny-outlier": {
        "weights": WEIGHTS,
        "codebooks": {"key": -14.053691868670285, "value": 0.1557884078938514, "k_outlier_idx": 38.0,
                      "v_outlier_idx": 18.0},
        "logits": {"f32": (-97.65770914513269, 1466.6816056660318),
                   "fp8": (-91.01334911013964, 1460.3647156875568)},
    },
}
# the readers over the record `synthetic_record` builds, from the same harness
READ = {
    "mistral-7b": {"b4_roofline": 168.98475206686567, "b3_roofline": 3201.813435788553,
                   "mfu.decode": 29.86361615383814, "mfu.qa": 29.86361615383814},
    "qwen2-7b": {"b4_roofline": 73.98361974447751, "b3_roofline": 2604.6001875115867,
                 "mfu.decode": 26.096889151769627, "mfu.qa": 26.096889151769627},
}


def fsum(t: torch.Tensor) -> float:
    return math.fsum(t.double().flatten().tolist())


def leaves(d: dict, prefix: str = ""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("config", sorted(PINNED))
def test_llama_draws_and_computes_as_before(root, config):
    cell = load_cell(f"{config}.tiny-closed", root)
    m, plain, cpu = cell.config, cell.plain, torch.device("cpu")
    assert plain.pq_layers(m) == [0, 1]
    s_w, s_t = np.random.SeedSequence(2**31 + 5).spawn(2)
    w = plain.make_weights(m, s_w, cpu)
    t = inputs.make_codebooks(m, plain.pq_layers(m), s_t, cpu)
    want = PINNED[config]
    assert {k: fsum(v) for k, v in leaves(w)} == want["weights"]
    assert {k: fsum(v) for k, v in t.items()} == want["codebooks"]
    rng = np.random.default_rng(7)
    prompt, served = rng.integers(0, m["vocab_size"], 40), rng.integers(0, m["vocab_size"], 12)
    for precision, (total, magnitude) in want["logits"].items():
        lg = plain.Reference(w, m, t, precision=precision).logits(prompt, served, 16, m["paging"]["Lt"])
        assert (fsum(lg), fsum(lg.abs())) == pytest.approx((total, magnitude), rel=1e-6), precision


def synthetic_record(config: dict, plain) -> types.SimpleNamespace:
    """Ten steps of 8 decode ticks over 16 slots and one chunked admission of
    three prompts, in the window and in the traced segment; each kernel
    pattern 0.25 s of traced time."""
    ns = types.SimpleNamespace
    tick = ns(codes=[33000 + 64 * i for i in range(16)], rows=[1 + 7 * i for i in range(16)],
              positions=[33100 + 64 * i for i in range(16)])
    step = ns(calls=ns(ticks=[tick] * 8, admissions=[ns(lens=[32640, 30720, 4096], chunk=2048)]))
    return ns(config=config, plain=plain, trace=ns(kernel_s=lambda pattern: (0.25, 3)),
              phase_steps=lambda phase: [step] * 10, t0=0.0, t1=50.0)


@pytest.mark.parametrize("config", sorted(READ))
def test_readers_read_as_before(config):
    m = json.loads((PACKAGE / "configs" / f"{config}.json").read_text())
    record = synthetic_record(m, load_module("reference", m["architecture"], [ROOT]))
    assert {n: load_reader(n, [ROOT])(record) for n in READ[config]} == READ[config]


THROWAWAY_REFERENCE = '''"""A throwaway architecture: llama's model, its weights drawn from a
stream of their own; every call the harness makes is recorded."""

from perfbench.reference import llama

CALLS = []


def make_weights(m, ss, device):
    CALLS.append("make_weights")
    return llama.make_weights(m, ss.spawn(1)[0], device)


def pq_layers(m):
    CALLS.append("pq_layers")
    return llama.pq_layers(m)


def token_flops(m, context, head):
    CALLS.append("token_flops")
    return llama.token_flops(m, context, head)


def prompt_flops(m, n):
    CALLS.append("prompt_flops")
    return llama.prompt_flops(m, n)


class Reference(llama.Reference):
    def __init__(self, *args, **kwargs):
        CALLS.append("Reference")
        super().__init__(*args, **kwargs)
'''
THROWAWAY_PROGRAM = '''"""The port's side of the throwaway architecture: llama's."""

from perfbench.programs import llama

CALLS = []


def model_config(m):
    CALLS.append("model_config")
    return llama.model_config(m)


def cache_config(m, mix):
    CALLS.append("cache_config")
    return llama.cache_config(m, mix)
'''


def benchmark_files() -> dict:
    files = [p for p in PACKAGE.rglob("*") if p.is_file() and "__pycache__" not in p.parts]
    return {p: (p.stat().st_mtime_ns, p.stat().st_size) for p in files + [ROOT / "BENCHMARK.json"]}


def test_a_new_architecture_is_new_files(tmp_path):
    before = benchmark_files()
    configs = {**tiny.CONFIGS, "tiny-throwaway": {**tiny.CONFIGS["tiny-dm2"], "architecture": "throwaway"}}
    root = tiny.write_root(tmp_path, configs=configs)
    for kind, src in (("reference", THROWAWAY_REFERENCE), ("programs", THROWAWAY_PROGRAM)):
        (root / "perfbench" / kind).mkdir()
        (root / "perfbench" / kind / "throwaway.py").write_text(src)
    cell = load_cell("tiny-throwaway.tiny-closed", root)
    assert cell.plain.__file__.startswith(str(root)) and cell.program.__file__.startswith(str(root))
    res = run_cell(cell, 2**31 + 5, 1.0, True, device="cpu")
    assert res["correct"], res["check"]
    assert "mfu.decode" in res["metrics"]
    # an admission cell's readers count prompts by the same module
    assert load_reader("mfu.qa", [ROOT])(synthetic_record(cell.config, cell.plain)) > 0
    assert set(cell.plain.CALLS) == {"make_weights", "pq_layers", "token_flops", "prompt_flops", "Reference"}
    assert set(cell.program.CALLS) == {"model_config", "cache_config"}
    assert benchmark_files() == before


def test_a_configuration_names_an_architecture_with_files(tmp_path):
    configs = {"tiny-none": {k: v for k, v in tiny.CONFIGS["tiny-dm2"].items() if k != "architecture"},
               "tiny-nosuch": {**tiny.CONFIGS["tiny-dm2"], "architecture": "nosuch"}}
    root = tiny.write_root(tmp_path, configs=configs)
    with pytest.raises(ValueError, match="names no architecture"):
        load_cell("tiny-none.tiny-closed", root)
    with pytest.raises(FileNotFoundError, match="reference/nosuch.py"):
        load_cell("tiny-nosuch.tiny-closed", root)

"""A throwaway benchmark root at test-tiny widths for the CPU tests: a
BENCHMARK.json naming tiny configurations, mixes and cells, written into a
temporary directory, whose files the harness finds by name as it finds the
real ones."""

from __future__ import annotations

import json
from pathlib import Path

TINY_MODEL = {
    "architecture": "llama",
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "attention_bias": True,
    "paging": {"page_size": 16, "Lt": 8, "tick_chain": 4, "admit_chunk": 16, "admit_batch": 8},
}
CONFIGS = {
    "tiny-dm2": {**TINY_MODEL, "pq": {"d_m": 2, "C": 16, "outliers": 0}},
    "tiny-outlier": {**TINY_MODEL, "tie_word_embeddings": True,
                     "pq": {"d_m": 4, "C": 8, "outliers": 2}},
}
MIXES = {
    "tiny-closed": {"kind": "closed", "requests": 4, "prompt": {"dist": "fixed", "tokens": 40},
                    "output": {"dist": "fixed", "tokens": 400}, "slots": 4, "pages_per_slot": 30,
                    "warm_steps": 1, "trace_seconds": 0.3, "check": {"requests": 4}},
    "tiny-open": {"kind": "open", "rate_per_s": 15.0, "arrivals": {"dist": "poisson"},
                  "prompt": {"dist": "loguniform", "min": 12, "max": 60, "multiple": 4},
                  "output": {"dist": "uniform", "min": 12, "max": 28}, "slots": 4, "pages_per_slot": 8,
                  "warmup": [{"prompt": 60, "output": 4}], "trace_seconds": 0.3, "follow_seconds": 30,
                  "check": {"requests": 40}},
}
# the program in bf16 reads a gap of 0.05-0.23 here against the f32 reference and
# 0.16-0.71 of the fp8 reference's widest difference (tiny widths, seeds 2**31 + 5, 7
# and 11, CPU runs); the control reads 1 of it, the faults of faults.py a gap of 2.2-3.6
LIMITS = {"logit_gap_max": 1.0, "logit_err_vs_fp8": 0.85, "tokens_compared_min": 20}


def write_root(root: Path, extra_per_layer=(), dtype: str = "bfloat16", configs=None) -> Path:
    """Write the tiny benchmark, its models served in `dtype`, under root
    and return root: a cell for each of `configs` (default CONFIGS) under
    each mix."""
    configs = CONFIGS if configs is None else configs
    pb = root / "perfbench"
    for sub in ("configs", "traffic", "cells", "metrics"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for name, c in configs.items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps({"name": name, **c, "torch_dtype": dtype}))
    for name, mix in MIXES.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    cells = []
    for cfg in configs:
        for mix in MIXES:
            name = f"{cfg}.{mix}"
            cells.append({"name": name, "config": cfg, "traffic": mix, "chips": 1, "why": "CPU test"})
            (pb / "cells" / f"{name}.json").write_text(json.dumps({"limits": LIMITS}))
    closed = [c["name"] for c in cells if c["traffic"] == "tiny-closed"]
    opened = [c["name"] for c in cells if c["traffic"] == "tiny-open"]
    bench = {
        "command": ["python3", "-m", "perfbench.run"], "paths": ["perfbench"], "run_seconds": 1,
        "configs": [{"name": n, "source": "test", "file": f"perfbench/configs/{n}.json", "reduced": [],
                     "why": "CPU test"} for n in configs],
        "workloads": cells,
        "end_to_end": [
            {"name": "decode_tok_s", "unit": "tokens/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": closed},
            {"name": "ttft_p90_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock",
             "workloads": opened},
            {"name": "tpot_p90_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
             "workloads": opened},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
        ],
        "per_layer": [
            {"name": "host_ms_per_tick.decode", "unit": "ms/tick", "better": "lower", "source": "program_span",
             "layer": "scheduler", "moves": "decode_tok_s", "workloads": closed},
            {"name": "mfu.decode", "unit": "%", "better": "higher", "source": "host_clock",
             "layer": "whole step", "moves": "decode_tok_s", "workloads": closed},
            {"name": "admit_ms_per_ktok.qa", "unit": "ms/ktok", "better": "lower", "source": "program_span",
             "layer": "admission", "moves": "ttft_p90_s", "workloads": opened},
            {"name": "decode_step_ms.qa", "unit": "ms/tick", "better": "lower", "source": "program_span",
             "layer": "scheduler", "moves": "tpot_p90_ms", "workloads": opened},
            *extra_per_layer,
        ],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root

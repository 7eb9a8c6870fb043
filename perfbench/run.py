"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the line's metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer ones (read from a traced segment after the window).
The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device[, breakdown], check (each compared number beside its
limit, also the last lines of standard error). No card, too few cards, or a
JAX module in the process at the end: no result, and a non-zero exit.

Calibration option (not used by the check): --control 1 puts the fp8
reference, the control of the correctness limits, in the program's place
over the same prompts and served tokens; the line then judges the control
(`correct` false where the limits hold) and carries the program's own
numbers on those tokens under "program".
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from perfbench import driver
from perfbench.manifest import ROOT, Cell, load_cell, metric_values

BANNED = {"jax", "jaxlib", "flax", "million_tpu"}


def banned_modules() -> set:
    return {name.split(".")[0] for name in list(sys.modules)} & BANNED


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False) -> dict:
    """One run; returns the result object (without printing it)."""
    run = driver.Run(cell, seed, seconds, trace, device)
    out = run.serve()
    mix = cell.traffic
    if mix["kind"] == "closed":
        judged = list(run.reqs.values())
        failed = sum(r.tokens is None or len(r.tokens) == 0 for r in judged)
        candidates = [r for r in judged if r.tokens is not None and len(r.tokens)]
    else:
        judged = [r for r in run.reqs.values() if out["t0"] <= r.due < out["t1"]]
        failed = sum(r.finish is None for r in judged)
        candidates = [r for r in judged if r.finish is not None]
    late = [r.submitted - r.due for r in judged if r.due is not None]
    if late:
        driver.log(f"generator: {len(late)} requests due in the window, late by p50 "
                   f"{float(np.median(late)):.4f} s, max {max(late):.4f} s")
    peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    record = driver.RunRecord(cell.config, cell.plain, out["setup_s"], out["t0"], out["t1"], run.steps,
                              run.reqs, out["tokens"], peak, out["trace"])
    chunks = run.chunks_by_rid()
    logits = run.probe.sampled_logits()
    candidates = [r for r in candidates if chunks.get(r.rid, -1) != -1 and r.rid in logits]
    sample = driver.choose_sample(candidates, int(mix["check"]["requests"]), run.sample_rng)
    run.release()
    driver.log(f"comparing requests {[r.rid for r in sample]} "
               f"({sum(len(r.tokens) for r in sample)} served tokens) with the reference")
    lim = cell.limits["limits"]
    nums = driver.check(run, sample, chunks, logits, fp8="logit_err_vs_fp8" in lim, control=control)
    check = compared(nums, lim, failed, out["page_table_errors"])
    correct = passes(check)
    driver.log(f"argmax agreement {nums['argmax_agree']:.6f}, preemptions {out['preemptions']}")
    if control:
        own = compared(nums["program"], lim, failed, out["page_table_errors"])
        driver.log(f"control (the fp8 reference in the program's place) correct {correct}; the program's "
                   f"own numbers on these tokens, correct {passes(own)}: "
                   + ", ".join(f"{k} {c['value']!r}" for k, c in own.items()))
    kind = "per_layer" if trace else "end_to_end"
    device_info = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if run.device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(judged), "failed": int(failed),
              "metrics": metric_values(cell, record, kind), "device": device_info}
    if trace and record.trace is not None:
        device_info.update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
        result["breakdown"] = record.trace.breakdown()
    if control:
        result["program"] = own
    result["check"] = check
    return result


LOGIT_NUMBERS = ("logit_gap_max", "logit_err_max", "logit_err_rms", "logit_err_vs_fp8")


def compared(nums: dict, lim: dict, failed: int, page_table_errors: int) -> dict:
    """Each number beside its limit: the logit numbers that the cell's limits
    file names are compared, the others only reported."""
    check = {k: {"value": nums[k], "max": lim[k]} if k in lim else {"value": nums[k]}
             for k in LOGIT_NUMBERS if k in nums}
    check.update({
        "tokens_compared": {"value": nums["tokens_compared"], "min": lim["tokens_compared_min"]},
        "requests_failed": {"value": failed, "max": 0},
        "page_table_errors": {"value": page_table_errors, "max": 0},
    })
    return check


def passes(check: dict) -> bool:
    return all(("max" not in c or c["value"] <= c["max"]) and ("min" not in c or c["value"] >= c["min"])
               for c in check.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        driver.log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    cell = load_cell(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        driver.log(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} visible")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", control=bool(args.control))
    found = banned_modules()
    if found:
        driver.log(f"refused: the process holds {sorted(found)}")
        return 3
    driver.log(f"card: {card_line()}")
    for name, c in result["check"].items():
        bound = " ".join(f"{k} {v!r}" for k, v in c.items() if k != "value")
        driver.log(f"check {name} {c['value']!r} {bound}".rstrip())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

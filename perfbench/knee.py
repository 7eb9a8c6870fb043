"""The knee sweep of an open cell: serve it at each of several fixed rates
for a window, RUNS runs a rate on seeds of their own (each its own schedule
from the generator) and no reference check, and print a line a run:
the requests due, the TTFT and TPOT tails, the mean TTFT of the requests due
in the window's first and last thirds, and the waiting queue at 20 points of
the window. The knee is the highest rate at which the queue does not grow
through the window (the last third's TTFT no more than the first's, give
or take the run's noise); a cell's rate, in cells/<cell>.json, is 0.8 of it.

    python3 -m perfbench.knee --workload <open cell> --seconds 50 --rates 0.8 0.95 1.1
"""

from __future__ import annotations

import argparse
import gc
import json

import numpy as np
import torch

from perfbench import driver
from perfbench.manifest import load_cell
from perfbench.readers import percentile

RUNS = 2  # a rate's runs: one run's queue can grow or not by where its long prompts fall


def sweep_rate(cell, rate: float, seconds: float, seed: int) -> dict:
    run = driver.Run(cell, seed, seconds, False, "cuda", rate=rate)
    out = run.serve()
    t0, t1 = out["t0"], out["t1"]
    reqs = [r for r in run.reqs.values() if t0 <= r.due < t1]

    def queue(at):
        return sum(r.submitted <= at and (r.first is None or r.first > at) for r in run.reqs.values())

    ttft = [r.first - r.due for r in reqs if r.first is not None]
    third = (t1 - t0) / 3

    def mean_ttft(keep):
        x = [r.first - r.due for r in reqs if r.first is not None and keep(r)]
        return float(np.mean(x)) if x else None

    row = {"rate": rate, "seed": seed, "due": len(reqs), "unfinished": sum(r.finish is None for r in reqs),
           "ttft_p50_s": percentile(ttft, 50), "ttft_p90_s": percentile(ttft, 90),
           "tpot_p90_ms": percentile([1e3 * (r.finish - r.first) / (len(r.tokens) - 1) for r in reqs
                                      if r.finish is not None and len(r.tokens) > 1], 90),
           "ttft_mean_first_third_s": mean_ttft(lambda r: r.due < t0 + third),
           "ttft_mean_last_third_s": mean_ttft(lambda r: r.due >= t1 - third),
           "queue": [queue(t0 + f * (t1 - t0)) for f in np.linspace(0.05, 1.0, 20)]}
    run.release()
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 1000, help="the first run's seed; run i takes seed + i")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if cell.traffic["kind"] != "open":
        raise SystemExit(f"{args.workload} is not an open mix")
    for i, rate in enumerate(args.rates):
        for j in range(RUNS):
            print(json.dumps(sweep_rate(cell, rate, args.seconds, args.seed + i * RUNS + j)), flush=True)


if __name__ == "__main__":
    main()

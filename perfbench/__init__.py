"""The benchmark of million_tpu_torch, the PyTorch and CUDA port.

One command runs one cell of BENCHMARK.json once:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric is
a file of its own, found by name: configs/<config>.json, traffic/<mix>.json,
cells/<cell>.json (the limits of the correctness check) and
metrics/<metric>.py (one reader per metric). Only system.py imports the
port; reference/ is plain PyTorch and imports nothing of it.
"""

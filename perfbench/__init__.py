"""The benchmark of million_tpu_torch, the PyTorch and CUDA port.

One command runs one cell of BENCHMARK.json once:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell, metric or
architecture is a file of its own, found by name: configs/<config>.json
(which names its "architecture"), traffic/<mix>.json, cells/<cell>.json (the
limits of the correctness check), metrics/<metric>.py (one reader per
metric), reference/<architecture>.py (weights, the plain reference, the PQ
layers and the model's operation counts) and programs/<architecture>.py
(the port's model and cache configuration). Only system.py and programs/
import the port; reference/ is plain PyTorch and imports nothing of it.
"""

"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix, and a configuration file
names its architecture under "architecture"; `configs/<config>.json`,
`traffic/<mix>.json`, `cells/<cell>.json`, `metrics/<metric>.py`,
`reference/<architecture>.py` (the plain side: weights, reference, PQ
layers, operation counts) and `programs/<architecture>.py` (the port's
configuration of it) are looked up under the root given, then in the
benchmark's own folders (a test passes a temporary root), so a new cell,
mix, configuration, metric or architecture is a new file and a new entry,
never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str  # "end_to_end" or "per_layer"
    workloads: Optional[List[str]]
    read: Callable  # read(run) -> value or None


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    metrics: List[Metric]  # the cell's end-to-end metrics, then its per-layer ones
    plain: ModuleType  # reference/<architecture>.py
    program: ModuleType  # programs/<architecture>.py


def _load_json(name: str, kind: str, roots: Sequence[Path]) -> dict:
    for root in roots:
        path = root / "perfbench" / kind / f"{name}.json"
        if path.exists():
            return json.loads(path.read_text())
    raise FileNotFoundError(f"no perfbench/{kind}/{name}.json under {[str(r) for r in roots]}")


def load_module(kind: str, name: str, roots: Sequence[Path]) -> ModuleType:
    """perfbench/<kind>/<name>.py under the first root that has it, loaded
    from its file (a metric's name may hold dots, so it is no module path)."""
    for root in roots:
        path = root / "perfbench" / kind / f"{name}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no perfbench/{kind}/{name}.py under {[str(r) for r in roots]}")


def load_reader(name: str, roots: Sequence[Path]) -> Callable:
    """metrics/<name>.py's `read`."""
    return load_module("metrics", name, roots).read


def load_architecture(config: dict, where: str, roots: Sequence[Path]) -> tuple:
    """(reference/<architecture>.py, programs/<architecture>.py) of the
    architecture the configuration names; `where` names its file."""
    arch = config.get("architecture")
    if not isinstance(arch, str) or not NAME.fullmatch(arch):
        raise ValueError(f"{where} names no architecture: it needs \"architecture\": \"<name>\", the name "
                         f"of perfbench/reference/<name>.py and perfbench/programs/<name>.py (got {arch!r})")
    return load_module("reference", arch, roots), load_module("programs", arch, roots)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration, mix,
    limits, metric readers and architecture."""
    roots = [root] if root == ROOT else [root, ROOT]
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    plain, program = load_architecture(config, cfg_entry["file"], roots)
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if reports(m, name):
                metrics.append(Metric(m["name"], m["unit"], m["better"], m["source"], kind,
                                      m.get("workloads"), load_reader(m["name"], roots)))
    cell_file = _load_json(name, "cells", roots)
    # a cell's own traffic settings (its fixed rate) override the mix's
    mix = {**_load_json(w["traffic"], "traffic", roots), **cell_file.get("traffic", {})}
    return Cell(name, config, mix, cell_file, w["chips"], metrics, plain, program)


def metric_values(cell: Cell, run, kind: str) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the cell's metrics of this kind that
    their readers find; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in cell.metrics:
        if m.kind != kind:
            continue
        v = m.read(run)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out

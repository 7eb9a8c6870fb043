"""Append-only results ledger, the port's own (`results_torch.jsonl`; the
reference package writes `results.jsonl`): every run appends its scores
with its full configuration and a timestamp."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict

RESULTS = "results_torch.jsonl"


def append_result(path: str | Path, record: Dict[str, Any]) -> None:
    rec = {"ts": time.time(), **record}
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a") as f:
        f.write(json.dumps(rec, default=str) + "\n")


def read_results(path: str | Path):
    p = Path(path)
    if not p.exists():
        return []
    return [json.loads(line) for line in p.read_text().splitlines() if line.strip()]

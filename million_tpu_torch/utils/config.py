"""Layered JSON configuration.

Counterpart of million_tpu/utils/config.py, copied so that the port imports
nothing of the reference package; `python -m million_tpu_torch.cli` reads the
same configs/*.json. JSON files merge left-to-right, then `key=value`
overrides apply (dotted keys descend); the result is an immutable nested
namespace passed explicitly (unknown keys raise).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Iterable, Mapping


class Config(Mapping):
    """Read-only nested attribute/dict access over a merged config dict."""

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", dict(data))

    def __getattr__(self, name: str) -> Any:
        try:
            v = self._data[name]
        except KeyError:
            raise AttributeError(f"config has no key {name!r}") from None
        return Config(v) if isinstance(v, dict) else v

    def __setattr__(self, name, value):
        raise TypeError("Config is immutable")

    def __getitem__(self, k):
        return self._data[k]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def get(self, k, default=None):
        return self._data.get(k, default)

    def to_dict(self) -> Dict[str, Any]:
        return json.loads(json.dumps(self._data))

    def __repr__(self):
        return f"Config({self._data!r})"


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def load_config(
    files: Iterable[str] = (),
    overrides: Iterable[str] = (),
    base: Dict[str, Any] | None = None,
) -> Config:
    """Merge JSON files left-to-right over `base`, then apply `key=value`
    overrides (dotted keys descend: "pq.nbits=7")."""
    # a deep copy: an override must not write into the caller's nested dicts
    # (the reference's shallow copy lets `-o run.x=...` edit its DEFAULTS)
    merged: Dict[str, Any] = copy.deepcopy(dict(base or {}))
    for f in files:
        with open(f) as fh:
            merged = _deep_merge(merged, json.load(fh))
    for ov in overrides:
        key, _, val = ov.partition("=")
        parts = key.split(".")
        node = merged
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return Config(merged)

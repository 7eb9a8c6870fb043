"""The quality contract's byte-level LMs: their configurations, their text
and their pinned checkpoints.

Counterpart of million_tpu/benchmarks/tiny_lm.py without its training
(`train_tiny_lm`, `save_checkpoint`): the checkpoints under
artifacts/quality/ were trained by the reference package and load here
unchanged. A random-init model measures nothing about quantization (its
logits are near-uniform), so the quality ladder runs on these.

The text: `build_corpus` (this repository's docs and sources; the d=32
model's held-out tail) and `build_corpus_v2` (the host's Python library text,
the d=64 model's training corpus) as in the reference. Both depend on the
machine and the commit; `build_corpus_frozen` reads only files that stay
fixed across machines and commits, and none of it was in lm_l_v1's
training text.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Iterable, Tuple

import numpy as np
import torch

from million_tpu_torch.convert import params_from_numpy
from million_tpu_torch.models.llama import ModelConfig

REPO = Path(__file__).resolve().parents[2]

# d=32 per head -> M=16 subspaces at d_m=2: the fast regression-test model
QUALITY_CFG = ModelConfig(
    vocab_size=256,
    hidden_size=128,
    intermediate_size=384,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    dtype=torch.float32,
)

# The quality anchor: d=64 per head (M=32 at d_m=2), 6 layers, GQA 2:1,
# ~19M parameters, trained on the 48 MB corpus of build_corpus_v2
QUALITY_CFG_L = ModelConfig(
    vocab_size=256,
    hidden_size=512,
    intermediate_size=1536,
    num_layers=6,
    num_heads=8,
    num_kv_heads=4,
    head_dim=64,
    dtype=torch.float32,
)


def _stream(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, np.uint8).astype(np.int32)


def build_corpus(max_bytes: int = 4 << 20) -> np.ndarray:
    """Deterministic local text: this repository's docs and sources, as a
    byte stream (int32). The reference package's version also appends an
    outside source tree where the host has one; this one reads only the
    repository, so the two agree wherever that tree is absent."""
    roots: Iterable[Tuple[Path, str]] = [
        (REPO, "*.md"),
        (REPO / "docs", "*.md"),
        (REPO / "million_tpu", "**/*.py"),
        (REPO / "tests", "*.py"),
    ]
    parts = []
    total = 0
    for root, pat in roots:
        if not root.exists():
            continue
        for p in sorted(root.glob(pat)):
            try:
                b = p.read_bytes()
            except OSError:
                continue
            parts.append(b)
            total += len(b)
            if total >= max_bytes:
                break
        if total >= max_bytes:
            break
    blob = b"\n\n".join(parts)[:max_bytes]
    if len(blob) < (1 << 18):
        raise RuntimeError(f"corpus too small ({len(blob)} bytes)")
    return _stream(blob)


def build_corpus_v2(max_bytes: int = 48 << 20) -> np.ndarray:
    """The d=64 anchor's corpus: every .py / .pyi / .txt / .rst / .md under
    the running interpreter's site-packages and the system Python trees the
    reference package names, in a deterministic shuffled order, at most 256
    KB a file, mostly-binary files skipped. Exactly max_bytes bytes (or
    raises)."""
    roots = [
        os.path.join(sys.prefix, "lib", "python3.12", "site-packages"),
        "/usr/lib/python3.11",
        "/usr/lib/python3/dist-packages",
    ]
    exts = (".py", ".pyi", ".txt", ".rst", ".md")
    files = []
    for root in roots:
        if not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for f in sorted(filenames):
                if f.endswith(exts):
                    files.append(os.path.join(dirpath, f))
    rng = np.random.default_rng(0)
    order = rng.permutation(len(files))
    parts, total = [], 0
    per_file_cap = 256 << 10
    for i in order:
        try:
            b = Path(files[i]).read_bytes()[:per_file_cap]
        except OSError:
            continue
        if len(b) == 0 or sum(c > 127 for c in b[:4096]) > 512:
            continue
        parts.append(b)
        total += len(b) + 2
        if total >= max_bytes:
            break
    blob = b"\n\n".join(parts)[:max_bytes]
    if len(blob) < max_bytes:
        raise RuntimeError(f"corpus v2 too small ({len(blob)} bytes)")
    return _stream(blob)


def build_corpus_frozen() -> np.ndarray:
    """Held-out text that is the same on every machine and at every commit:
    million_tpu/**/*.py, then docs/*.md, each group in sorted order, joined
    by blank lines (~609 KB). The reference package and its docs are frozen
    by the port's rules, so this stream does not move between commits."""
    parts = []
    for root, pat in ((REPO / "million_tpu", "**/*.py"), (REPO / "docs", "*.md")):
        paths = sorted(root.glob(pat), key=lambda p: p.relative_to(REPO).as_posix())
        if not paths:
            raise FileNotFoundError(f"no {pat} under {root}")
        parts += [p.read_bytes() for p in paths]
    return _stream(b"\n\n".join(parts))


def checkpoint_path() -> Path:
    return REPO / "artifacts" / "quality" / "tiny_lm_v1.npz"


def checkpoint_path_l() -> Path:
    """The d=64 quality anchor's checkpoint (QUALITY_CFG_L)."""
    return REPO / "artifacts" / "quality" / "lm_l_v1.npz"


def load_checkpoint(path: Path | None = None, device="cuda"):
    """(params, cfg) of a pinned checkpoint, f32 on `device`. Its keys
    (`embed`, `layers/wq`, ...) are the port's stored layout and its
    `__meta__` the fields of ModelConfig."""
    z = np.load(path or checkpoint_path(), allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    meta["dtype"] = torch.float32
    cfg = ModelConfig(**meta)
    tree: dict = {}
    for key in z.files:
        if key == "__meta__":
            continue
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    return params_from_numpy(tree, torch.float32, device), cfg

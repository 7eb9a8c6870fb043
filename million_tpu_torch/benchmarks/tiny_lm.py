"""The quality contract's byte-level LMs: their configurations, their text,
their trainer and their pinned checkpoints.

Counterpart of million_tpu/benchmarks/tiny_lm.py. The checkpoints under
artifacts/quality/ were trained by the reference package and load here
unchanged; `train_tiny_lm` trains the same models in the port (autograd and
torch.optim.AdamW with optax's chain reproduced: global-norm clipping at 1.0
without an epsilon, AdamW with b1 0.9, b2 0.999, eps 1e-8 and weight decay
1e-4 on every leaf, a cosine schedule to 0.1 lr evaluated at step t for the
t-th update) on the reference's windows (the same np.random.default_rng
draws), and `save_checkpoint` writes the reference's layout, so that each
package loads the other's files. A random-init model measures nothing about
quantization (its logits are near-uniform), so the quality ladder runs on
these.

    python -m million_tpu_torch.benchmarks.tiny_lm [--model tiny|large] [--steps N] [--device cpu]

The text: `build_corpus` (this repository's docs and sources; the d=32
model's held-out tail) and `build_corpus_v2` (the host's Python library text,
the d=64 model's training corpus) as in the reference. Both depend on the
machine and the commit; `build_corpus_frozen` reads only files that stay
fixed across machines and commits, and none of it was in lm_l_v1's
training text.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from million_tpu_torch import resolve_device
from million_tpu_torch.convert import params_from_numpy
from million_tpu_torch.models.llama import ModelConfig, init_params, loss_fn

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


def cosine_lr(lr: float, steps: int, t: int, alpha: float = 0.1) -> float:
    """optax.cosine_decay_schedule(lr, steps, alpha) at step t."""
    frac = min(t, steps) / steps
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)


def _leaves(params):
    return [params[k] for k in sorted(params) if k != "layers"] + [
        params["layers"][k] for k in sorted(params["layers"])]


def clip_by_global_norm(grads, max_norm: float = 1.0) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g / norm * max_norm where the
    global norm reaches max_norm (no epsilon). Returns the norm."""
    norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def train_tiny_lm(
    tokens: np.ndarray,
    cfg: ModelConfig = QUALITY_CFG,
    *,
    steps: int = 2000,
    bs: int = 8,
    ctx: int = 256,
    lr: float = 3e-3,
    seed: int = 0,
    holdout: int = 1 << 16,
    log_every: int = 200,
    params: Optional[dict] = None,  # initial weights (None: init_params from `seed`)
    device="cuda",
    losses: Optional[list] = None,  # appended each step's loss (a host float), when given
):
    """AdamW + cosine training on random windows of tokens[:-holdout].
    Returns (params, final_train_loss_nats)."""
    dev = resolve_device(device)
    train_tokens = tokens[:-holdout]
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    rng = np.random.default_rng(seed)
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        starts = rng.integers(0, len(train_tokens) - ctx - 1, bs)
        ids = torch.from_numpy(np.stack([train_tokens[s:s + ctx] for s in starts]).astype(np.int64)).to(dev)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, cfg, ids)
        loss.backward()
        clip_by_global_norm([p.grad for p in leaves], 1.0)
        for group in opt.param_groups:
            group["lr"] = cosine_lr(lr, steps, i)
        opt.step()
        if losses is not None:
            losses.append(float(loss.detach()))
        if log_every and (i + 1) % log_every == 0:
            print(f"  step {i + 1}/{steps} loss {float(loss):.4f} nats "
                  f"({float(loss) / np.log(2):.3f} bits/byte)", flush=True)
    for p in leaves:
        p.requires_grad_(False)
    return params, float(loss.detach())


def save_checkpoint(params, cfg: ModelConfig, path: Path | None = None) -> None:
    """The reference's layout: `/`-joined keys (`embed`, `layers/wq`, ...),
    f32 leaves, and the ModelConfig fields as `__meta__` JSON."""
    path = Path(path or checkpoint_path())
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}
    for k, v in params.items():
        if k == "layers":
            flat.update({f"layers/{kk}": vv.detach().float().cpu().numpy() for kk, vv in v.items()})
        else:
            flat[k] = v.detach().float().cpu().numpy()
    meta = {f.name: (getattr(cfg, f.name) if f.name != "dtype" else "float32")
            for f in dataclasses.fields(cfg)}
    np.savez_compressed(path, __meta__=json.dumps(meta), **flat)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="train the quality LM")
    ap.add_argument("--model", choices=("tiny", "large"), default="tiny")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--bs", type=int, default=None)
    ap.add_argument("--ctx", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--holdout", type=int, default=None)
    ap.add_argument("--out", default=None, help="checkpoint path (default: the pinned one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model == "large":
        cfg, path, tokens = QUALITY_CFG_L, checkpoint_path_l(), build_corpus_v2()
        steps, bs, ctx = args.steps or 6000, args.bs or 16, args.ctx or 1024
        holdout, log_every = args.holdout or (2 << 20), 100
    else:
        cfg, path, tokens = QUALITY_CFG, checkpoint_path(), build_corpus()
        steps, bs, ctx = args.steps or 2000, args.bs or 8, args.ctx or 256
        holdout, log_every = args.holdout or (1 << 16), 200
    path = Path(args.out) if args.out else path
    print(f"corpus: {len(tokens)} bytes", flush=True)
    t0 = time.perf_counter()
    params, loss = train_tiny_lm(tokens, cfg, steps=steps, bs=bs, ctx=ctx, lr=args.lr,
                                 holdout=holdout, log_every=log_every, device=args.device)
    save_checkpoint(params, cfg, path)
    print(f"saved {path} (final loss {loss:.4f} nats, {time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()

"""Faiss-style .fvecs sample files.

Counterpart of million_tpu/utils/fvecs.py, copied so that the port imports
nothing of the reference package; the files are bit-compatible and the
reservoir draws the same numpy random numbers, so both packages pick the same
rows of the same file. Format: per vector, int32 dim followed by dim float32
values. The sampling stage of the pipeline (cli.py) persists KV head vectors
in it for offline codebook training.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_fvecs(path: str | Path, x: np.ndarray, append: bool = True) -> None:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim != 2:
        raise ValueError("expected (n, d)")
    n, d = x.shape
    rec = np.empty((n, d + 1), np.float32)
    rec[:, 0] = np.frombuffer(np.int32(d).tobytes() * n, np.float32).reshape(n)
    rec[:, 1:] = x
    mode = "ab" if append else "wb"
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, mode) as f:
        rec.tofile(f)


def read_fvecs(path: str | Path, max_n: int | None = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size == 0:
        return np.empty((0, 0), np.float32)
    d = raw[:1].view(np.int32)[0]
    rec = raw.reshape(-1, d + 1)
    out = rec[:, 1:]
    if max_n is not None:
        out = out[:max_n]
    return np.ascontiguousarray(out)


def read_fvecs_batched(path: str | Path, batch: int = 65536):
    """Stream an .fvecs file in (<= batch, d) chunks without loading it all
    (reference read_fvecs_batch, fvecio.py:61-90). Yields float32 arrays."""
    path = Path(path)
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype=np.int32, count=1)
        if head.size == 0:
            return
        d = int(head[0])
        f.seek(0)
        rec_floats = (d + 1) * batch
        while True:
            raw = np.fromfile(f, dtype=np.float32, count=rec_floats)
            if raw.size == 0:
                return
            if raw.size % (d + 1):
                raise ValueError(f"truncated fvecs record in {path}")
            yield np.ascontiguousarray(raw.reshape(-1, d + 1)[:, 1:])


def reservoir_sample_fvecs(
    path: str | Path, k: int, seed: int = 0, batch: int = 65536
) -> np.ndarray:
    """Uniform k-row sample of an arbitrarily large .fvecs file in ONE pass
    at O(k) memory (the reference's sample_fvecs role, fvecio.py:93-133,
    done as a classic batched reservoir instead of a two-pass count+read).
    Returns (min(k, n), d) float32."""
    rng = np.random.default_rng(seed)
    res = None
    seen = 0
    for chunk in read_fvecs_batched(path, batch):
        n = len(chunk)
        if res is None:
            res = np.empty((k, chunk.shape[1]), np.float32)
        take = min(k - seen, n) if seen < k else 0
        if take:
            res[seen : seen + take] = chunk[:take]
        # rows past the first k displace reservoir slots with probability
        # k / (index of the row in the whole stream)
        idx_global = seen + np.arange(take, n)
        accept = rng.random(n - take) < k / np.maximum(idx_global + 1, 1)
        hits = np.nonzero(accept)[0]
        if hits.size:
            slots = rng.integers(0, k, hits.size)
            res[slots] = chunk[take + hits]
        seen += n
    if res is None:
        return np.empty((0, 0), np.float32)
    return res[: min(k, seen)]


def partition_ranges(n: int, parts: int):
    """Near-equal contiguous index ranges covering [0, n) (reference
    partition_generator, fvecio.py:7-21). Yields (start, end) pairs."""
    if parts <= 0:
        raise ValueError("parts must be positive")
    base, extra = divmod(n, parts)
    s = 0
    for i in range(parts):
        e = s + base + (1 if i < extra else 0)
        yield (s, e)
        s = e

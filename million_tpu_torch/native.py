"""ctypes bindings for the native PQ library (csrc/pqlib.cpp): multithreaded
k-means++ codebook training and batch encoding on the host's cores.

Counterpart of million_tpu/native.py, with its own copy of the C++ source.
The library is built with g++ at first use into csrc/build/, under a name
that carries a hash of the source and the flags (as ops/cuda_build.py builds
the CUDA sources); nothing is built at import. Where no compiler is found the
functions raise: there is no fallback to another trainer.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from million_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, compile_into

SRC = CSRC / "pqlib.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LAYOUTS = {"contiguous": 0, "strided": 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpqlib-{digest}.so"


def load() -> ctypes.CDLL:
    """Build (once per source) and bind the library; raises without g++."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise RuntimeError("native pqlib unavailable: no g++ found")
                compile_into(out, [gxx, *GXX_FLAGS], SRC)
            lib = ctypes.CDLL(str(out))
            lib.pq_train.restype = ctypes.c_int
            lib.pq_train.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ]
            lib.pq_encode.restype = ctypes.c_int
            lib.pq_encode.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ]
            _lib = lib
        return _lib


def native_available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def train_pq_native(
    samples: np.ndarray,
    M: int,
    nbits: int = 8,
    iters: int = 25,
    seed: int = 0,
    layout: str = "contiguous",
) -> np.ndarray:
    """Codebook training on host threads, the contract of pq.kmeans.train_pq
    on numpy arrays: samples (n, d) -> cents (M, 2^nbits, d/M) f32."""
    lib = load()
    x = np.ascontiguousarray(samples, np.float32)
    n, d = x.shape
    C = 2**nbits
    out = np.empty((M, C, d // M), np.float32)
    rc = lib.pq_train(_f32p(x), n, d, M, C, iters, seed, _LAYOUTS[layout], _f32p(out))
    if rc != 0:
        raise ValueError(f"pq_train failed (rc={rc}); check n >= C and d % M == 0")
    return out


def encode_native(x: np.ndarray, cents: np.ndarray, layout: str = "contiguous") -> np.ndarray:
    """Nearest-centroid encode on host threads, the contract of
    pq.ops.pq_encode: x (..., d), cents (M, C <= 256, d_m) -> (..., M) uint8."""
    lib = load()
    xx = np.ascontiguousarray(x, np.float32)
    shape = xx.shape
    n = int(np.prod(shape[:-1]))
    cc = np.ascontiguousarray(cents, np.float32)
    M, C, _ = cc.shape
    out = np.empty((n, M), np.uint8)
    rc = lib.pq_encode(_f32p(xx.reshape(-1, shape[-1])), n, shape[-1], _f32p(cc), M, C,
                       _LAYOUTS[layout], out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"pq_encode failed (rc={rc})")
    return out.reshape(*shape[:-1], M)

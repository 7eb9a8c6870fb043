"""Build the package's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into
`million_tpu_torch/csrc/build/lib<name>-<hash>.so` (listed in .gitignore) the
first time a kernel of that file is launched, and loaded with ctypes. The
sources have a plain C interface and do not include PyTorch's headers, so a
build takes seconds. The hash covers the source, the headers beside it
(`csrc/*.cuh`, which a source may include) and the flags, so an edit of any
of them is rebuilt. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_s: float  # 0.0 when an earlier build of the same source was loaded
    log: str  # nvcc's output (ptxas register and shared-memory report)


_LOADED: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from million_tpu_torch/"
            "csrc at first use and need the CUDA toolkit"
        )
    return nvcc


def build(name: str) -> BuiltLibrary:
    """Compile csrc/<name>.cu (once per process and source) and load it.
    Raises if nvcc is missing or the build fails."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log, build_s = "", 0.0
    if not out.exists():
        t0 = time.perf_counter()
        log = compile_into(out, [find_nvcc(), *NVCC_FLAGS], src)
        build_s = time.perf_counter() - t0
    built = BuiltLibrary(ctypes.CDLL(str(out)), out, build_s, log)
    _LOADED[name] = built
    return built


def compile_into(out: Path, cmd, src: Path) -> str:
    """Run `cmd -o <temporary> src` and rename the result to `out`, so that
    concurrent builds of the same source never load a half-written library.
    Returns the compiler's output; raises if it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([*cmd, "-o", tmp, str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(cmd[0]).name} failed for {src.name}:\n{log}")
    os.replace(tmp, out)
    return log

"""The in-chunk causal kernel (csrc/causal_attention.cu, bf16 tensor-core
version) of this checkout against other sources of the same C interface, on
the same inputs and card, in turns: at the chunked path's shape (bs 4, 24 / 8
heads, a 4,096-token chunk, d 128) and at the serving admission's (6 slots x
512 tokens), q and k head slices of one tensor and v token-major, as the
model's projection lays them out.

    git archive <commit> million_tpu_torch/csrc | tar -x -C other/
    python3 -m million_tpu_torch.benchmarks.causal_kernel_ab \\
        --other other/million_tpu_torch/csrc/causal_attention.cu [more.cu ...]

The other sources (an earlier commit's, or knock-out builds of this one:
consumers that skip their products, a producer that copies nothing) are
built with the same nvcc flags into a temporary directory, each beside this
checkout's csrc headers; ptxas's remarks on wgmma serialisation are printed.
Each is held against the plain version over 64-key blocks and timed with
CUDA events, this checkout first, then the others, then back in reverse
order, --iters launches each. One line per shape: the times, TFLOP/s and the
bound, with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from million_tpu_torch.ops import causal_attention_kernel as C
from million_tpu_torch.ops import cuda_build

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
NH, NH_K, D = 24, 8, 128
SHAPES = {"chunk": (4, 4096), "admission": (6, 512)}  # name -> (sequences, chunk tokens)


def build_other(src: Path, out_dir: Path, i: int) -> ctypes.CDLL:
    out = out_dir / f"libother{i}_causal_attention.so"
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
                           str(out), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Performance" in line:
            print(f"[ptxas] {src}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    lib.causal_attention.restype = ctypes.c_int
    lib.causal_attention.argtypes = C._library().causal_attention.argtypes
    for name in ("causal_attention_smem", "causal_attention_key_tile", "causal_attention_q_block"):
        fn, ref = getattr(lib, name), getattr(C._library(), name)
        fn.restype, fn.argtypes = ref.restype, ref.argtypes
    return lib


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="+", required=True, help="other causal_attention.cu sources")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("causal_kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = {"this": C._library()}
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(args.other):
            libs[str(src)] = build_other(src, Path(tmp), i)
    this = C._lib
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        for shape, (bs, nc) in SHAPES.items():
            qk = torch.randn((bs, NH + NH_K, nc, D), generator=gen, device=dev).bfloat16()
            q, k = qk[:, :NH], qk[:, NH:]
            v = torch.randn((bs, nc, NH_K, D), generator=gen, device=dev).bfloat16().transpose(1, 2)
            want = C.causal_partial_plain(q, k, v, D**-0.5, block=C.KEY_TILE["bf16"])
            errs, times = {}, []
            for name, lib in libs.items():
                C._lib = lib
                got = C.causal_partial(q, k, v, D**-0.5)
                errs[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))
            for name in list(libs) + list(libs)[::-1]:
                C._lib = libs[name]
                times.append((name, cuda_ms(lambda: C.causal_partial(q, k, v, D**-0.5), args.iters)))
            ops = C.causal_ops(bs, NH, nc, D)
            bound = max(ops / BF16_OPS_PER_S, C.causal_bytes(bs, NH, NH_K, nc, D) / HBM_BYTES_PER_S) * 1e3
            print(f"[{shape}] bs={bs} nc={nc}: " + ", ".join(
                f"{n} {t:.4f} ms ({ops / t / 1e9:.1f} TFLOP/s)" for n, t in times)
                + f"; bound {bound:.4f} ms; max error against the plain version {errs}; {card}")
    finally:
        C._lib = this


if __name__ == "__main__":
    main()

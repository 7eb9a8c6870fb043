"""The chunk-history kernel (csrc/pq_chunk_attention.cu, bf16 tensor-core
version) of this checkout against another source of the same C interface, on
the same inputs and card, in turns: at the chunked path's shape (bs 4, 8 KV
heads, 12,288 rows each, 28,672 history tokens) and at the serving
admission's (6 slots, 8 KV heads, 1,536 rows each, 32,256 history tokens
gathered from shuffled pool pages, as admission gathers them).

    git archive <commit> million_tpu_torch/csrc | tar -x -C other/
    python3 -m million_tpu_torch.benchmarks.chunk_kernel_ab \\
        --other other/million_tpu_torch/csrc/pq_chunk_attention.cu

The other source is built with the same nvcc flags into a temporary
directory. Both are held against the plain version (bf16 rounding) and timed
with CUDA events in the order other, this, this, other, --iters launches
each. One line per shape and geometry: the four times, TFLOP/s, the bound
(operations at the bf16 tensor-core peak, or bytes), the largest error of
each against the plain version, and the card's name and power limit. Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from million_tpu_torch.models.paged_decode import _gather_history
from million_tpu_torch.ops import cuda_build
from million_tpu_torch.ops import pq_chunk_attention_kernel as K

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
GEOMETRIES = {"dm2": (64, 256, 0), "dm4_outlier": (32, 256, 16), "dm4_outlier_c128": (32, 128, 16)}
NH_K, G, D = 8, 3, 128
PAGE, POOL_PAGES = 2048, 104
SHAPES = {  # name -> (sequences, chunk positions, history tokens, arena tokens)
    "chunk": (4, 4096, 28672, 32768),
    "admission": (6, 512, 32256, 32768),
}


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.pq_chunk_attention.restype = ctypes.c_int
    lib.pq_chunk_attention.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    return lib


def build_other(src: Path, out_dir: Path) -> ctypes.CDLL:
    out = out_dir / "libother_pq_chunk_attention.so"
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return load(out)


def inputs(shape: str, geom: str, gen: torch.Generator, dev: torch.device):
    """Pre-scaled query rows, code arenas, f32 codebooks and exact channels."""
    bs, nc, n_prev, N = SHAPES[shape]
    M, C, O = GEOMETRIES[geom]
    q = K.group_rows(torch.randn((bs, NH_K * G, nc, D), generator=gen, device=dev), NH_K, D**-0.5)

    def arena(X, dtype=torch.uint8):
        if shape == "chunk":
            s = (bs, NH_K, N, X)
        else:  # admission: the slots' history pages of a pool, in shuffled order
            s = (1, POOL_PAGES + 1, NH_K, PAGE, X)
        t = (torch.randint(0, C, s, generator=gen, device=dev, dtype=dtype) if dtype == torch.uint8
             else torch.randn(s, generator=gen, device=dev).to(dtype))
        if shape == "chunk":
            return t
        pages = torch.randperm(POOL_PAGES, generator=torch.Generator().manual_seed(13))[: bs * (N // PAGE)]
        return _gather_history(t, 0, pages.reshape(bs, N // PAGE).to(dev))

    kcent = torch.randn((M, C, D // M), generator=gen, device=dev)
    vcent = torch.randn((M, C, D // M), generator=gen, device=dev)
    kw = {}
    if O:
        koidx = torch.randperm(D, generator=gen, device=dev)[:O].sort().values.int()
        voidx = torch.randperm(D, generator=gen, device=dev)[:O].sort().values.int()
        for cent, idx in ((kcent, koidx), (vcent, voidx)):
            for c in idx.tolist():
                cent[c % M, :, c // M] = 0.0
        kw = dict(koidx=koidx, voidx=voidx, k_outliers=arena(O, torch.bfloat16),
                  v_outliers=arena(O, torch.bfloat16))
    return q.contiguous(), arena(M), arena(M), kcent, vcent, n_prev, kw


def launch(lib, q, kc, vc, kcent, vcent, n_prev, kw):
    bs, nh_k, QR, d = q.shape
    out = torch.empty((bs, nh_k, QR, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((bs, nh_k, QR), dtype=torch.float32, device=q.device)
    ptr = {k: v.data_ptr() for k, v in kw.items()}
    O_k = kw["k_outliers"].shape[-1] if kw else 0
    err = lib.pq_chunk_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), kcent.data_ptr(), vcent.data_ptr(),
        ptr.get("k_outliers"), ptr.get("v_outliers"), ptr.get("koidx"), ptr.get("voidx"),
        out.data_ptr(), lse.data_ptr(), bs, nh_k, QR, d, kc.shape[3], kcent.shape[1], vc.shape[3],
        vcent.shape[1], O_k, O_k, kc.shape[2], n_prev, 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pq_chunk_attention launch failed: CUDA error {err}")
    return out, lse


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="another pq_chunk_attention.cu")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--shapes", default="chunk,admission")
    ap.add_argument("--geometries", default=",".join(GEOMETRIES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chunk_kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build_other(args.other, Path(tmp)),
                "this": load(cuda_build.build("pq_chunk_attention").path)}
        gen = torch.Generator(device=dev).manual_seed(0)
        for shape in args.shapes.split(","):
            for geom in args.geometries.split(","):
                x = inputs(shape, geom, gen, dev)
                q, kc, vc, kcent, vcent, n_prev, kw = x
                want = K.pq_chunk_attention_plain(q, kc, vc, kcent, vcent, n_prev, precision="bf16", **kw)
                errs = {}
                for name, lib in libs.items():
                    got = launch(lib, *x)
                    torch.cuda.synchronize()
                    errs[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))
                del want
                times = [(name, cuda_ms(lambda: launch(libs[name], *x), args.iters))
                         for name in ("other", "this", "this", "other")]
                bs, nh_k, QR, d = q.shape
                M, C, O = GEOMETRIES[geom]
                ops = K.chunk_ops(bs, nh_k, QR, d, n_prev, O)
                nbytes = K.chunk_bytes(bs, nh_k, QR, d, n_prev, M, M, O, O) + 2 * C * d * 4
                t_ops, t_bytes = ops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
                print(f"[ab] {shape} {geom}: bs={bs} rows={QR} n_prev={n_prev} "
                      + " ".join(f"{n}={t:.3f} ms ({ops / t / 1e9:.1f} TFLOP/s)" for n, t in times)
                      + f" bound={max(t_ops, t_bytes):.3f} ms "
                      f"({'operations' if t_ops >= t_bytes else 'bytes'}) max err vs plain: "
                      f"other {errs['other']:.3g} this {errs['this']:.3g}; card {card}", flush=True)
                del x, q, kc, vc, kw
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

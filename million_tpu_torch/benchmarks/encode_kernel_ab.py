"""The fused PQ encode kernel (csrc/pq_encode.cu, B7) of this checkout against
other copies of it and against knock-out builds, on the same inputs and card,
in turns, at the four shapes the paths give it (llama-3.2-3b: 8 KV heads,
d = 128, bf16, "fast", the strided subspace split), in dm2 (M 64, C 256) and
dm4_outlier_c128 (M 32, C 128):

- prefill: 4 x 8 x 32,000 rows, the (bs, heads, n, d) view of a (bs, n,
  heads, d) projection (the flat path's prefill);
- chunk: 4 x 8 x 4096 rows, the same view (a chunk of the chunked prefill);
- admission: 6 x 8 x 512 rows, the same view (a chunk of the serving
  admission, models/paged_decode.py);
- flush: 28 banks of 4 x 8 x 16 rows, the oldest rows of every layer's
  residual window (one launch for all layers).

    git archive <commit> million_tpu_torch/csrc/pq_encode.cu | tar -x -C other/
    python3 -m million_tpu_torch.benchmarks.encode_kernel_ab \\
        --other other/million_tpu_torch/csrc/pq_encode.cu --knockouts

An other copy is a pq_encode.cu with the same C interface (or a directory
holding one). --knockouts writes copies of this checkout's source, each with
one edit (KNOCKOUTS): the x staging reads one row per tile (no per-row index
arithmetic, and one row's bytes), the scan keeps the max only (no compare
and select per tile; codes are wrong), no locate step, no codebook staging
(the shared buffers hold what they held), no code store, and the 256-row tile
alone (no 128-row tiles), no x staging, and the scan with (or without) the
locate step alone. Every copy is built with the same nvcc flags, its
codes held against the plain version (agreement) and against this
checkout's (equal codes; a knock-out's numbers say only that it ran), and
timed with CUDA events, this checkout first, then the others, then back in
reverse order. One line per shape and geometry: the times, the bound
(operations at 989 TFLOP/s, the bf16 tensor-core peak: a "fast" encode's
products are of bf16 operands, exact in its f32 sums; or bytes at 3.35 TB/s)
and the agreements, with the card's name and power limit. Needs a CUDA device.

    python3 -m million_tpu_torch.benchmarks.encode_kernel_ab --generic

instead times this checkout's two kernels for widths outside the tiled set
against each other at C = 256 (GENERIC_DM): the generic kernel, which holds
a subspace's whole codebook in shared memory and writes uint8 codes, and the
wide build's generic kernel, which streams the codebook and writes int16, on
the prefill shape's rows, in turns, each held against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from million_tpu_torch.benchmarks.causal_kernel_ab import cuda_ms
from million_tpu_torch.ops import cuda_build
from million_tpu_torch.ops import pq_encode_kernel as E

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# a "fast" encode's products are of bf16 operands (exact in its f32 sums): the bf16 tensor-core peak
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
GEOMETRIES = {"dm2": (64, 256), "dm4_outlier_c128": (32, 128)}  # M, C
NH_K, D, LAYERS = 8, 128, 28
SHAPES = {  # name -> (banks, sequences, tokens per sequence), the (bs, heads, n, d) view
    "prefill": (1, 4, 32000),
    "chunk": (1, 4, 4096),
    "admission": (1, 6, 512),
    "flush": (LAYERS, 4, 16),
}
ITERS = {"prefill": 20, "chunk": 100, "admission": 200, "flush": 200}
GENERIC_DM, GENERIC_C = (32, 64, 128), 256
SOURCE = "pq_encode.cu"

# name -> [(old text, new text)]; each old text must occur in the source
KNOCKOUTS = {
    "staging_one_row": [("const long off = row_offset(p, s, (unsigned)r) + dim;",
                         "const long off = row_offset(p, s, (unsigned)row0) + dim;")],
    "max_only": [("bt[t] = sc[0] > best[t] ? ti : bt[t];", "")],
    "no_locate": [("idx = a == best[t] ? k : idx;", "")],
    "no_codebook_staging": [("stage_codebooks<DM>(p, s, m0, mg, cs);", ""),
                            ("half_norms<DM>(p, mg, cs);", "")],
    "no_code_store": [("if (r < p.R) copy_codes<MG>(out + r * p.M + m0, code_s + t * MG);", "(void)r;")],
    "tile_256_only": [("if (small.cost < SMALL_TILE_GAIN * big.cost)", "if (false)")],
}
NO_X = [("if (p.x_bf16) stage_x_vec<DM, TB, true>(p, s, m0, row0, xs);", ""),
        ("else stage_x_vec<DM, TB, false>(p, s, m0, row0, xs);", "")]
KNOCKOUTS["no_x_staging"] = NO_X  # the scan reads the x tile the shared memory holds
KNOCKOUTS["scan_and_locate_only"] = (NO_X + KNOCKOUTS["no_codebook_staging"]
                                     + KNOCKOUTS["no_code_store"])
KNOCKOUTS["scan_only"] = KNOCKOUTS["scan_and_locate_only"] + KNOCKOUTS["no_locate"]


def write_knockout(name: str, out_dir: Path) -> Path:
    """This checkout's source with the edits of KNOCKOUTS[name], as out_dir/name.cu."""
    text = (cuda_build.CSRC / SOURCE).read_text()
    for old, new in KNOCKOUTS[name]:
        if old not in text:
            raise RuntimeError(f"knock-out {name}: {old!r} is not in {SOURCE}")
        text = text.replace(old, new)
    out = out_dir / f"{name}.cu"
    out.write_text(text)
    return out


def build_copy(src: Path, out_dir: Path, tag: str) -> ctypes.CDLL:
    if src.is_dir():
        src = src / SOURCE
    out = out_dir / f"lib{tag}_pq_encode.so"
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    usage = [ln.split(":", 1)[1].strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln]
    print(f"[build] {src.name}: ptxas {' | '.join(usage)}", flush=True)
    lib = ctypes.CDLL(str(out))
    ref = E._library()
    lib.pq_encode.restype, lib.pq_encode.argtypes = ref.pq_encode.restype, ref.pq_encode.argtypes
    lib.pq_encode_tile.restype = ctypes.c_int
    return lib


def make_cases(dev, gen):
    """(shape, geometry) -> (x, cents, rows)."""
    cases = {}
    for geom, (M, C) in GEOMETRIES.items():
        cents = torch.randn((LAYERS, M, C, D // M), generator=gen, device=dev)
        for shape, (S, bs, n) in SHAPES.items():
            if S == 1:
                x = torch.randn((bs, n, NH_K, D), generator=gen, device=dev).bfloat16().transpose(1, 2)[None]
            else:  # the first n rows of a 128-row window per layer
                x = torch.randn((S, bs, NH_K, 128, D), generator=gen, device=dev).bfloat16()[:, :, :, :n]
            cases[(shape, geom)] = (x, cents[:S].contiguous(), S * bs * NH_K * n)
    return cases


def generic_ab(dev, card, iters: int) -> None:
    """--generic: pq_encode's generic kernel against pq_encode_wide's at C =
    GENERIC_C, d_m in GENERIC_DM, on the prefill shape's rows (contiguous,
    bf16, "fast", strided split), in turns."""
    lib = E._library()
    gen = torch.Generator(device=dev).manual_seed(0)
    _, bs, n = SHAPES["prefill"]
    rows = bs * n * NH_K
    x = torch.randn((1, rows, D), generator=gen, device=dev).bfloat16()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for dm in GENERIC_DM:
        M = D // dm
        cents = torch.randn((1, M, GENERIC_C, dm), generator=gen, device=dev)
        narrow = torch.empty((1, rows, M), dtype=torch.uint8, device=dev)
        wide = torch.empty((1, rows, M), dtype=torch.int16, device=dev)
        scratch = torch.empty(lib.pq_encode_wide_scratch(M, GENERIC_C, dm), dtype=torch.float32, device=dev)
        common = (1, 1, 1, rows, rows * D, 0, 0, D, M, GENERIC_C, dm, 1, 1, 1)

        def run_narrow():
            err = lib.pq_encode(x.data_ptr(), cents.data_ptr(), narrow.data_ptr(), *common, 1, stream)
            if err:
                raise RuntimeError(f"pq_encode (generic) failed: CUDA error {err}")

        def run_wide():
            err = lib.pq_encode_wide(x.data_ptr(), cents.data_ptr(), wide.data_ptr(), scratch.data_ptr(), *common,
                                     stream)
            if err:
                raise RuntimeError(f"pq_encode_wide failed: CUDA error {err}")

        run_narrow()
        run_wide()
        want = E.pq_encode_fused_plain(x, cents, "strided", "fast").long()
        agree = {"generic": float((narrow.long() == want).float().mean()),
                 "wide_generic": float((wide.long() == want).float().mean())}
        times = [(name, cuda_ms(fn, iters)) for name, fn in
                 (("generic", run_narrow), ("wide_generic", run_wide), ("wide_generic", run_wide),
                  ("generic", run_narrow))]
        nbytes, ops = E.encode_bytes(rows, D, M, 2), E.encode_ops(rows, M, GENERIC_C, dm)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        print(f"[generic d_m={dm} M={M} C={GENERIC_C}] {rows} rows: "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in times)
              + f"; bound {max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})"
              + "; agreement with the plain version " + ", ".join(f"{n} {a:.6f}" for n, a in agree.items())
              + f"; {card}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[], help="other pq_encode.cu copies")
    ap.add_argument("--knockouts", action="store_true", help="also time this checkout's knock-out builds")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--iters-scale", type=float, default=1.0)
    ap.add_argument("--generic", action="store_true",
                    help="time the generic kernel against the wide build's at C = 256 instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("encode_kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    this = E._library()
    usage = [ln.split(":", 1)[1].strip() for ln in cuda_build.build("pq_encode").log.splitlines()
             if "registers" in ln]
    print(f"[build] this checkout: ptxas {' | '.join(usage) or 'cached'}", flush=True)
    if args.generic:
        generic_ab(dev, card, max(2, int(ITERS["prefill"] * args.iters_scale)))
        return
    copies = {"this": this}
    with tempfile.TemporaryDirectory() as tmp:
        srcs = {str(p): p for p in args.other}
        if args.knockouts:
            srcs.update({name: write_knockout(name, Path(tmp)) for name in KNOCKOUTS})
        with ThreadPoolExecutor(max_workers=8) as pool:
            built = pool.map(lambda kv: build_copy(kv[1], Path(tmp), f"c{kv[0]}"), enumerate(srcs.values()))
            copies.update(zip(srcs, built))
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        for (shape, geom), (x, cents, rows) in make_cases(dev, gen).items():
            if shape not in args.shapes:
                continue
            M, C = GEOMETRIES[geom]

            def kern():
                return E.pq_encode_fused_stacked(x, cents, "strided", "fast")

            want = E.pq_encode_fused_plain(x, cents, "strided", "fast")
            got = {}
            for name, lib in copies.items():
                E._lib = lib
                got[name] = kern()
            torch.cuda.synchronize()
            agree = {n: float((g == want).float().mean()) for n, g in got.items()}
            same = {n: bool((g == got["this"]).all()) for n, g in got.items() if n != "this"}
            iters = max(2, int(ITERS[shape] * args.iters_scale))
            times = []
            for name in list(copies) + list(copies)[::-1]:
                E._lib = copies[name]
                times.append((name, cuda_ms(kern, iters)))
            nbytes, ops = E.encode_bytes(rows, D, M, 2), E.encode_ops(rows, M, C, D // M)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
            print(f"[{shape} {geom}] {rows} rows: " + ", ".join(f"{n} {t:.4f} ms" for n, t in times)
                  + f"; bound {max(t_bytes, t_ops):.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})"
                  + "; agreement with the plain version " + ", ".join(f"{n} {a:.6f}" for n, a in agree.items())
                  + "; codes equal to this checkout's " + ", ".join(f"{n} {s}" for n, s in same.items())
                  + f"; {card}", flush=True)
            del got, want
    finally:
        E._lib = this


if __name__ == "__main__":
    main()

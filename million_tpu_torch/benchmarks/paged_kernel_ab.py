"""The PQ decode-attention passes (csrc/pq_attention_passes.cuh: the score,
value and reduce kernels behind B4, pq_paged_attention, and B1,
pq_decode_attention) of this checkout against other copies of them, on the
same inputs and card, in turns: B4 at the serving tick's shape (6 slots x
32,640 codes in 2048-token pages, shuffled tables, S = 8 splits from the
planner, a bf16 residual window with 97 live rows) and B1 at the flat decode
step's (bs 4, 32,256 codes of a 32K arena, the same window), in dm2,
dm4_outlier_c128 and dm16 (M = 8, the wide builds; llama-3.2-3b: 8 KV heads,
G = 3, d = 128); and B4 alone at the benchmark cell mistral-7b.decode-32k's
shape (`dm2_cell`: 16 slots x 33,280 codes, 18 pages of 2048 a slot, G = 4, S
= 1 from the planner).

    git archive <commit> million_tpu_torch/csrc | tar -x -C other/
    python3 -m million_tpu_torch.benchmarks.paged_kernel_ab --other other/million_tpu_torch/csrc
    python3 -m million_tpu_torch.benchmarks.paged_kernel_ab --knockouts

An other copy is a directory holding pq_attention_passes.cuh,
pq_paged_attention.cu and pq_decode_attention.cu, whose C calls take this
checkout's arguments (give an older copy's signature the missing ones
first); --geometries leaves out the ones it does not compute. --knockouts writes
knock-out copies of this checkout's sources into a temporary directory, each
one edit of the passes (KNOCKOUTS: a pass alone, a pass with its codebook
gather replaced by a value computed in registers, a pass with its codebook
read through L1 instead of staged in shared memory, the score pass's lane
build with its reduce-scatter's shuffles replaced by a lane's own adds), to
split the time among the passes and their parts. Every copy is built with
the same nvcc flags, held against the plain versions (a knock-out's error
says only that it ran) and timed with CUDA events, this checkout first, then
the others, then back in reverse order, --iters launches each. One line per
kernel, shape and geometry: the times, the bound (bytes at 3.35 TB/s) and
the errors, with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from million_tpu_torch.benchmarks.causal_kernel_ab import cuda_ms
from million_tpu_torch.ops import cuda_build
from million_tpu_torch.ops import pq_attention_kernel as K
from million_tpu_torch.ops import pq_paged_attention_kernel as P

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# M, C, exact channels a side; dm16 (M = 8) runs the passes' wide builds
GEOMETRIES = {"dm2": (64, 256, 0), "dm4_outlier_c128": (32, 128, 16), "dm16": (8, 256, 0),
              "dm2_cell": (64, 256, 0)}
NH_K, G, D, LT, LIVE_ROWS = 8, 3, 128, 128, 97
SLOTS, SEQ, PAGE, PAGES_PER_SEQ, POOL_PAGES = 6, 32640, 2048, 17, 104  # the serving tick
# the cell mistral-7b.decode-32k: 16 slots a little into their decode, Mistral-7B's G = 4;
# the geometry named here runs B4 only, at this shape
CELL = dict(slots=16, seq=33280, pages_per_seq=18, pool_pages=288, G=4)
FLAT_BS, FLAT_N_MAX, FLAT_CODES = 4, 32768, 32256  # the flat decode step
SOURCES = ("pq_attention_passes.cuh", "pq_paged_attention.cu", "pq_decode_attention.cu")
VALUE_PASS = "// Pass 2:"  # where the value pass begins in pq_attention_passes.cuh

# name -> edits (old text, new text, the part of the header they apply to: "score" before
# the value pass, "value" from it on, "all")
KNOCKOUTS = {
    "score_pass_alone": [
        ("return launch_value<G, PAGED>(pv, bs, smem_v, st);",
         "(void)smem_v; return cudaSuccess;", "all"),
        ("  e = res_bf16 ? launch_reduce<", "  if (0) e = res_bf16 ? launch_reduce<", "all")],
    "value_pass_alone": [
        ("cudaError_t e = launch_score<G, PAGED>(ps, bs, smem_s, st);",
         "cudaError_t e = cudaSuccess; (void)smem_s;", "all"),
        ("  e = res_bf16 ? launch_reduce<", "  if (0) e = res_bf16 ? launch_reduce<", "all")],
    "reduce_alone": [
        ("cudaError_t e = launch_score<G, PAGED>(ps, bs, smem_s, st);",
         "cudaError_t e = cudaSuccess; (void)smem_s;", "all"),
        ("return launch_value<G, PAGED>(pv, bs, smem_v, st);",
         "(void)smem_v; return cudaSuccess;", "all")],
    "score_gather_in_registers": [
        ("load_cent<W>(v[rr][k], cent);",
         "for (int w = 0; w < W; ++w) v[rr][k][w] = (cent - kc) * 1e-6f + w * 1e-3f;",
         "score")],
    "score_reduce_without_shuffles": [
        ("+= __shfl_xor_sync(0xffffffffu, acc[(r + O) / GP][(r + O) % GP], O);",
         "+= acc[(r + O) / GP][(r + O) % GP] * 0.5f;", "score")],
    "value_gather_in_registers": [
        ("*reinterpret_cast<const float2*>(cent)", "make_float2((cent - vcol) * 1e-6f, 1e-3f)", "value"),
        ("*reinterpret_cast<const float4*>(cent)", "make_float4((cent - vcol) * 1e-6f, 1e-3f, 2e-3f, 3e-3f)",
         "value")],
    "score_codebook_through_l1": [
        ("const size_t smem_s = with_cent(ps, need_s, sizeof(float) * (size_t)p.Ck * d, optin);",
         "ps.cent_in_smem = 0; const size_t smem_s = need_s;", "all")],
    "value_codebook_through_l1": [
        ("pv.cent_in_smem = head + std::max(cent_v + tiles, slab) <= (size_t)optin;",
         "pv.cent_in_smem = 0;", "all")],
}


def write_knockout(name: str, out_dir: Path) -> Path:
    """This checkout's sources with the edits of KNOCKOUTS[name] made in
    out_dir / name; each edit's text must occur in its part."""
    d = out_dir / name
    d.mkdir(parents=True)
    for f in SOURCES[1:]:
        shutil.copy(cuda_build.CSRC / f, d / f)
    text = (cuda_build.CSRC / SOURCES[0]).read_text()
    cut = text.index(VALUE_PASS)
    parts = {"score": text[:cut], "value": text[cut:]}
    for old, new, part in KNOCKOUTS[name]:
        if part == "all":
            if old not in parts["score"] + parts["value"]:
                raise RuntimeError(f"knock-out {name}: {old!r} is not in {SOURCES[0]}")
            parts = {k: v.replace(old, new) for k, v in parts.items()}
        else:
            if old not in parts[part]:
                raise RuntimeError(f"knock-out {name}: {old!r} is not in the {part} part of {SOURCES[0]}")
            parts[part] = parts[part].replace(old, new)
    (d / SOURCES[0]).write_text(parts["score"] + parts["value"])
    return d


def build_copy(src_dir: Path, out_dir: Path, tag: str):
    """(paged library, flat library) built from the copy in src_dir."""
    libs = []
    for stem, ref in (("pq_paged_attention", P._library()), ("pq_decode_attention", K._library())):
        out = out_dir / f"lib{tag}_{stem}.so"
        proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                               str(src_dir / f"{stem}.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src_dir / stem}.cu:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(str(out))
        fn, ref_fn = getattr(lib, stem), getattr(ref, stem)
        fn.restype, fn.argtypes = ref_fn.restype, ref_fn.argtypes
        libs.append(lib)
    return tuple(libs)


def make_cases(dev, gen, geometries):
    """name -> (kernel call, plain call, bytes), per geometry, for B4 and B1
    (B4 alone at the cell's shape)."""
    cases = {}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for geom in geometries:
        M, C, O = GEOMETRIES[geom]
        cell = geom == "dm2_cell"
        slots, seq, pps, pool_pages, g = ((CELL["slots"], CELL["seq"], CELL["pages_per_seq"], CELL["pool_pages"],
                                          CELL["G"]) if cell else (SLOTS, SEQ, PAGES_PER_SEQ, POOL_PAGES, G))
        perm = torch.randperm(pool_pages, generator=torch.Generator().manual_seed(10))[: slots * pps]
        table = perm.reshape(slots, pps).to(torch.int32).to(dev)
        lens = torch.full((slots,), seq, dtype=torch.int32, device=dev)
        rows = torch.full((slots,), LIVE_ROWS, dtype=torch.int32, device=dev)
        cents = [torch.randn((1, M, C, D // M), generator=gen, device=dev) for _ in range(2)]
        oidx = [torch.randperm(D, generator=torch.Generator().manual_seed(s))[:O].sort().values.to(torch.int32)
                for s in (1, 2)]
        for c, idx in zip(cents, oidx):  # exact channels have zero centroid components
            for ch in idx.tolist():
                c[0, ch % M, :, ch // M] = 0.0
        res = [torch.randn((1, slots, NH_K, LT, D), generator=gen, device=dev).bfloat16() for _ in range(2)]
        q = torch.randn((slots, NH_K, g, D), generator=gen, device=dev) / D**0.5
        pools = [torch.randint(0, C, (1, pool_pages + 1, NH_K, PAGE, M), generator=gen, device=dev,
                               dtype=torch.uint8) for _ in range(2)]
        okw = dict(k_residual=res[0], v_residual=res[1], r=rows)
        if O:
            okw.update(k_outliers=torch.randn((1, pool_pages + 1, NH_K, PAGE, O), generator=gen,
                                              device=dev).bfloat16(),
                       v_outliers=torch.randn((1, pool_pages + 1, NH_K, PAGE, O), generator=gen,
                                              device=dev).bfloat16(),
                       k_oidx=oidx[0][None].to(dev), v_oidx=oidx[1][None].to(dev))
        args = (q, pools[0], pools[1], cents[0], cents[1], 0, table, lens)
        n_bound = -(-seq // PAGE) * PAGE
        cases[("B4", geom)] = (
            lambda a=args, k=okw, nb=n_bound: P.pq_paged_attention_stacked(*a, n_bound=nb, **k),
            lambda a=args, k=okw, nb=n_bound: P.pq_paged_attention_plain(*a, n_bound=nb, n_sm=n_sm, **k),
            P.paged_bytes([seq] * slots, NH_K, M, M, O, O))
        if cell:
            continue
        qf = q[:FLAT_BS].contiguous()
        arena = [torch.randint(0, C, (1, FLAT_BS, NH_K, FLAT_N_MAX, M), generator=gen, device=dev,
                               dtype=torch.uint8) for _ in range(2)]
        fkw = dict(k_residual=res[0][:, :FLAT_BS].contiguous(), v_residual=res[1][:, :FLAT_BS].contiguous(),
                   r=LIVE_ROWS)
        if O:
            fkw.update(k_outliers=torch.randn((1, FLAT_BS, NH_K, FLAT_N_MAX, O), generator=gen,
                                              device=dev).bfloat16(),
                       v_outliers=torch.randn((1, FLAT_BS, NH_K, FLAT_N_MAX, O), generator=gen,
                                              device=dev).bfloat16(),
                       k_oidx=okw["k_oidx"], v_oidx=okw["v_oidx"])
        fargs = (qf, arena[0], arena[1], cents[0], cents[1], 0, FLAT_CODES)
        cases[("B1", geom)] = (
            lambda a=fargs, k=fkw: K.pq_codes_attention_stacked(*a, **k),
            lambda a=fargs, k=fkw: K.pq_codes_attention_plain(*a, n_sm=n_sm, **k),
            K.decode_bytes(FLAT_BS, NH_K, FLAT_CODES, M, M, O, O))
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="*", default=[], help="directories holding other copies")
    ap.add_argument("--knockouts", action="store_true", help="also time this checkout's knock-out builds")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--geometries", default=",".join(GEOMETRIES), help="comma-separated, of " + ", ".join(GEOMETRIES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("paged_kernel_ab needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    copies = {"this": (P._library(), K._library())}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {str(d): d for d in args.other}
        if args.knockouts:
            dirs.update({name: write_knockout(name, Path(tmp) / "src") for name in KNOCKOUTS})
        with ThreadPoolExecutor(max_workers=8) as pool:
            built = pool.map(lambda kv: build_copy(kv[1], Path(tmp), f"c{kv[0]}"), enumerate(dirs.values()))
            copies.update(zip(dirs, built))
    this = (P._lib, K._lib)
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        for (kernel, geom), (kern, plain, nbytes) in make_cases(dev, gen, args.geometries.split(",")).items():
            want = plain()
            errs, times = {}, []
            for name, (plib, flib) in copies.items():
                P._lib, K._lib = plib, flib
                got = kern()
                torch.cuda.synchronize()
                errs[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))
            for name in list(copies) + list(copies)[::-1]:
                P._lib, K._lib = copies[name]
                times.append((name, cuda_ms(kern, args.iters)))
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"[{kernel} {geom}] " + ", ".join(f"{n} {t:.4f} ms" for n, t in times)
                  + f"; bound {bound:.4f} ms (bytes); max error against the plain version "
                  + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()) + f"; {card}", flush=True)
    finally:
        P._lib, K._lib = this


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of million_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # the whole run
    python3 chip_smoke.py --kernels-only  # phases 1-3 and the odd exact channels, no result line

Phases, each printed as it ends; any failure exits non-zero and prints no
result line:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the five CUDA sources of million_tpu_torch/csrc with nvcc,
     one nvcc each, started together;
  3. every kernel against its plain PyTorch version on the card at the main
     paths' shapes (llama-3.2-3b: G=3, d=128, 8 KV heads, batch 4), with its
     time, its bound and the plain version's time:
     - pq_decode_attention over a 32K arena holding 32768-512 codes, a bf16
       residual window with 97 live rows merged in, in the three geometries
       and through the single-layer entry; dense bf16 SDPA over the same
       length is printed as a yardstick;
     - pq_encode at the prefill shape (1.024 M rows, "fast"), at the chunked
       path's shapes (a 4096-token chunk and the last one of 3,328) and at
       the flush shape (28 banks of 4 x 8 x 16 rows) in dm2 and
       dm4_outlier_c128, and on integer-valued inputs; the torch
       baddbmm + argmin encode beside it;
     - pq_chunk_attention for a 4096-token chunk (12,288 rows per KV head)
       over 28,672 history tokens, and for the last 512-token chunk of the
       serving admission (six slots, 1,536 rows per KV head) over 32,256
       history tokens gathered from shuffled pool pages, in the three
       geometries, in the bf16 tensor-core version the 16-bit model takes,
       and at the chunk shape of the path geometries also in f32; dense bf16
       SDPA over the same lengths as a yardstick;
     - pq_paged_attention at the serving shape (6 slots, 2048-token pages, 104
       + scratch, shuffled 17-entry tables, a bf16 residual window per slot)
       in the three geometries: ragged lengths with -1 table tails and an
       empty slot, six full slots of 32,640 tokens (timed), the single-layer
       entry, and the pages-per-block mode at 2 and 4 pages;
     - causal_attention, the in-chunk causal partial, in bf16 at the chunk
       shape (4 sequences x a 4096-token chunk, 24 / 8 heads, d=128) and the
       admission shape (6 slots x 512 tokens), q/k/v as the model's
       projection lays them out, and in f32 at test-tiny width; torch's flash
       attention with the logsumexp over the same lengths as the library
       yardstick;
  4. the two faults repaired since: pq_decode_attention and
     pq_paged_attention with odd exact-channel counts (OK = OV = 7 and 15)
     against their plain versions; and the history partial's routing, where
     a bf16 model with 32 exact channels a side (a geometry the tensor-core
     version of pq_chunk_attention is not built for) takes its f32 version,
     alone and in a chunked prefill and a paged admission of two layers of
     llama-3.2-3b, each against the plain route;
  5. the main paths, at the full width of llama-3.2-3b (28 layers, random
     weights from a seed, bench.py's synthetic codebooks), 4 requests of
     32,000-token prompts, in mode "pq_kernel" for dm2 and dm4_outlier_c128:
     - the flat path: generate() with 160 new tokens and F=16 sub-window
       flushes, with TTFT, TPOT, tokens/s and the launch counts (decode
       kernel = layers x decode steps, encode kernel = 2 x layers + 2 per
       flush); four teacher-forced steps, one just after a flush, against
       the plain oracle mode "pq";
     - the chunked path: generate(prefill_chunk=4096) with 17 new tokens,
       with TTFT, peak memory and the launch counts (chunk kernel = layers x
       (chunks - 1), causal kernel = layers x chunks, encode kernel = 2 x
       layers x chunks); the last chunk's logits through the kernels against
       the plain versions of both partials on the same cache;
     - the serving path: a Scheduler with 6 slots over the paged cache, six
       requests of 32,640-token prompts and 272 new tokens submitted together
       (one group admission in 64 chunks of 512 through the chunk-history and
       encode kernels and the causal kernel, the decode ticks through the
       paged kernel, two window
       flushes and one page growth per slot), with the admission wall, the
       per-token tick p50 / p90, the flush steps, tokens/s, peak memory, the
       launch counts (paged kernel = layers x dispatched ticks) and any host
       wait inside step(); one teacher-forced paged step mid-window and one
       right after a flush, kernel against plain version on the same state;
     a test-tiny generate, flat and chunked, and a test-tiny Scheduler with a
     forced preemption, on the card against the CPU; dense-mode TTFT and TPOT
     beside;
  6. a JSON line of the kernels, then the card line, then the result line.
It needs no network and starts no process but nvidia-smi and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

BS, PROMPT, N_MAX, NEW_TOKENS, FLUSH = 4, 32000, 32768, 160, 16
CHUNK, CHUNK_NEW_TOKENS = 4096, 17  # the chunked path: 8 chunks, 16 decode steps
# the serving path: six slots of 32,640-token prompts in 2048-token pages, 272 new tokens each
# (two window flushes per slot; the second crosses 16 x 2048 and grows a 17th page)
SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW_TOKENS = 6, 32640, 272
PAGE_SIZE, PAGES_PER_SEQ, POOL_PAGES = 2048, 17, 104
N_PREV = N_MAX - CHUNK  # kernel phase: the longest history a 32K arena gives a chunk
# kernel phase, serving admission: the last 512-token chunk of a 32,640-token prompt
ADMIT_CHUNK = 512
N_PREV_ADMIT = (SERVE_PROMPT - 1) // ADMIT_CHUNK * ADMIT_CHUNK  # 32,256
N_CODES = N_MAX - 512  # kernel phase: the arena fill of bench.py's decode
RESIDUAL_ROWS = 97  # kernel phase: live rows of the 128-row residual window
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
ENCODE_AGREE, ENCODE_MSE_RTOL = 0.999, 1e-4  # kernel vs plain: ties may flip on summation order
KERNEL_TOL = 1e-3  # f32 decode kernel vs f32 plain version: only summation order differs
# the paged kernel vs its plain version (f32, the same splits, only summation order differs):
# 10x what an H100 measured, out 3.6e-7 and lse 9.5e-7 (one f32 step at ~10)
PAGED_TOL = 1e-5
# pq_chunk_attention vs its plain version. Over 28,672 near-uniformly weighted tokens `out` is
# small (rms ~ 0.07, max ~ 0.2) while `lse` is ~ 10, so each has its own limit, 10x what an
# H100 measured: `out` 2.1e-6 (f32) and 5.2e-5 (bf16), `lse` 1.9e-6 (two f32 steps at 10).
CHUNK_OUT_TOL = {"f32": 2e-5,  # only summation order differs
                 "bf16": 5e-4}  # the plain version rounds q, K_hat, V_hat and P to bf16 at the same
# places; the two round P against different running maxima (64-token tile, 1024-token block)
CHUNK_LSE_TOL = 2e-5
# the tensor-core version's distance from the f32 result (bf16 rounding of q, K_hat, V_hat and
# P): measured 5.3e-4 on `out` and 2.0e-3 on `lse`
CHUNK_GAP_OUT_TOL, CHUNK_GAP_LSE_TOL = 5e-3, 2e-2
# causal_partial vs its plain version at the kernel's key tile, `out` and `lse` apart, 10x what an
# H100 measured. f32: only the summation order differs (measured <= 6.0e-7 on `out`, 9.5e-7 on
# `lse`). bf16: both round q * scale and P to bf16 at the same places and P against the same
# running maxima (the plain version over 64-key blocks, the kernel's tile), but a weight's rounding
# may still fall the other way where the two sums of q . k differ in the last f32 bit; at rows of
# few keys (early positions) one such weight moves `out` by up to 2^-9 |v| / l: measured 2.1e-3 at
# the chunk shape (52 of 50 M values past 5e-4) and 2.2e-3 at the admission shape; `lse` 1.9e-6
CAUSAL_OUT_TOL = {"f32": 1e-5, "bf16": 2e-2}
CAUSAL_LSE_TOL = 2e-5
C1_EXACT = 32  # exact channels a side of the repaired routing (pq.outlier_k=32)
LOGIT_TOL = 0.25  # bf16 model, pq_kernel vs pq: attention agrees to ~1e-6 in f32,
# then bf16 rounding of the activations compounds over 28 layers
GEOMETRIES = {  # bench.py:65-107
    "dm2": dict(M=64, C=256, O=0),
    "dm4_outlier": dict(M=32, C=256, O=16),
    "dm4_outlier_c128": dict(M=32, C=128, O=16),
}
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "pq_decode_attention": ("million_tpu_torch/csrc/pq_decode_attention.cu",
                            "million_tpu/ops/pq_attention_pallas.py:837"),
    "pq_chunk_attention": ("million_tpu_torch/csrc/pq_chunk_attention.cu",
                           "million_tpu/ops/pq_attention_pallas.py:1068"),
    "pq_encode": ("million_tpu_torch/csrc/pq_encode.cu",
                  "million_tpu/ops/pq_encode_pallas.py:84"),
    # one kernel for the stacked entry (:1706), the single-layer entry (:1348, a
    # one-layer view) and the pages-per-block mode (:1540, `kpp`)
    "pq_paged_attention": ("million_tpu_torch/csrc/pq_paged_attention.cu",
                           "million_tpu/ops/pq_attention_pallas.py:1706 (and :1348, :1540)"),
    # not a Pallas kernel: the reference's in-chunk partial is plain jnp that XLA fuses
    "causal_attention": ("million_tpu_torch/csrc/causal_attention.cu",
                         "million_tpu/models/chunked_prefill.py:95 (_causal_partial, plain jnp)"),
}
PATH_GEOMETRIES = ("dm2", "dm4_outlier_c128")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def synthetic_cents(L: int, d: int, geom: str, seed: int = 0, O=None):
    """bench.py's synthetic codebooks: standard normal, and for the outlier
    geometries 16 + 16 random exact channels whose centroid components are 0
    (O + O where O is given)."""
    import numpy as np

    g = GEOMETRIES[geom]
    M, C, O = g["M"], g["C"], g["O"] if O is None else O
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((L, M, C, d // M)).astype(np.float32)
    cv = rng.standard_normal((L, M, C, d // M)).astype(np.float32)
    cents = {"key": ck, "value": cv}
    if O:
        koidx = np.sort(rng.choice(d, O, replace=False)).astype(np.int32)
        voidx = np.sort(rng.choice(d, O, replace=False)).astype(np.int32)
        for c in koidx:
            ck[:, c % M, :, c // M] = 0.0
        for c in voidx:
            cv[:, c % M, :, c // M] = 0.0
        cents["k_outlier_idx"] = np.stack([koidx] * L)
        cents["v_outlier_idx"] = np.stack([voidx] * L)
    return cents


def kernel_phase(dev):
    """Kernel vs plain version at the main-path shape, per geometry."""
    import torch
    import torch.nn.functional as F

    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.ops import pq_attention_kernel as K

    nh_k, G, d, L, layer = 8, 3, 128, 2, 1
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    cases = [(g, "stacked") for g in GEOMETRIES] + [("dm4_outlier_c128", "single-layer")]
    for geom, entry in cases:
        M, C, O = (GEOMETRIES[geom][k] for k in ("M", "C", "O"))
        cents = cents_from_numpy(synthetic_cents(L, d, geom, seed=2), device=dev)
        q = torch.randn((BS, nh_k, G, d), generator=gen, device=dev) / d**0.5
        kc = torch.randint(0, C, (L, BS, nh_k, N_MAX, M), generator=gen, device=dev, dtype=torch.uint8)
        vc = torch.randint(0, C, (L, BS, nh_k, N_MAX, M), generator=gen, device=dev, dtype=torch.uint8)
        okw = dict(  # the residual window as the decode step passes it: bf16, 97 live rows
            k_residual=torch.randn((L, BS, nh_k, 128, d), generator=gen, device=dev).bfloat16(),
            v_residual=torch.randn((L, BS, nh_k, 128, d), generator=gen, device=dev).bfloat16(),
            r=RESIDUAL_ROWS,
        )
        if O:
            okw.update(
                k_outliers=torch.randn((L, BS, nh_k, N_MAX, O), generator=gen, device=dev).bfloat16(),
                v_outliers=torch.randn((L, BS, nh_k, N_MAX, O), generator=gen, device=dev).bfloat16(),
                k_oidx=cents["k_outlier_idx"], v_oidx=cents["v_outlier_idx"],
            )
        if entry == "stacked":
            def kern():
                return K.pq_codes_attention_stacked(q, kc, vc, cents["key"], cents["value"],
                                                    layer, N_CODES, **okw)
        else:
            one = {k: v[layer] if torch.is_tensor(v) else v for k, v in okw.items()}

            def kern():
                return K.pq_codes_attention(q, kc[layer], vc[layer], cents["key"][layer],
                                            cents["value"][layer], N_CODES, **one)

        def plain():
            return K.pq_codes_attention_plain(q, kc, vc, cents["key"], cents["value"], layer,
                                              N_CODES, **okw,
                                              n_sm=torch.cuda.get_device_properties(dev).multi_processor_count)

        out_k, lse_k = kern()
        torch.cuda.synchronize()
        out_p, lse_p = plain()
        err_out = float((out_k - out_p).abs().max())
        err_lse = float((lse_k - lse_p).abs().max())
        ok = bool(torch.isfinite(out_k).all()) and max(err_out, err_lse) <= KERNEL_TOL
        ms = cuda_ms(kern, 50)
        plain_ms = cuda_ms(plain, 3, warm=1)
        nbytes = (K.decode_bytes(BS, nh_k, N_CODES, M, M, O, O)
                  + 2 * BS * nh_k * RESIDUAL_ROWS * d * 2  # live residual rows, bf16
                  + 2 * C * d * 4 + 2 * q.numel() * 4 + BS * nh_k * G * 4)
        flops = K.decode_flops(BS, nh_k, G, d, N_CODES + RESIDUAL_ROWS, O)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_OPS_PER_S * 1e3
        # dense bf16 attention over the same length: a yardstick, not the same function
        qd = torch.randn((BS, nh_k * G, 1, d), generator=gen, device=dev).bfloat16()
        kd = torch.randn((BS, nh_k, N_CODES, d), generator=gen, device=dev).bfloat16()
        vd = torch.randn((BS, nh_k, N_CODES, d), generator=gen, device=dev).bfloat16()
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True), 50)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max(err_out, err_lse), dense_sdpa_ms=sdpa_ms)
        rows[(geom, entry)] = row
        log(f"[kernel] {geom:17s} {entry:12s} out_err={err_out:.3g} lse_err={err_lse:.3g} "
            f"(tol {KERNEL_TOL}) kernel={ms:.4f} ms bound={row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
            f"plain={plain_ms:.3f} ms dense_bf16_sdpa={sdpa_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"kernel disagrees with its plain version ({geom}, {entry})")
        del kc, vc, okw, kd, vd
        torch.cuda.empty_cache()
    return rows


def bound_of(nbytes: int, ops: int, ops_per_s: float):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def encode_phase(dev):
    """pq_encode vs its plain version at the prefill and flush shapes."""
    import torch

    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.ops import pq_encode_kernel as E
    from million_tpu_torch.pq.ops import pq_decode, pq_encode_chunked

    nh_k, d, L = 8, 128, 28
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {}

    def compare(got, want, x, cents_s, what):
        agree = float((got == want).float().mean())
        mses = []
        for codes in (got, want):
            err = torch.zeros((), device=dev)
            for s in range(cents_s.shape[0]):  # per bank, a slab of rows at a time
                flat_c, flat_x = codes[s].reshape(-1, codes.shape[-1]), x[s].reshape(-1, d)
                for r0 in range(0, flat_c.shape[0], 1 << 18):
                    rec = pq_decode(flat_c[r0:r0 + (1 << 18)], cents_s[s], "strided")
                    err += (rec - flat_x[r0:r0 + (1 << 18)].float()).square().sum()
            mses.append(float(err) / x.numel())
        rel = abs(mses[0] - mses[1]) / mses[1]
        ok = agree >= ENCODE_AGREE and rel <= ENCODE_MSE_RTOL
        log(f"[kernel] pq_encode {what}: agreement {agree:.6f} (>= {ENCODE_AGREE}), "
            f"reconstruction MSE {mses[0]:.6g} vs plain {mses[1]:.6g} (rel {rel:.2g} <= "
            f"{ENCODE_MSE_RTOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"pq_encode disagrees with its plain version ({what})")
        return 1.0 - agree

    for geom in PATH_GEOMETRIES:
        M, C = GEOMETRIES[geom]["M"], GEOMETRIES[geom]["C"]
        cents = cents_from_numpy(synthetic_cents(L, d, geom, seed=5), device=dev)["key"]
        # prefill shape: the model's (bs, heads, n, d) view of a (bs, n, heads, d) projection
        x = torch.randn((BS, PROMPT, nh_k, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
        n_rows = BS * nh_k * PROMPT

        def kern():
            return E.pq_encode_fused(x, cents[0], "strided", "fast")

        def plain():
            return E.pq_encode_fused_plain(x[None], cents[:1], "strided", "fast")[0]

        def library():
            return pq_encode_chunked(x, cents[0], "strided", precision="fast")

        got = kern()
        torch.cuda.synchronize()
        miss = compare(got[None], plain()[None], x[None], cents[:1], f"{geom} prefill shape "
                       f"({n_rows} rows x d={d} bf16)")
        ms, plain_ms, lib_ms = cuda_ms(kern, 20), cuda_ms(plain, 2, warm=1), cuda_ms(library, 2, warm=1)
        nbytes, ops = E.encode_bytes(n_rows, d, M, 2), E.encode_ops(n_rows, M, C, d // M)
        bound_ms, bound_by = bound_of(nbytes, ops, F32_OPS_PER_S)
        log(f"[kernel] pq_encode {geom} prefill shape: kernel={ms:.4f} ms bound={bound_ms:.4f} ms "
            f"({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop) plain={plain_ms:.3f} ms "
            f"torch baddbmm+argmin (pq_encode_chunked)={lib_ms:.3f} ms")
        rows[geom] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=miss, library_ms=lib_ms)
        # the shapes the chunked path gives it: a whole chunk and the last, shorter one,
        # each the (bs, heads, n, d) view of that chunk's own projection
        for n in (CHUNK, PROMPT % CHUNK):
            xc = torch.randn((BS, n, nh_k, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
            compare(E.pq_encode_fused(xc, cents[0], "strided", "fast")[None],
                    E.pq_encode_fused_plain(xc[None], cents[:1], "strided", "fast"), xc[None],
                    cents[:1], f"{geom} chunk shape ({BS} x {nh_k} x {n} rows)")
        # integer-valued inputs: nothing rounds, codes must be bit-equal
        xi = torch.randint(-4, 5, (BS, 2048, nh_k, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
        ci = torch.randint(-4, 5, cents[0].shape, generator=gen, device=dev).float()
        same = bool((E.pq_encode_fused(xi, ci, "strided", "fast")
                     == E.pq_encode_fused_plain(xi[None], ci[None], "strided", "fast")[0]).all())
        log(f"[kernel] pq_encode {geom} integer-valued inputs: codes bit-equal {same}")
        if not same:
            raise RuntimeError(f"pq_encode differs on integer inputs ({geom})")
        # flush shape: the oldest 16 rows of every layer's residual window, one bank per layer
        window = torch.randn((L, BS, nh_k, 128, d), generator=gen, device=dev).bfloat16()[:, :, :, :FLUSH]

        def kern_f():
            return E.pq_encode_fused_stacked(window, cents, "strided", "fast")

        def plain_f():
            return E.pq_encode_fused_plain(window, cents, "strided", "fast")

        compare(kern_f(), plain_f(), window, cents, f"{geom} flush shape ({L} banks x "
                f"{BS * nh_k * FLUSH} rows)")
        log(f"[kernel] pq_encode {geom} flush shape: kernel={cuda_ms(kern_f, 50):.4f} ms "
            f"plain={cuda_ms(plain_f, 10):.4f} ms")
        del x, got, window
        torch.cuda.empty_cache()
    return rows


def chunk_phase(dev):
    """pq_chunk_attention vs its plain version at the two shapes the paths give
    it: a 4096-token chunk over the longest history of the chunked path (both
    precisions on the path geometries, bf16 on dm4_outlier), and the last
    512-token chunk of a six-slot admission over an arena that _gather_history
    lays out from shuffled pool pages (bf16, every geometry)."""
    import torch
    import torch.nn.functional as F

    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models.paged_decode import _gather_history
    from million_tpu_torch.ops import pq_chunk_attention_kernel as K

    nh_k, G, d = 8, 3, 128
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = {}

    def check(geom, shape, bs, q, kc, vc, cents, n_prev, okw, precisions):
        M, C, O = (GEOMETRIES[geom][k] for k in ("M", "C", "O"))
        qr = K.group_rows(q, nh_k, 1.0 / d**0.5).contiguous()
        QR = qr.shape[2]
        nbytes = K.chunk_bytes(bs, nh_k, QR, d, n_prev, M, M, O, O) + 2 * C * d * 4
        ops = K.chunk_ops(bs, nh_k, QR, d, n_prev, O)
        bound_ms, bound_by = bound_of(nbytes, ops, BF16_OPS_PER_S)
        # dense bf16 attention over the same lengths: a yardstick, not the same function
        qd = q.bfloat16()
        kd = torch.randn((bs, nh_k, n_prev, d), generator=gen, device=dev).bfloat16()
        vd = torch.randn((bs, nh_k, n_prev, d), generator=gen, device=dev).bfloat16()
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True), 5)
        del qd, kd, vd
        exact = None
        for precision in precisions:
            def kern():
                return K.pq_chunk_attention(qr, kc, vc, cents["key"][0], cents["value"][0], n_prev,
                                            precision=precision, **okw)

            def plain(pr=precision):
                return K.pq_chunk_attention_plain(qr, kc, vc, cents["key"][0], cents["value"][0],
                                                  n_prev, precision=pr, **okw)

            out_k, lse_k = kern()
            torch.cuda.synchronize()
            out_p, lse_p = plain()
            # through the GQA wrapper the paths call, against the regrouped plain result
            out_w, lse_w = K.pq_chunk_history_attention(q, kc, vc, cents["key"][0], cents["value"][0],
                                                        n_prev, 1.0 / d**0.5, precision=precision, **okw)
            out_g, lse_g = K.ungroup_rows(out_p, lse_p, nh_k * G)
            rms, peak = float(out_p.square().mean().sqrt()), float(out_p.abs().max())
            err_out = max(float((out_k - out_p).abs().max()), float((out_w - out_g).abs().max()))
            err_lse = max(float((lse_k - lse_p).abs().max()), float((lse_w - lse_g).abs().max()))
            if exact is None:
                exact = (out_p, lse_p) if precision == "f32" else plain("f32")
            gap_out = float((out_k - exact[0]).abs().max())
            gap_lse = float((lse_k - exact[1]).abs().max())
            tol_out = CHUNK_OUT_TOL[precision]
            ok = (bool(torch.isfinite(out_k).all()) and err_out <= tol_out and err_lse <= CHUNK_LSE_TOL
                  and gap_out <= CHUNK_GAP_OUT_TOL and gap_lse <= CHUNK_GAP_LSE_TOL)
            del out_k, out_p, out_w, out_g
            ms, plain_ms = cuda_ms(kern, 3, warm=1), cuda_ms(plain, 1, warm=0)
            rows[(geom, shape, precision)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                                  bound_by=bound_by, max_abs_err=max(err_out, err_lse),
                                                  library_ms=None)
            log(f"[kernel] pq_chunk_attention {geom} {precision} {shape}: bs={bs} rows={QR} n_prev={n_prev} "
                f"out rms={rms:.3g} max={peak:.3g} out_err={err_out:.3g} (tol {tol_out:g}) "
                f"lse_err={err_lse:.3g} (tol {CHUNK_LSE_TOL:g}), kernel and GQA wrapper; gap to the f32 "
                f"plain version out {gap_out:.3g} (tol {CHUNK_GAP_OUT_TOL:g}) lse {gap_lse:.3g} "
                f"(tol {CHUNK_GAP_LSE_TOL:g}) "
                f"kernel={ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s) bound={bound_ms:.3f} ms ({bound_by}, "
                f"bf16 tensor-core peak; f32 rate: {ops / F32_OPS_PER_S * 1e3:.1f} ms; "
                f"{nbytes / 1e6:.1f} MB, {ops / 1e12:.2f} TFLOP) plain={plain_ms:.1f} ms "
                f"dense_bf16_sdpa={sdpa_ms:.3f} ms {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"pq_chunk_attention disagrees with its plain version ({geom}, {shape}, "
                                   f"{precision})")
        del exact

    S, nph = SERVE_SLOTS, -(-N_PREV_ADMIT // PAGE_SIZE)
    for geom in GEOMETRIES:
        M, C, O = (GEOMETRIES[geom][k] for k in ("M", "C", "O"))
        cents = cents_from_numpy(synthetic_cents(1, d, geom, seed=7), device=dev)
        okidx = dict(koidx=cents["k_outlier_idx"][0], voidx=cents["v_outlier_idx"][0]) if O else {}
        # the chunked path: one 4096-token chunk of bs sequences over a flat arena
        q = torch.randn((BS, nh_k * G, CHUNK, d), generator=gen, device=dev)
        kc = torch.randint(0, C, (BS, nh_k, N_MAX, M), generator=gen, device=dev, dtype=torch.uint8)
        vc = torch.randint(0, C, (BS, nh_k, N_MAX, M), generator=gen, device=dev, dtype=torch.uint8)
        okw = dict(okidx)
        if O:
            okw.update(k_outliers=torch.randn((BS, nh_k, N_MAX, O), generator=gen, device=dev).bfloat16(),
                       v_outliers=torch.randn((BS, nh_k, N_MAX, O), generator=gen, device=dev).bfloat16())
        check(geom, "chunk", BS, q, kc, vc, cents, N_PREV, okw,
              ("f32", "bf16") if geom in PATH_GEOMETRIES else ("bf16",))
        del q, kc, vc, okw
        torch.cuda.empty_cache()
        # serving admission: the last 512-token chunk of six slots over their history pages,
        # gathered from a pool of 2048-token pages in shuffled order as admission gathers them
        h_pages = torch.randperm(POOL_PAGES, generator=torch.Generator().manual_seed(13))[: S * nph]
        h_pages = h_pages.reshape(S, nph).to(dev)

        def arena(X, dtype=torch.uint8):
            shape = (1, POOL_PAGES + 1, nh_k, PAGE_SIZE, X)
            pool = (torch.randint(0, C, shape, generator=gen, device=dev, dtype=dtype) if dtype == torch.uint8
                    else torch.randn(shape, generator=gen, device=dev).to(dtype))
            return _gather_history(pool, 0, h_pages)

        q = torch.randn((S, nh_k * G, ADMIT_CHUNK, d), generator=gen, device=dev)
        kc, vc = arena(M), arena(M)
        okw = dict(okidx)
        if O:
            okw.update(k_outliers=arena(O, torch.bfloat16), v_outliers=arena(O, torch.bfloat16))
        check(geom, "admission", S, q, kc, vc, cents, N_PREV_ADMIT, okw, ("bf16",))
        del q, kc, vc, okw
        torch.cuda.empty_cache()
    return rows


def paged_phase(dev):
    """pq_paged_attention vs its plain version at the serving shape: ragged
    lengths with -1 table tails and an empty slot, full slots (timed), the
    single-layer entry and the pages-per-block mode."""
    import torch
    import torch.nn.functional as F

    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.ops import pq_paged_attention_kernel as P

    nh_k, G, d, L, layer = 8, 3, 128, 2, 1
    S, ps, pps, n_pages, Lt = SERVE_SLOTS, PAGE_SIZE, PAGES_PER_SEQ, POOL_PAGES, 128
    gen = torch.Generator(device=dev).manual_seed(8)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ragged = [SERVE_PROMPT, SERVE_PROMPT, 20004, 8192, 516, 0]
    rows_ragged = [97, 128, 1, 33, 5, 0]
    full = [SERVE_PROMPT] * S
    n_bound = 16 * ps  # the scheduler's bound before the slots grow a 17th page
    rows = {}
    for geom in GEOMETRIES:
        M, C, O = (GEOMETRIES[geom][k] for k in ("M", "C", "O"))
        cents = cents_from_numpy(synthetic_cents(L, d, geom, seed=9), device=dev)
        q = torch.randn((S, nh_k, G, d), generator=gen, device=dev) / d**0.5
        kp = torch.randint(0, C, (L, n_pages + 1, nh_k, ps, M), generator=gen, device=dev, dtype=torch.uint8)
        vp = torch.randint(0, C, (L, n_pages + 1, nh_k, ps, M), generator=gen, device=dev, dtype=torch.uint8)
        okw = dict(k_residual=torch.randn((L, S, nh_k, Lt, d), generator=gen, device=dev).bfloat16(),
                   v_residual=torch.randn((L, S, nh_k, Lt, d), generator=gen, device=dev).bfloat16())
        if O:
            okw.update(
                k_outliers=torch.randn((L, n_pages + 1, nh_k, ps, O), generator=gen, device=dev).bfloat16(),
                v_outliers=torch.randn((L, n_pages + 1, nh_k, ps, O), generator=gen, device=dev).bfloat16(),
                k_oidx=cents["k_outlier_idx"], v_oidx=cents["v_outlier_idx"])
        perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(10))[: S * pps]

        def table_for(lens):  # shuffled page ids, -1 past each sequence's pages
            t = perm.reshape(S, pps).clone().to(torch.int32)
            for b, n in enumerate(lens):
                t[b, -(-n // ps):] = -1
            return t.to(dev)

        def case(lens, live_rows):
            return (table_for(lens), torch.tensor(lens, dtype=torch.int32, device=dev),
                    torch.tensor(live_rows, dtype=torch.int32, device=dev))

        def run(fn, c, **kw):
            table, n_codes, r = c
            return fn(q, kp, vp, cents["key"], cents["value"], layer, table, n_codes,
                      n_bound=n_bound, r=r, **okw, **kw)

        def compare(what, got, want, tol=PAGED_TOL):
            err_out = float((got[0] - want[0]).abs().max())
            err_lse = float((got[1] - want[1]).abs().max())
            ok = bool(torch.isfinite(got[0]).all()) and max(err_out, err_lse) <= tol
            log(f"[kernel] pq_paged_attention {geom:17s} {what}: out_err={err_out:.3g} "
                f"lse_err={err_lse:.3g} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"pq_paged_attention disagrees with its plain version ({geom}, {what})")
            return max(err_out, err_lse)

        # (a) ragged lengths, -1 tails, an empty slot without residual rows
        c_rag = case(ragged, rows_ragged)
        got = run(P.pq_paged_attention_stacked, c_rag)
        torch.cuda.synchronize()
        err = compare(f"ragged n_codes={ragged} r={rows_ragged}", got,
                      run(P.pq_paged_attention_plain, c_rag, n_sm=n_sm))
        empty_ok = bool((got[0][-1] == 0).all()) and bool((got[1][-1] == -1e30).all())
        log(f"[kernel] pq_paged_attention {geom:17s} empty slot: out == 0 and lse == -1e30: {empty_ok}")
        if not empty_ok:
            raise RuntimeError(f"pq_paged_attention: the empty slot is not (0, -1e30) ({geom})")
        # (b) six full slots
        c_full = case(full, [RESIDUAL_ROWS] * S)
        got_full = run(P.pq_paged_attention_stacked, c_full)
        plain_full = run(P.pq_paged_attention_plain, c_full, n_sm=n_sm)
        err = max(err, compare(f"full {S} x {SERVE_PROMPT}", got_full, plain_full))
        # (c) the single-layer entry
        one = {k: v[layer] for k, v in okw.items()}
        got_one = P.pq_paged_attention(q, kp[layer], vp[layer], cents["key"][layer], cents["value"][layer],
                                       c_full[0], c_full[1], n_bound=n_bound, r=c_full[2], **one)
        err = max(err, compare("single-layer entry", got_one, plain_full))
        # (d) the pages-per-block mode: against its own plain version and the default mode
        kpp_ms = {}
        for kpp in (2, 4):
            got_k = run(P.pq_paged_attention_stacked_mp, c_rag, kpp=kpp)
            err = max(err, compare(f"kpp={kpp} ragged vs plain(kpp)", got_k,
                                   run(P.pq_paged_attention_plain, c_rag, n_sm=n_sm, kpp=kpp)))
            compare(f"kpp={kpp} ragged vs the default mode", got_k, got)
            kpp_ms[kpp] = cuda_ms(lambda: run(P.pq_paged_attention_stacked_mp, c_full, kpp=kpp), 50)
        ms = cuda_ms(lambda: run(P.pq_paged_attention_stacked, c_full), 50)
        ms_rag = cuda_ms(lambda: run(P.pq_paged_attention_stacked, c_rag), 50)
        plain_ms = cuda_ms(lambda: run(P.pq_paged_attention_plain, c_full, n_sm=n_sm), 3, warm=1)
        nbytes = (P.paged_bytes(full, nh_k, M, M, O, O)
                  + 2 * S * nh_k * RESIDUAL_ROWS * d * 2  # live residual rows, bf16
                  + 2 * C * d * 4 + 2 * q.numel() * 4 + S * nh_k * G * 4 + S * pps * 4 + 2 * S * 4)
        flops = P.paged_flops([n + RESIDUAL_ROWS for n in full], nh_k, G, d, O)
        bound_ms, bound_by = bound_of(nbytes, flops, F32_OPS_PER_S)
        # dense bf16 attention over the same lengths: a yardstick, not the same function
        qd = torch.randn((S, nh_k * G, 1, d), generator=gen, device=dev).bfloat16()
        kd = torch.randn((S, nh_k, SERVE_PROMPT, d), generator=gen, device=dev).bfloat16()
        vd = torch.randn((S, nh_k, SERVE_PROMPT, d), generator=gen, device=dev).bfloat16()
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True), 50)
        rows[geom] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=err, library_ms=None)
        log(f"[kernel] pq_paged_attention {geom:17s} full {S} x {SERVE_PROMPT}: kernel={ms:.4f} ms "
            f"(kpp=2 {kpp_ms[2]:.4f}, kpp=4 {kpp_ms[4]:.4f}; ragged {ms_rag:.4f}) bound={bound_ms:.4f} ms "
            f"({bound_by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) plain={plain_ms:.3f} ms "
            f"dense_bf16_sdpa={sdpa_ms:.4f} ms")
        del kp, vp, okw, kd, vd
        torch.cuda.empty_cache()
    return rows


def causal_phase(dev):
    """causal_partial vs its plain version at the shapes the paths give it:
    a 4096-token chunk of four sequences and a 512-token chunk of the six
    admission slots (llama-3.2-3b: 24 / 8 heads, d=128, bf16), with q and k
    head slices of one tensor and v token-major as the model's projection
    lays them out, and at test-tiny width in f32 (the f32 version; the
    chunked path of tiny_check and a longer chunk). Torch's flash attention
    with the logsumexp over the same lengths, K and V expanded to the query
    heads outside the timed region, is the library yardstick; the port never
    calls it."""
    import torch

    from million_tpu_torch.ops import causal_attention_kernel as CA

    gen = torch.Generator(device=dev).manual_seed(14)
    rows = {}
    cases = (("chunk", BS, 24, 8, CHUNK, 128, torch.bfloat16, 20),
             ("admission", SERVE_SLOTS, 24, 8, ADMIT_CHUNK, 128, torch.bfloat16, 100),
             ("test-tiny", 2, 4, 2, 4, 16, torch.float32, 100),
             ("test-tiny long", 2, 4, 2, 1024, 16, torch.float32, 20))
    for shape, bs, nh, nh_k, nc, d, dt, iters in cases:
        precision = "bf16" if dt == torch.bfloat16 else "f32"
        qk = torch.randn((bs, nh + nh_k, nc, d), generator=gen, device=dev).to(dt)
        q, k = qk[:, :nh], qk[:, nh:]
        v = torch.randn((bs, nc, nh_k, d), generator=gen, device=dev).to(dt).transpose(1, 2)
        scale = 1.0 / d**0.5

        def kern():
            return CA.causal_partial(q, k, v, scale)

        def plain(block=CA.KEY_TILE[precision]):
            return CA.causal_partial_plain(q, k, v, scale, block=block)

        out_k, lse_k = kern()
        torch.cuda.synchronize()
        out_p, lse_p = plain()
        diff = (out_k - out_p).abs()
        err_out, err_rms = float(diff.max()), float(diff.square().mean().sqrt())
        n_past = int((diff > 5e-4).sum())  # values past the history kernel's bf16 limit
        worst = [int(x) for x in torch.unravel_index(diff.argmax(), diff.shape)]  # (b, head, pos, dim)
        del diff
        err_lse = float((lse_k - lse_p).abs().max())
        rms = float(out_p.square().mean().sqrt())
        ok = (bool(torch.isfinite(out_k).all() and torch.isfinite(lse_k).all())
              and err_out <= CAUSAL_OUT_TOL[precision] and err_lse <= CAUSAL_LSE_TOL)
        n_out = out_p.numel()
        del out_k, lse_k, out_p, lse_p
        ms = cuda_ms(kern, iters)
        plain_ms = cuda_ms(lambda: plain(1024), 3, warm=1)  # the block the paths' plain route takes
        lib_ms = None
        if dt == torch.bfloat16:
            ke, ve = (t.repeat_interleave(nh // nh_k, dim=1) for t in (k, v))
            lib_ms = cuda_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                q, ke, ve, 0.0, True, False, scale=scale), iters)
            del ke, ve
        ops, nbytes = CA.causal_ops(bs, nh, nc, d), CA.causal_bytes(bs, nh, nh_k, nc, d, q.element_size())
        bound_ms, bound_by = bound_of(nbytes, ops, BF16_OPS_PER_S if precision == "bf16" else F32_OPS_PER_S)
        rows[shape] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           max_abs_err=max(err_out, err_lse), library_ms=lib_ms)
        log(f"[kernel] causal_attention {precision} {shape}: bs={bs} heads={nh}/{nh_k} nc={nc} d={d} "
            f"out rms={rms:.3g} out_err={err_out:.3g} (tol {CAUSAL_OUT_TOL[precision]:g}; rms "
            f"{err_rms:.3g}, {n_past} of {n_out} past 5e-4, worst at (b, head, pos, dim) {worst}) "
            f"lse_err={err_lse:.3g} (tol {CAUSAL_LSE_TOL:g}) against the plain version over "
            f"{CA.KEY_TILE[precision]}-key blocks; kernel={ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s) "
            f"bound={bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) "
            f"plain (1024-key blocks)={plain_ms:.3f} ms library (flash attention, causal, lse)="
            f"{'%.4f ms (kernel / library %.3f)' % (lib_ms, ms / lib_ms) if lib_ms is not None else 'none in f32'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"causal_attention disagrees with its plain version ({shape}, {precision})")
        del qk, q, k, v
        torch.cuda.empty_cache()
    return rows


def c4_phase(dev):
    """The repaired odd exact-channel counts: pq_decode_attention (B1) and
    pq_paged_attention (B4) with OK = OV = 7 and 15 (dm4_outlier_c128
    codebooks, llama-3.2-3b's group), each against its plain version at
    PAGED_TOL on `out` and `lse`. The flat arena holds 8,191 tokens a row, so
    most tiles' outlier rows start off a 16-byte boundary; the paged case has
    ragged lengths and an empty slot."""
    import torch

    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.ops import pq_attention_kernel as K
    from million_tpu_torch.ops import pq_paged_attention_kernel as P

    nh_k, G, d, L, layer, Lt = 8, 3, 128, 2, 1, 128
    geom = "dm4_outlier_c128"
    M, C = GEOMETRIES[geom]["M"], GEOMETRIES[geom]["C"]
    gen = torch.Generator(device=dev).manual_seed(17)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ps, pps, n_pages, slots = PAGE_SIZE, 4, 24, SERVE_SLOTS
    lens, live_rows = [8192, 8192, 5000, 2049, 300, 0], [97, 128, 1, 33, 5, 0]
    N, n_codes = 8191, 8000

    def compare(what, got, want):
        err_out = float((got[0] - want[0]).abs().max())
        err_lse = float((got[1] - want[1]).abs().max())
        ok = bool(torch.isfinite(got[0]).all()) and max(err_out, err_lse) <= PAGED_TOL
        log(f"[c4] {what}: out_err={err_out:.3g} lse_err={err_lse:.3g} (tol {PAGED_TOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"odd exact channels: {what} disagrees with its plain version")

    for O in (7, 15):
        cents = cents_from_numpy(synthetic_cents(L, d, geom, seed=18, O=O), device=dev)
        ocw = dict(k_oidx=cents["k_outlier_idx"], v_oidx=cents["v_outlier_idx"])
        # B1: bs 4 over a flat arena of N = 8,191 tokens, 8,000 of them codes, 97 residual rows
        q = torch.randn((BS, nh_k, G, d), generator=gen, device=dev) / d**0.5
        kc, vc = (torch.randint(0, C, (L, BS, nh_k, N, M), generator=gen, device=dev, dtype=torch.uint8)
                  for _ in range(2))
        okw = dict(ocw, k_outliers=torch.randn((L, BS, nh_k, N, O), generator=gen, device=dev).bfloat16(),
                   v_outliers=torch.randn((L, BS, nh_k, N, O), generator=gen, device=dev).bfloat16(),
                   k_residual=torch.randn((L, BS, nh_k, Lt, d), generator=gen, device=dev).bfloat16(),
                   v_residual=torch.randn((L, BS, nh_k, Lt, d), generator=gen, device=dev).bfloat16(),
                   r=RESIDUAL_ROWS)
        args = (q, kc, vc, cents["key"], cents["value"], layer, n_codes)
        got = K.pq_codes_attention_stacked(*args, **okw)
        torch.cuda.synchronize()
        compare(f"pq_decode_attention OK = OV = {O}, bs={BS} N_max={N} n_codes={n_codes}", got,
                K.pq_codes_attention_plain(*args, **okw, n_sm=n_sm))
        del kc, vc, okw
        # B4: six slots over 2048-token pages, ragged lengths and an empty slot
        q = torch.randn((slots, nh_k, G, d), generator=gen, device=dev) / d**0.5
        kp, vp = (torch.randint(0, C, (L, n_pages + 1, nh_k, ps, M), generator=gen, device=dev,
                                dtype=torch.uint8) for _ in range(2))
        table = torch.randperm(n_pages, generator=torch.Generator().manual_seed(19))[: slots * pps]
        table = table.reshape(slots, pps).to(torch.int32)
        for b, n in enumerate(lens):
            table[b, -(-n // ps):] = -1
        pkw = dict(ocw, k_outliers=torch.randn((L, n_pages + 1, nh_k, ps, O), generator=gen, device=dev).bfloat16(),
                   v_outliers=torch.randn((L, n_pages + 1, nh_k, ps, O), generator=gen, device=dev).bfloat16(),
                   k_residual=torch.randn((L, slots, nh_k, Lt, d), generator=gen, device=dev).bfloat16(),
                   v_residual=torch.randn((L, slots, nh_k, Lt, d), generator=gen, device=dev).bfloat16(),
                   r=torch.tensor(live_rows, dtype=torch.int32, device=dev))
        args = (q, kp, vp, cents["key"], cents["value"], layer, table.to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev))
        got = P.pq_paged_attention_stacked(*args, **pkw)
        torch.cuda.synchronize()
        compare(f"pq_paged_attention OK = OV = {O}, lengths {lens}", got,
                P.pq_paged_attention_plain(*args, **pkw, n_sm=n_sm))
        if not (bool((got[0][-1] == 0).all()) and bool((got[1][-1] == -1e30).all())):
            raise RuntimeError(f"odd exact channels: the empty slot is not (0, -1e30) (OK = OV = {O})")
        del kp, vp, pkw
        torch.cuda.empty_cache()


def c1_phase(dev, cfg, params):
    """The repaired routing: a bf16 model whose arena holds 32 exact K and V
    channels, more than the tensor-core version of pq_chunk_attention is
    built for, takes its f32 version (it raised before). The history partial
    alone against its plain version, then two layers of llama-3.2-3b through
    a chunked prefill and a paged admission, kernels against plain versions."""
    import dataclasses

    import torch

    from million_tpu_torch.cache import paged_pq_cache as tpc
    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models.chunked_prefill import _history_partial, chunked_prefill
    from million_tpu_torch.models.paged_decode import paged_admit_chunked
    from million_tpu_torch.ops import pq_chunk_attention_kernel as K

    geom, O, L = "dm4_outlier_c128", C1_EXACT, 2
    M, C = GEOMETRIES[geom]["M"], GEOMETRIES[geom]["C"]
    nh_k, d = cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(15)
    cents = cents_from_numpy(synthetic_cents(L, d, geom, seed=16, O=O), device=dev)
    # (a) the history partial: 2 sequences x a 512-token chunk over 8,192 tokens
    n_prev, nc = 8192, ADMIT_CHUNK
    q = torch.randn((2, cfg.num_heads, nc, d), generator=gen, device=dev).bfloat16()
    kc, vc = (torch.randint(0, C, (2, nh_k, n_prev, M), generator=gen, device=dev, dtype=torch.uint8)
              for _ in range(2))
    okw = dict(koidx=cents["k_outlier_idx"][0], voidx=cents["v_outlier_idx"][0],
               k_outliers=torch.randn((2, nh_k, n_prev, O), generator=gen, device=dev).bfloat16(),
               v_outliers=torch.randn((2, nh_k, n_prev, O), generator=gen, device=dev).bfloat16())
    precision = K.history_precision(q, vc, okw["k_outliers"], okw["v_outliers"])
    before = K.pq_chunk_attention.launches
    got = K.pq_chunk_history_attention(q, kc, vc, cents["key"][0], cents["value"][0], n_prev, d**-0.5, **okw)
    torch.cuda.synchronize()
    launched = K.pq_chunk_attention.launches - before
    want = _history_partial(q, kc, vc, cents["key"][0], cents["value"][0], n_prev, d**-0.5, **okw)
    err_out, err_lse = (float((g - w).abs().max()) for g, w in zip(got, want))
    ok = (precision == "f32" and launched == 1 and err_out <= CHUNK_OUT_TOL["f32"]
          and err_lse <= CHUNK_LSE_TOL)
    log(f"[c1] bf16 queries, OK = OV = {O}: history precision {precision!r}, {launched} launch of the "
        f"f32 version; out_err={err_out:.3g} (tol {CHUNK_OUT_TOL['f32']:g}) lse_err={err_lse:.3g} "
        f"(tol {CHUNK_LSE_TOL:g}) against its plain version {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the C1 geometry's history partial failed")
    del q, kc, vc, okw, got, want
    # (b) two layers of llama-3.2-3b: a chunked prefill (2 x 8,192 tokens in chunks of 4,096)
    # and a paged admission (one 8,192-token prompt in chunks of 512), kernels vs plain versions
    cfg2 = dataclasses.replace(cfg, num_layers=L)
    ids = torch.randint(0, cfg.vocab_size, (2, 2 * CHUNK), generator=gen, device=dev)
    pqc = PQCacheConfig(bs=2, nh_k=nh_k, d=d, M=M, C=C, Lt=128, N_max=2 * CHUNK, OK=O, OV=O)
    pcfg = tpc.PagedPQCacheConfig(num_layers=L, nh_k=nh_k, d=d, M=M, C=C, Lt=128, page_size=PAGE_SIZE,
                                  n_pages=8, max_seqs=1, pages_per_seq=4, OK=O, OV=O)
    gaps = {}
    for what in ("chunked prefill", "paged admission"):
        logits = []
        for use_kernel in (None, False):
            if what == "chunked prefill":
                lg, _ = chunked_prefill(params, cfg2, ids, init_state(pqc, L, device=dev), cents, chunk=CHUNK,
                                        use_kernel=use_kernel)
            else:
                st = tpc.allocate_pages(tpc.init_paged_state(pcfg, device=dev), 0, 4)
                lg, _ = paged_admit_chunked(params, cfg2, pcfg, 0, ids[0].cpu().numpy(), st, cents,
                                            chunk=ADMIT_CHUNK, use_kernel=use_kernel)
            logits.append(lg)
        if not all(bool(torch.isfinite(x).all()) for x in logits):
            raise RuntimeError(f"non-finite logits in the C1 {what}")
        gaps[what] = float((logits[0] - logits[1]).abs().max())
    log(f"[c1] two layers of llama-3.2-3b in bf16, OK = OV = {O}, {geom} codebooks: max |logit(kernels) - "
        f"logit(plain versions)| { {k: '%.4g' % v for k, v in gaps.items()} } (tol {LOGIT_TOL})")
    if max(gaps.values()) > LOGIT_TOL:
        raise RuntimeError("the C1 geometry's chunked prefill or admission failed")
    del ids
    torch.cuda.empty_cache()


def tiny_check(dev):
    """Small input: test-tiny generate on the card (kernel) vs on the CPU
    (the kernel's plain version) must give the same greedy tokens."""
    import numpy as np
    import torch

    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models.llama import PRESETS, init_params
    from million_tpu_torch.runtime.generate import generate

    cfg = PRESETS["test-tiny"]
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_dev = {k: (v.to(dev) if k != "layers" else {a: b.to(dev) for a, b in v.items()})
             for k, v in p_cpu.items()}
    rng = np.random.default_rng(3)
    c = {"key": rng.standard_normal((2, 4, 64, 4)).astype(np.float32),
         "value": rng.standard_normal((2, 4, 64, 4)).astype(np.float32),
         "k_outlier_idx": np.array([[1, 5, 9, 12]] * 2, np.int32),
         "v_outlier_idx": np.array([[0, 3, 7, 14]] * 2, np.int32)}
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10)))
    pqc = PQCacheConfig(bs=2, nh_k=2, d=16, M=4, C=64, Lt=8, N_max=128,
                        dtype=torch.float32, OK=4, OV=4)
    for what, kw in (("flat", {}), ("chunked (prefill_chunk=4)", dict(prefill_chunk=4))):
        toks = []
        for d in ("cpu", dev):
            res, _ = generate(p_cpu if d == "cpu" else p_dev, cfg, ids.to(d), init_state(pqc, 2, device=d),
                              cents_from_numpy(c, device=d), max_new_tokens=16, flush_chunk=4, device=d, **kw)
            toks.append(res.tokens)
        same = bool((toks[0] == toks[1]).all())
        log(f"[tiny] test-tiny generate, {what}, card vs cpu greedy tokens equal: {same}")
        if not same:
            raise RuntimeError(f"test-tiny tokens differ ({what}): {toks}")


def tiny_serving_check(dev):
    """Small input: the tiny Scheduler of the tests (f32, two slots, a pool
    small enough to force a preemption) serves four requests of different
    lengths on the card (paged kernel) and on the CPU (its plain version):
    the greedy tokens of every request must be equal."""
    import numpy as np
    import torch

    from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models.llama import PRESETS, init_params
    from million_tpu_torch.runtime.scheduler import Request, Scheduler

    cfg = PRESETS["test-tiny"]
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_dev = {k: (v.to(dev) if k != "layers" else {a: b.to(dev) for a, b in v.items()})
             for k, v in p_cpu.items()}
    rng = np.random.default_rng(11)
    c = {"key": rng.standard_normal((2, 4, 64, 4)).astype(np.float32),
         "value": rng.standard_normal((2, 4, 64, 4)).astype(np.float32),
         "k_outlier_idx": np.array([[1, 5, 9, 12]] * 2, np.int32),
         "v_outlier_idx": np.array([[0, 3, 7, 14]] * 2, np.int32)}
    for side, idx in (("key", c["k_outlier_idx"][0]), ("value", c["v_outlier_idx"][0])):
        for ch in idx:
            c[side][:, ch % 4, :, ch // 4] = 0.0
    pcfg = PagedPQCacheConfig(num_layers=2, nh_k=2, d=16, M=4, C=64, Lt=8, page_size=256, n_pages=3,
                              max_seqs=2, pages_per_seq=3, dtype=torch.float32, OK=4, OV=4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (200, 180, 30, 300)]
    out = {}
    for d, params in (("cpu", p_cpu), (dev, p_dev)):
        sched = Scheduler(params, cfg, pcfg, cents_from_numpy(c, device=d), admit_chunk=128, device=d)
        for rid, pr in enumerate(prompts):
            sched.submit(Request(rid, pr, 100 if rid < 2 else 20))
        done = sched.run_to_completion(max_ticks=2000)
        out[str(d)] = ({f.rid: f.tokens for f in done}, sched.preemptions,
                       int(sched.state["used"].sum()))
    (t_cpu, pre_cpu, used_cpu), (t_dev, pre_dev, used_dev) = out["cpu"], out[str(dev)]
    same = set(t_cpu) == set(t_dev) == {0, 1, 2, 3} and all(
        np.array_equal(t_cpu[r], t_dev[r]) for r in t_cpu)
    log(f"[tiny] test-tiny serving (2 slots, 3 pages of 256, requests of 200/180/30/300 tokens, group, "
        f"chunked and one-shot admission): card vs cpu greedy tokens equal: {same}; preemptions cpu {pre_cpu} "
        f"card {pre_dev}; pages in use at the end {used_cpu} / {used_dev}")
    if not same or pre_cpu < 1 or pre_dev < 1 or used_cpu or used_dev:
        raise RuntimeError(f"test-tiny serving check failed: {t_cpu} vs {t_dev}")


def serving_path(dev, cfg, params, launches):
    """Continuous-batching serving at full llama-3.2-3b width: six requests
    of 32,640-token prompts and 272 new tokens each through Scheduler.submit /
    step (one group admission through the chunk-history and encode kernels,
    the decode ticks through the paged kernel, two window flushes and one
    page growth per slot), with a teacher-forced step through the kernel
    against the same step through its plain version, mid-run and right
    after a flush."""
    import warnings

    import numpy as np
    import torch

    from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models.paged_decode import flush_paged_slots, paged_decode_step
    from million_tpu_torch.runtime.scheduler import Request, Scheduler

    wrappers = path_wrappers()
    L, d = cfg.num_layers, cfg.head_dim
    S, Lt = SERVE_SLOTS, 128
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT) for _ in range(S)]

    def teacher_forced(sched, flush_first):
        """One decode step from the live state through the kernel and through
        its plain version; the state and the launch counts are put back."""
        sched.drain()
        st = sched.state
        counts = {k: w.launches for k, w in wrappers.items()}
        saved = {k: st[k].clone() for k in ("seq_n_codes", "seq_r")}
        row0 = {k: st[k][:, :, :, 0].clone() for k in ("key_residual", "value_residual")}
        if flush_first:  # what the scheduler's next step will do first (and do again: same codes)
            flush_paged_slots(sched.pcfg, st, sched.tables, torch.ones(S, dtype=torch.bool))
        r0 = st["seq_r"].clone()
        n_bound = int(sched.slot_pages.max()) * sched.pcfg.page_size
        logits = []
        for use_kernel in (None, False):
            st["seq_r"].copy_(r0)
            logits.append(paged_decode_step(params, cfg, sched.pcfg, sched.last_token, None, st,
                                            sched.tables, n_bound=n_bound, use_kernel=use_kernel))
        for k, v in saved.items():
            st[k].copy_(v)
        for k, v in row0.items():
            st[k][:, :, :, 0] = v
        for k, w in wrappers.items():
            w.launches = counts[k]
        if not torch.isfinite(logits[0]).all():
            raise RuntimeError("non-finite logits")
        return float((logits[0] - logits[1]).abs().max())

    for geom in PATH_GEOMETRIES:
        g = GEOMETRIES[geom]
        cents = cents_from_numpy(synthetic_cents(L, d, geom), device=dev)
        pcfg = PagedPQCacheConfig(num_layers=L, nh_k=cfg.num_kv_heads, d=d, M=g["M"], C=g["C"], Lt=Lt,
                                  page_size=PAGE_SIZE, n_pages=POOL_PAGES, max_seqs=S,
                                  pages_per_seq=PAGES_PER_SEQ, OK=g["O"], OV=g["O"])
        sched = Scheduler(params, cfg, pcfg, cents, admit_chunk=2048, admit_batch=8, tick_chain=8,
                          device=dev)
        pool_gb = sum(v.numel() * v.element_size() for k, v in sched.state.items() if "pool" in k) / 1e9
        for rid, pr in enumerate(prompts):
            sched.submit(Request(rid, pr, SERVE_NEW_TOKENS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        sched.step()  # admits all six as one group, then the first chain of decode ticks
        torch.cuda.synchronize()
        admit_wall = time.perf_counter() - t0
        admit_ticks = sched.ticks_dispatched
        admitted = sum(r is not None for r in sched.slot_req)
        # steady decode: step() never waits for the device beyond its pipelined token
        # readback, so the wall between steps is the tick time; a stray sync would warn
        ticks, flush_ticks, gaps, n_tok, max_pages, flush_steps = [], [], {}, 0, 0, 0
        sync_warnings = {}
        T0 = time.perf_counter()
        while any(r is not None for r in sched.slot_req):
            will_flush = any(sched.slot_r[i] >= Lt for i, r in enumerate(sched.slot_req) if r is not None)
            if will_flush and "after a flush" not in gaps:
                gaps["after a flush"] = teacher_forced(sched, flush_first=True)
            elif sched.ticks_dispatched >= 64 and "mid-window" not in gaps:
                gaps["mid-window"] = teacher_forced(sched, flush_first=False)
            before = sched.ticks_dispatched
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t1 = time.perf_counter()
                sent = sched.step()
                dt = time.perf_counter() - t1
            torch.cuda.set_sync_debug_mode("default")
            for w in caught:
                key = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"  # where the waiting call was made
                sync_warnings[key] = sync_warnings.get(key, 0) + 1
            k = sched.ticks_dispatched - before
            n_tok += sent
            flush_steps += will_flush
            max_pages = max(max_pages, int(sched.slot_pages.max()))
            (flush_ticks if will_flush else ticks).append(dt / max(k, 1))
        sched.drain()
        torch.cuda.synchronize()
        total = time.perf_counter() - T0
        for k, w in wrappers.items():
            launches[k][geom]["serving"] = w.launches
        peak = torch.cuda.max_memory_allocated() / 1e9
        stats = sched.stats()
        done = {f.rid: f.tokens for f in sched.finished}
        n_chunks = -(-SERVE_PROMPT // 512)  # six slots halve the 2048-token chunk twice
        got = {k: launches[k][geom]["serving"] for k in wrappers}
        want = {"pq_decode_attention": 0, "pq_chunk_attention": L * (n_chunks - 1),
                "pq_encode": 2 * L * n_chunks + 2 * flush_steps,
                "pq_paged_attention": L * sched.ticks_dispatched, "causal_attention": L * n_chunks}
        tokens_ok = set(done) == set(range(S)) and all(
            len(t) == SERVE_NEW_TOKENS and ((0 <= t) & (t < cfg.vocab_size)).all() for t in done.values())
        per_tok = np.asarray(ticks) * 1e3
        log(f"[serving] {geom}: admitted {admitted}/{S} x {SERVE_PROMPT}-token prompts in "
            f"{admit_wall:.3f} s (with the first {admit_ticks} decode ticks); per-token tick p50 "
            f"{np.percentile(per_tok, 50):.3f} ms p90 {np.percentile(per_tok, 90):.3f} ms over "
            f"{len(ticks)} steps of up to 8 chained ticks (host clock, un-synced steps); flush steps "
            f"{[round(x * 1e3, 3) for x in flush_ticks]} ms per token; {n_tok / total:.1f} tok/s over "
            f"{n_tok} tokens in {total:.3f} s (the two teacher-forced checks included); decode ticks "
            f"dispatched {sched.ticks_dispatched} (needed {SERVE_NEW_TOKENS - 1}); launches={got} "
            f"(want {want}); peak mem {peak:.2f} GB (pools {pool_gb:.2f} GB); preemptions "
            f"{sched.preemptions}; most pages per slot {max_pages}; page-table errors "
            f"{stats['page_table_errors']}, pages in use at the end {stats['pages_used']}; "
            f"sync warnings inside step(): {sync_warnings or 'none'}")
        log(f"[teacher] {geom} serving: max |logit(kernel) - logit(plain)| of one paged decode step "
            f"{ {k: '%.4g' % v for k, v in gaps.items()} } (tol {LOGIT_TOL})")
        if (got != want or not tokens_ok or admitted != S or sched.preemptions or max_pages != PAGES_PER_SEQ
                or flush_steps < 2 or stats["pages_used"] or set(gaps) != {"after a flush", "mid-window"}
                or max(gaps.values()) > LOGIT_TOL):
            raise RuntimeError(f"serving path check failed for {geom}")
        del sched
        torch.cuda.empty_cache()


def build_model(dev):
    """llama-3.2-3b at full width and depth, random bf16 weights from seed 0."""
    import torch

    from million_tpu_torch.models import llama

    cfg = llama.PRESETS["llama-3.2-3b"]
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for v in params["layers"].values()) + params["embed"].numel()
    log(f"[model] llama-3.2-3b random bf16 weights: {n_par / 1e9:.3f} B params, "
        f"init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def path_wrappers():
    """name -> the wrapper whose `launches` counts that kernel's launches."""
    from million_tpu_torch.ops.causal_attention_kernel import causal_partial
    from million_tpu_torch.ops.pq_attention_kernel import pq_codes_attention_stacked
    from million_tpu_torch.ops.pq_chunk_attention_kernel import pq_chunk_attention
    from million_tpu_torch.ops.pq_encode_kernel import pq_encode_fused_stacked
    from million_tpu_torch.ops.pq_paged_attention_kernel import pq_paged_attention_stacked

    return {"pq_decode_attention": pq_codes_attention_stacked,
            "pq_chunk_attention": pq_chunk_attention, "pq_encode": pq_encode_fused_stacked,
            "pq_paged_attention": pq_paged_attention_stacked, "causal_attention": causal_partial}


def main_path(dev, cfg, params, launches):
    """generate() at full llama-3.2-3b width through the kernels: the flat
    path, then the chunked-prefill path. Adds the launches of every kernel
    on both paths to `launches`: {kernel: {geometry: {path: n}}}."""
    import torch

    from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
    from million_tpu_torch.cache.pq_cache import PQCacheConfig, cache_memory_bytes, init_state
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models import llama
    from million_tpu_torch.models.chunked_prefill import _prefill_one_chunk
    from million_tpu_torch.runtime.generate import generate

    wrappers = path_wrappers()
    L, d = cfg.num_layers, cfg.head_dim
    ids = torch.randint(0, cfg.vocab_size, (BS, PROMPT), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    n_chunks = -(-PROMPT // CHUNK)

    def drive(geom, path, cache, cents, **kw):
        """One path run with every count set to 0 just before and read just after."""
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9  # weights, cache, ids
        for w in wrappers.values():
            w.launches = 0
        res, cache = generate(params, cfg, ids, cache, cents, mode="pq_kernel", device=dev, **kw)
        for k, w in wrappers.items():
            launches[k][geom][path] = w.launches
        peak = torch.cuda.max_memory_allocated() / 1e9
        return res, f"{peak:.2f} GB ({peak - held:.2f} GB over the {held:.2f} GB held before)"

    def tokens_ok(res, n_new):
        return res.tokens.shape == (BS, n_new) and bool(
            ((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all())

    ttft = {}
    for geom in PATH_GEOMETRIES:
        g = GEOMETRIES[geom]
        cents = cents_from_numpy(synthetic_cents(L, d, geom), device=dev)
        pqc = PQCacheConfig(bs=BS, nh_k=cfg.num_kv_heads, d=d, M=g["M"], C=g["C"], Lt=128,
                            N_max=N_MAX, OK=g["O"], OV=g["O"])
        cache = init_state(pqc, L, device=dev)
        res, peak = drive(geom, "flat", cache, cents, max_new_tokens=NEW_TOKENS, flush_chunk=FLUSH)
        got = {k: launches[k][geom]["flat"] for k in wrappers}
        want = {"pq_decode_attention": L * (NEW_TOKENS - 1), "pq_chunk_attention": 0,
                "pq_encode": 2 * L + 2 * res.n_flushes, "pq_paged_attention": 0, "causal_attention": 0}
        log(f"[generate] {geom} flat: TTFT {res.ttft_s:.3f} s, TPOT {res.tpot_s * 1e3:.3f} ms, "
            f"{BS / res.tpot_s:.1f} tok/s (bs={BS}), flushes={res.n_flushes}, "
            f"launches={got} (want {want}), peak mem {peak}, cache "
            f"{cache_memory_bytes(pqc, L)['total'] / 1e9:.2f} GB")
        if got != want or res.n_flushes < 2 or not tokens_ok(res, NEW_TOKENS):
            raise RuntimeError(f"flat path check failed for {geom}")
        ttft[(geom, "flat")] = res.ttft_s
        # teacher-forced steps against the oracle mode, one just after a flush
        tok = torch.from_numpy(res.tokens[:, -1]).to(dev)
        pos, gaps, after_flush = PROMPT + NEW_TOKENS - 1, [], []
        for _ in range(4):
            flushed = cache["r"] >= cache["key_residual"].shape[3]
            if flushed:
                llama.flush_windows(cache, cents, n=FLUSH)
            ref = llama.decode_step(params, cfg, tok, pos, cache, cents, mode="pq")
            cache["r"] -= 1  # the kernel step rewrites the same residual row
            ker = llama.decode_step(params, cfg, tok, pos, cache, cents, mode="pq_kernel")
            gap = float((ker - ref).abs().max())
            if not torch.isfinite(ker).all():
                raise RuntimeError("non-finite logits")
            gaps.append(gap)
            after_flush.append(flushed)
            tok, pos = ker.argmax(-1), pos + 1
        log(f"[teacher] {geom}: max |logit(pq_kernel) - logit(pq)| per step "
            f"{['%.4g' % x for x in gaps]} (after flush: {after_flush}; tol {LOGIT_TOL})")
        if max(gaps) > LOGIT_TOL or not any(after_flush):
            raise RuntimeError(f"teacher-forced check failed for {geom}")

        # the chunked path on a fresh cache
        del cache
        torch.cuda.empty_cache()
        cache = init_state(pqc, L, device=dev)
        res, peak_c = drive(geom, "chunked", cache, cents, max_new_tokens=CHUNK_NEW_TOKENS,
                            prefill_chunk=CHUNK)
        got = {k: launches[k][geom]["chunked"] for k in wrappers}
        want = {"pq_decode_attention": L * (CHUNK_NEW_TOKENS - 1),
                "pq_chunk_attention": L * (n_chunks - 1),
                "pq_encode": 2 * L * n_chunks + 2 * res.n_flushes, "pq_paged_attention": 0,
                "causal_attention": L * n_chunks}
        counters = (cache["n_codes"], cache["r"])
        log(f"[generate] {geom} chunked (prefill_chunk={CHUNK}, {n_chunks} chunks): TTFT "
            f"{res.ttft_s:.3f} s (flat {ttft[(geom, 'flat')]:.3f} s), TPOT {res.tpot_s * 1e3:.3f} ms, "
            f"launches={got} (want {want}), n_codes/r={counters}, peak mem {peak_c}; "
            f"flat: {peak}")
        if got != want or counters != (PROMPT, CHUNK_NEW_TOKENS - 1) or not tokens_ok(res, CHUNK_NEW_TOKENS):
            raise RuntimeError(f"chunked path check failed for {geom}")
        ttft[(geom, "chunked")] = res.ttft_s
        # the last chunk again over the same history, kernel route vs plain route
        s_last = (n_chunks - 1) * CHUNK
        logits = []
        for use_kernel in (True, False):
            cache["n_codes"], cache["r"] = s_last, 0
            logits.append(_prefill_one_chunk(params, cfg, ids[:, s_last:], cache, cents, s_last,
                                             last_chunk=True, hist_block=1024, use_kernel=use_kernel))
        gap = float((logits[0] - logits[1]).abs().max())
        finite = bool(torch.isfinite(logits[0]).all())
        log(f"[chunked] {geom}: last-chunk logits, kernel partials vs plain partials on the card: "
            f"max gap {gap:.4g} (tol {LOGIT_TOL}), finite {finite}, shape {tuple(logits[0].shape)}")
        if gap > LOGIT_TOL or not finite or logits[0].shape != (BS, cfg.vocab_size):
            raise RuntimeError(f"chunked last-chunk check failed for {geom}")
        del cache, logits
        torch.cuda.empty_cache()
    dcache = init_dense_state(DenseCacheConfig(bs=BS, nh_k=cfg.num_kv_heads, d=d, N_max=N_MAX), L, device=dev)
    torch.cuda.reset_peak_memory_stats()
    dres, _ = generate(params, cfg, ids, dcache, None, mode="dense", max_new_tokens=33, device=dev)
    log(f"[generate] dense bf16 KV: TTFT {dres.ttft_s:.3f} s, TPOT {dres.tpot_s * 1e3:.3f} ms, "
        f"{BS / dres.tpot_s:.1f} tok/s (bs={BS}), peak mem {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from million_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: million_tpu_torch not importable ({e}); run from the repo root",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        builds = list(pool.map(cuda_build.build, KERNELS))
    for built in builds:
        usage = [ln.strip() for ln in built.log.splitlines() if "registers" in ln]
        warned = [ln.strip() for ln in built.log.splitlines() if "warning" in ln.lower()]
        log(f"[build] {built.path.name}: nvcc {built.build_s:.2f} s; ptxas: "
            f"{' | '.join(usage[-4:]) if built.log else 'cached'}"
            f"{'; warnings: ' + ' | '.join(warned) if warned else ''}")
    log(f"[build] {len(builds)} libraries in {time.perf_counter() - t0:.2f} s wall")

    # the paths run a bf16 model, whose partials take the tensor-core versions
    causal = causal_phase(dev)
    rows = {"pq_decode_attention": {g: r for (g, e), r in kernel_phase(dev).items() if e == "stacked"},
            "pq_paged_attention": paged_phase(dev),
            "pq_encode": encode_phase(dev),
            "pq_chunk_attention": {g: r for (g, shape, pr), r in chunk_phase(dev).items()
                                   if shape == "chunk" and pr == "bf16"},
            "causal_attention": {g: causal["chunk"] for g in PATH_GEOMETRIES}}
    c4_phase(dev)
    if "--kernels-only" in sys.argv[1:]:
        return 0
    tiny_check(dev)
    tiny_serving_check(dev)
    cfg, params = build_model(dev)
    c1_phase(dev, cfg, params)
    launches = {k: {g: {} for g in PATH_GEOMETRIES} for k in KERNELS}
    main_path(dev, cfg, params, launches)
    serving_path(dev, cfg, params, launches)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        for geom in PATH_GEOMETRIES:
            r = rows[name][geom]
            kernels.append({
                "name": f"{name}[{geom}]", "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(launches[name][geom].values()), "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            })
    if any(k["launches"] <= 0 for k in kernels):
        raise RuntimeError("a kernel of the main path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

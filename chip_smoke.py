#!/usr/bin/env python3
"""Smoke run of million_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # the whole run
    python3 chip_smoke.py --kernels-only  # phases 1-4 (and fault C.9's kernels), no result line
    python3 chip_smoke.py --pipeline-only # the build, then the pipeline phase alone, no result line
    python3 chip_smoke.py --c9-only       # the build, then fault C.9's phases alone, no result line
    python3 chip_smoke.py --sessions-only # the build, then the long-context, mixed-serving and
                                          # checkpoint phases alone, no result line
    python3 chip_smoke.py --wide-only     # the build, then fault C.10's wide phase alone, no result line

Phases, each printed as it ends; any failure exits non-zero and prints no
result line:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the five CUDA sources of million_tpu_torch/csrc with nvcc,
     one nvcc each, started together, and of the native trainer's pqlib.cpp
     with g++ beside them;
  3. every kernel against its plain PyTorch version on the card at the main
     paths' shapes (llama-3.2-3b: G=3, d=128, 8 KV heads, batch 4), with its
     time, its bound and the plain version's time:
     - pq_decode_attention over a 32K arena holding 32768-512 codes, a bf16
       residual window with 97 live rows merged in, in the three geometries
       and through the single-layer entry; dense bf16 SDPA over the same
       length is printed as a yardstick;
     - pq_encode at the prefill shape (1.024 M rows, "fast"), at the chunked
       path's shapes (a 4096-token chunk and the last one of 3,328), at the
       serving admission's (6 slots x 8 x 512 rows) and at the flush shape
       (28 banks of 4 x 8 x 16 rows) in dm2 and dm4_outlier_c128, each timed
       beside its bound and the plain version but the short chunk, and on
       integer-valued inputs; the torch baddbmm + argmin encode beside it at
       the prefill, chunk and admission shapes;
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
     llama-3.2-3b, each against the plain route; and fault C.9, subspaces
     wider than 8: B1, B4, B7 and B3 (its route) at d_m = 16 (M = 8: C = 256
     pure PQ, and C = 128 with 16 + 16 exact channels) against their plain
     versions at the main paths' shapes, timed beside their bounds, then the
     generic width d_m = 32 the same way, then every geometry of the target
     set (d 64 / 128, d_m 1 / 2 ... 128, C 128 / 256, 0 / 16 exact channels)
     at a small shape;
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
     - fault C.9's paths at M = 8 (d_m = 16, C = 256): a flat generate (bs 1,
       a 4,096-token prompt, 160 new tokens, F = 16 flushes) with four
       teacher-forced steps against the plain oracle, a chunked generate (2
       chunks of 2,048) and a Scheduler (two 4,000-token requests), each with
       its launch counts;
     - long context (benchmarks/long_context_bench.py): decode TPOT p10 / p50
       / p90 at 131,072 tokens, bs 1, over 5 chains of 12 steps, for the
       dense bf16 cache (15.0 GB), dm2 and dm4_outlier_c128, and dm2's
       chunked-prefill TTFT of 130,560 tokens, peak memory of each;
     - mixed-length serving (serving_bench's default mode): 16 requests from
       4 prompt buckets of 128-1,024 tokens, 64 new tokens, 8 slots of
       512-token pages, dm2 and dm4_outlier_c128, its JSON row;
     - session checkpoints (runtime/checkpoint.py): two 8,192-token requests
       saved after admission and 8 steps (a window flush pending), dropped,
       loaded and finished, greedy and sampled, token streams against an
       uninterrupted run's, with the snapshot's bytes and the save and load
       walls;
     - the quality path, on the pinned lm_l_v1 (d=64, 6 layers, 8 / 4 heads,
       f32) over a held-out byte stream that is the same on every machine
       (its sha256 printed): K/V sampled from 16 dense windows of 1,024
       tokens, codebooks trained by the port's k-means (25 Lloyd steps, each
       assignment through the encode kernel), distorted-prefill perplexity
       over 32 windows of 1,024 tokens (each PQ prefill encodes through the
       kernel), dense and four rungs, one JSON line each; the encode
       kernel's launches of the rungs against the count they imply; one
       layer and side trained from one init with the kernel and with the
       plain assignment (inertia), the dm2 perplexity through the plain
       encode, the native library's encode against the kernel's;
     - the pipeline (`million_tpu_torch.cli.main`, llama-3.2-3b at full
       width, random weights, artifacts in a temporary directory): baseline,
       sampling, training and evaluation at dm2 (65,536 sample rows a layer
       and side, M=64, C=256) and at dm4o128 (32,768 rows, M=32, C=128,
       16 + 16 exact channels), the speedtest at 1,024 / 4,096 / 32,000
       prompt tokens and 64 new tokens, dense and PQ; the evaluation with OPQ
       (random orthogonal rotations); the perplexity kind on
       tests/fixtures/realtext.txt (2 windows of 2,048, distorted prefill)
       with the dm2 run's trained tables; the stage walls, the sample bytes,
       the training time per layer and side, the TTFT / TPOT rows, the tables
       each evaluation loaded and the launch counts (B7 in every Lloyd step
       and prefill, B1 in every decode step); at each geometry, layer 0 K's
       Lloyd steps from one init with the kernel and with its plain version
       (final inertias within 1e-4); one teacher-forced decode with the
       trained dm2 tables and one with the rotations, kernel against the
       plain oracle;
     - fault C.10's wide phase (codebooks wider than 256, int16 codes): B7's
       wide build against its plain version at the prefill shape for dm2 at
       C = 512, 1024 and 4096 and M = 32 at C = 4096 (agreement, MSE,
       integer inputs; timed beside its bound, the plain version and torch's
       baddbmm + argmin), at the flush shape and at d_m 1, 8, 16 and 32 on a
       small shape; the Lloyd steps kernel against plain at M = 64, C = 1024
       (262,144 rows) and M = 32, C = 4096, with the k-means++ init's time;
       llama-3.2-3b at dm2, C = 1024: a flat generate (bs 1, 4,096-token
       prompt, 64 new tokens, Lt = 32, F = 16 flushes) on the plain attention
       route an int16 arena takes, teacher-forced against an all-plain run,
       and a chunked one (2 x 2,048, the plain history); the ladder's wide
       rungs (dm2 at nbits 9-12, M = d/4 at nbits 8-12) on lm_l_v1, each
       rung's Lloyd steps and prefill encodes also held against the plain
       version at their own shapes, and quality_bench at its defaults; the
       pipeline at pq.nbits=10 with its own Lloyd steps held the same way;
  6. a JSON line of the kernels (with [dm16] entries: fault C.9's d_m = 16
     builds, timed in its kernel phase and launched by its paths, and
     pq_encode[wide_*] entries: B7's wide build, launched by the wide
     phase's drives), then the card line, then the result line.
It needs no network and starts no process but nvidia-smi and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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
# a "fast" encode rounds x and the centroids to bf16 and sums in f32, where bf16 products are exact:
# bf16 work, bounded at the tensor cores' peak; an "exact" one (the Lloyd assignment) is f32 work
FAST_ENCODE_OPS_PER_S = BF16_OPS_PER_S
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
# fault C.9: subspaces of 16 dims (M = 8 at d = 128) through the kernels' d_m = 16 builds, at the
# main paths' shapes; and one generic width (d_m = 32: the decode passes' value pass in two slices
# of 16, the generic encode kernel)
C9_GEOMETRIES = {
    "dm16": dict(M=8, C=256, O=0),
    "dm16_outlier_c128": dict(M=8, C=128, O=16),
}
C9_GENERIC = {"dm32": dict(M=4, C=256, O=0)}
# fault C.10: codebooks wider than 256 (int16 codes) through B7's wide build, at the prefill shape;
# the model paths run dm2 at C = 1024 (nbits 10)
WIDE_GEOMETRIES = {
    "wide_dm2_c512": dict(M=64, C=512, O=0),
    "wide_dm2_c1024": dict(M=64, C=1024, O=0),
    "wide_dm2_c4096": dict(M=64, C=4096, O=0),
    "wide_dm4_c4096": dict(M=32, C=4096, O=0),
}
ALL_GEOMETRIES = {**GEOMETRIES, **C9_GEOMETRIES, **C9_GENERIC, **WIDE_GEOMETRIES}
C9_PROMPT, C9_NEW_TOKENS = 4096, 160  # the d_m = 16 flat generate: bs = 1, window flushes
# the target-set sweep's B3 limits at its short history (1,000 tokens, so a weight is larger than at
# the phases' 28,672): those of the repo's small-shape kernel tests, tests/test_torch_chunk_attention.py
C9_SWEEP_B3_TOL = {"f32": 1e-4, "bf16": 2e-3}
LC_CTX, LC_ITERS, LC_REPEATS = 131072, 12, 5  # the long-context phase: 128K tokens, 5 chains of 12 steps
CKPT_PROMPT, CKPT_NEW_TOKENS = 8192, 144  # the checkpoint phase: a flush pending at the save
# the quality path: quality_ladder.FROZEN_* (lm_l_v1 on the frozen held-out stream, its four rungs);
# the bars on Δppl / dense ppl, from the TPU ladder's numbers on other text (docs/PERF.md:557-567);
# d_m=8 (+7.2 % on the TPU) takes the C=128 bar
Q_BARS = {"dm2": 0.010, "dm4+16/16 C=256": 0.015, "dm4+16/16 C=128": 0.020, "dm8+16/16 C=128": 0.020}
# million_tpu's own ladder on the same stream and protocol, on the CPU (tools/quality_reference_jax.py,
# seeds 0-4): dense ppl, and per rung the mean of its five seeds' Δppl. On this held-out text every
# rung's Δppl is negative, d_m=8 included.
Q_REF_DENSE = 10.564006884673065
Q_REF_DPPL = {"dm2": -0.03896570282897329, "dm4+16/16 C=256": -0.08918014370455615,
              "dm4+16/16 C=128": -0.12919014823891892, "dm8+16/16 C=128": -0.10502037799128913}
# standard deviation of a rung's Δppl over five k-means seeds: the port's on an H100
# (`quality_ladder --frozen --seeds 5`), million_tpu's on the CPU (the same five seeds as above)
Q_SEED_STD = {"dm2": (0.0033115, 0.0069476), "dm4+16/16 C=256": (0.0090909, 0.0093985),
              "dm4+16/16 C=128": (0.0124599, 0.0133480), "dm8+16/16 C=128": (0.0255013, 0.0391606)}
# the port's dense ppl against the reference's: same weights and text, f32 both (an H100 measured
# 4.5e-7). The port's Δppl (seed 0) against the reference's five-seed mean: the two packages draw
# different k-means++ inits, so 4 standard deviations of that difference, and no less than
# max(0.01, 25 % of the reference's Δppl)
Q_DENSE_RTOL = 1e-4
Q_REF_DPPL_TOL = {n: max(0.01, 0.25 * abs(Q_REF_DPPL[n]), 4 * (sp**2 + sj**2 / 5) ** 0.5)
                  for n, (sp, sj) in Q_SEED_STD.items()}
# the pipeline phase: million_tpu_torch.cli at full llama-3.2-3b width, in a temporary directory
PIPE_LENGTHS, PIPE_DECODE = [1024, 4096, 32000], 64  # speedtest prefill lengths, decode tokens
PIPE_TEXT = ROOT / "tests" / "fixtures" / "realtext.txt"  # the perplexity kind's text
# name, geometry of the launch counts, config under configs/, stages and overrides, and the tables
# its evaluation must load: its own training's, `_synthetic` (load_cents's random tables), or those
# of an earlier run (copied into the artifact directory of this run's dataset)
PIPE_RUNS = (
    ("dm2", "dm2", "llama-3.2-3b.json", ["-p", "baseline", "sampling", "training", "evaluation"], "own"),
    ("dm4o128", "dm4_outlier_c128", "llama-3.2-3b-dm4o128.json",
     ["-p", "baseline", "sampling", "training", "evaluation"], "own"),
    ("dm2 OPQ", "dm2", "llama-3.2-3b.json", ["-p", "evaluation", "-o", "pq.opq=true"], "_synthetic"),
    ("dm2 perplexity", "dm2", "llama-3.2-3b.json",
     ["-p", "evaluation", "-o", f"run.dataset={PIPE_TEXT}", "-o", "run.max_length=2048",
      "-o", "run.max_windows=2"], "dm2"),
)
PIPE_BUDGET = {"dm2": (65536, (28, 64, 256, 2)), "dm4o128": (32768, (28, 32, 128, 4))}  # rows a layer, npz
PIPE_CHECK_PROMPT = 4096  # prompt of the teacher-forced checks
# kernel against plain version on the quality path: the final inertia of one layer and side trained
# from one k-means++ init (near-ties may split the other way, index_add_ sums in another order), and
# the dm2 perplexity with the prefill encode through the plain version ("fast" ties may flip)
Q_INERTIA_RTOL, Q_PPL_RTOL = 1e-4, 1e-3


# the wide phase: B7's wide build at d_m 1, 8, 16 and 32 on a small shape (C = 1024); the Lloyd steps
# kernel against plain at (M, C, rows): the nbits 10 budget 256 x 2^10 and M = 32 at C = 4096; the
# flat generate (bs 1, Lt = 32, so that 64 new tokens cross two F = 16 flushes) and the chunked one
WIDE_SMALL_DM, WIDE_SMALL_C = (1, 8, 16, 32), 1024
WIDE_LLOYD = ((64, 1024, 262144), (32, 4096, 262144))
WIDE_PATH_GEOM, WIDE_PROMPT, WIDE_NEW_TOKENS, WIDE_LT, WIDE_CHUNK = "wide_dm2_c1024", 4096, 64, 32, 2048
# the wide rungs of quality_ladder.FROZEN_WIDE_RUNGS: the entry of the kernels line each rung's
# encodes count towards (rungs of other widths and sizes are not listed there)
WIDE_RUNG_ENTRY = {"dm2 C=512": "wide_dm2_c512", "dm2 C=1024": "wide_dm2_c1024",
                   "dm2 C=4096": "wide_dm2_c4096", "dm4 C=4096": "wide_dm4_c4096"}
# the wide rungs' bar on Δppl / dense ppl: wider codebooks may not do worse than the dm2 C = 256
# rung's bar
Q_WIDE_BAR = 0.010
# million_tpu's own wide rungs on the same stream and protocol, on the CPU
# (tools/quality_reference_jax.py --rungs NAME --seed S; nbits 11-12 split by layer and side with
# --parts): per rung the Δppl of each seed that ran. A wide rung's k-means costs about C / 256 times
# the 8-bit dm2 rung's, hours of CPU a seed at nbits 11 and 12, where seed 0 alone ran
Q_WIDE_REF = {
    "dm2 C=512": [-0.023019237416464833, -0.027059026863613056, -0.01658915027112684],
    "dm2 C=1024": [-0.011980957209669185],
    "dm2 C=2048": [-0.006690738311769806],
    "dm2 C=4096": [-0.007787460234036203],
    "dm4 C=256": [-0.05356002165979845, -0.0844550768027954, -0.07122085768944686, -0.07340234593114303,
                  -0.10590151752088062],
    "dm4 C=512": [-0.09290445201832576, -0.08214971767066359, -0.08811147075616255],
    "dm4 C=1024": [-0.08384169787369622, -0.08812498685680303],
    "dm4 C=2048": [-0.07506163203545135],
    "dm4 C=4096": [-0.0665310006605182],
}
# standard deviation of a wide rung's Δppl over five k-means seeds, the port's on an H100 80GB
# HBM3 at 700 W (`quality_ladder --frozen --wide --seeds 5`)
Q_WIDE_SEED_STD = {
    "dm2 C=512": 0.0071417, "dm2 C=1024": 0.0023569, "dm2 C=2048": 0.0027310, "dm2 C=4096": 0.0043680,
    "dm4 C=256": 0.0104686, "dm4 C=512": 0.0117497, "dm4 C=1024": 0.0090678, "dm4 C=2048": 0.0130498,
    "dm4 C=4096": 0.0098896,
}
# the pipeline at nbits 10 (C = 1024): the sample budget cut from 256 x 2^10 to 65,536 rows a layer
# and side, as the dm2 run's
WIDE_PIPE_ROWS = 65536


def wide_ref_tol(rung: str):
    """(reference Δppl, tolerance) of a wide rung, or None without a
    reference run: the mean of million_tpu's seeds, and the rule of the
    8-bit rungs (Q_REF_DPPL_TOL) with million_tpu's seed spread where it ran
    two seeds or more, else the port's own spread in its place."""
    runs = Q_WIDE_REF.get(rung)
    if not runs:
        return None
    ref = sum(runs) / len(runs)
    sp = Q_WIDE_SEED_STD[rung]
    if len(runs) > 1:
        sj = (sum((r - ref) ** 2 for r in runs) / (len(runs) - 1)) ** 0.5
    else:
        sj = sp
    return ref, max(0.01, 0.25 * abs(ref), 4 * (sp**2 + sj**2 / len(runs)) ** 0.5)


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

    g = ALL_GEOMETRIES[geom]
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


def kernel_phase(dev, geoms=GEOMETRIES, single=("dm4_outlier_c128",)):
    """Kernel vs plain version at the main-path shape, per geometry (and the
    single-layer entry at the geometries of `single`)."""
    import torch
    import torch.nn.functional as F

    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.ops import pq_attention_kernel as K

    nh_k, G, d, L, layer = 8, 3, 128, 2, 1
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    cases = [(g, "stacked") for g in geoms] + [(g, "single-layer") for g in single if g in geoms]
    for geom, entry in cases:
        M, C, O = (geoms[geom][k] for k in ("M", "C", "O"))
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
        flops = K.decode_flops(BS, nh_k, G, d, N_CODES + RESIDUAL_ROWS, O, OV=O, M=M, M_v=M, C=C, C_v=C)
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


def encode_compare(got, want, x, cents_s, what):
    """B7's codes against its plain version's on the same inputs: the share of
    equal codes (>= ENCODE_AGREE) and the reconstruction MSE (within
    ENCODE_MSE_RTOL); raises otherwise. Returns the share that differs."""
    import torch

    from million_tpu_torch.pq.ops import pq_decode

    d = x.shape[-1]
    agree = float((got == want).float().mean())
    mses = []
    for codes in (got, want):
        err = torch.zeros((), device=x.device)
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


def encode_phase(dev, geoms=PATH_GEOMETRIES):
    """pq_encode vs its plain version at the prefill, chunk, admission and
    flush shapes ("fast", so bounded at FAST_ENCODE_OPS_PER_S)."""
    import torch

    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.ops import pq_encode_kernel as E
    from million_tpu_torch.pq.ops import pq_encode_chunked

    nh_k, d, L = 8, 128, 28
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = {}
    compare = encode_compare

    for geom in geoms:
        M, C = ALL_GEOMETRIES[geom]["M"], ALL_GEOMETRIES[geom]["C"]
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
        cb = got.element_size()  # 1 B a code, 2 B in int16 above C = 256
        miss = compare(got[None], plain()[None], x[None], cents[:1], f"{geom} prefill shape "
                       f"({n_rows} rows x d={d} bf16, {got.dtype} codes)")
        ms, plain_ms, lib_ms = cuda_ms(kern, 20), cuda_ms(plain, 2, warm=1), cuda_ms(library, 2, warm=1)
        nbytes, ops = E.encode_bytes(n_rows, d, M, 2, cb), E.encode_ops(n_rows, M, C, d // M)
        bound_ms, bound_by = bound_of(nbytes, ops, FAST_ENCODE_OPS_PER_S)
        log(f"[kernel] pq_encode {geom} prefill shape: kernel={ms:.4f} ms bound={bound_ms:.4f} ms "
            f"({bound_by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop at the bf16 tensor-core peak; f32 rate: "
            f"{ops / F32_OPS_PER_S * 1e3:.3f} ms) plain={plain_ms:.3f} ms "
            f"torch baddbmm+argmin (pq_encode_chunked)={lib_ms:.3f} ms")
        rows[geom] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=miss, library_ms=lib_ms)
        # the shapes the chunked path gives it (a whole chunk and the last, shorter one) and
        # the serving admission's (a 512-token chunk of six slots, models/paged_decode.py), each
        # the (bs, heads, n, d) view of that chunk's own projection; the whole chunk and the
        # admission chunk timed
        for what, bs, n in (("chunk", BS, CHUNK), ("chunk", BS, PROMPT % CHUNK),
                            ("admission", SERVE_SLOTS, ADMIT_CHUNK)):
            xc = torch.randn((bs, n, nh_k, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
            compare(E.pq_encode_fused(xc, cents[0], "strided", "fast")[None],
                    E.pq_encode_fused_plain(xc[None], cents[:1], "strided", "fast"), xc[None],
                    cents[:1], f"{geom} {what} shape ({bs} x {nh_k} x {n} rows)")
            if n == PROMPT % CHUNK:
                continue
            rows_c = bs * nh_k * n
            bound_c, by_c = bound_of(E.encode_bytes(rows_c, d, M, 2, cb), E.encode_ops(rows_c, M, C, d // M),
                                     FAST_ENCODE_OPS_PER_S)
            log(f"[kernel] pq_encode {geom} {what} shape: kernel="
                f"{cuda_ms(lambda: E.pq_encode_fused(xc, cents[0], 'strided', 'fast'), 200):.4f} ms "
                f"bound={bound_c:.4f} ms ({by_c}) plain="
                f"{cuda_ms(lambda: E.pq_encode_fused_plain(xc[None], cents[:1], 'strided', 'fast'), 5, warm=1):.3f}"
                f" ms torch baddbmm+argmin="
                f"{cuda_ms(lambda: pq_encode_chunked(xc, cents[0], 'strided', precision='fast'), 5, warm=1):.3f} ms")
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
        rows_f = L * BS * nh_k * FLUSH
        bound_f, by_f = bound_of(E.encode_bytes(rows_f, d, M, 2, cb), E.encode_ops(rows_f, M, C, d // M),
                                 FAST_ENCODE_OPS_PER_S)
        log(f"[kernel] pq_encode {geom} flush shape: kernel={cuda_ms(kern_f, 200):.4f} ms "
            f"bound={bound_f:.4f} ms ({by_f}) plain={cuda_ms(plain_f, 10):.4f} ms")
        del x, got, window
        torch.cuda.empty_cache()
    return rows


def chunk_phase(dev, geoms=GEOMETRIES, f32_geoms=PATH_GEOMETRIES):
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
        M, C, O = (geoms[geom][k] for k in ("M", "C", "O"))
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
    for geom in geoms:
        M, C, O = (geoms[geom][k] for k in ("M", "C", "O"))
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
              ("f32", "bf16") if geom in f32_geoms else ("bf16",))
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


def paged_phase(dev, geoms=GEOMETRIES):
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
    for geom in geoms:
        M, C, O = (geoms[geom][k] for k in ("M", "C", "O"))
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
        flops = P.paged_flops([n + RESIDUAL_ROWS for n in full], nh_k, G, d, O, OV=O, M=M, M_v=M, C=C, C_v=C)
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


def lloyd_pair(x, M: int, C: int, iters: int):
    """One layer and side's codebooks trained twice from one k-means++ init
    along train_pq's route (the large-n step above kmeans.LARGE_N): every
    assignment through the encode kernel, then through its plain version.
    Both final inertias are taken through the plain version. -> (relative
    gap, {use_kernel: inertia}, {use_kernel: seconds}, xs, init)."""
    import torch

    from million_tpu_torch.pq import kmeans
    from million_tpu_torch.pq.ops import subspace_view

    xs = subspace_view(x.float(), M, "strided").contiguous()
    init = kmeans._kmeanspp_init(xs, C, torch.Generator(device=x.device).manual_seed(0))
    n, chunk = xs.shape[0], kmeans.large_n_chunk(M, C)
    large = {"chunk_n": chunk, "xs_sub": xs[::max(n // kmeans.SUB_CAP, 1)][:kmeans.SUB_CAP]}
    kw = large if n * C * M > kmeans.LARGE_N else {}
    inertia, secs = {}, {}
    for use_kernel in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = kmeans.lloyd(xs, init, iters, use_kernel=use_kernel, **kw)
        torch.cuda.synchronize()
        secs[use_kernel] = time.perf_counter() - t0
        inertia[use_kernel] = float(kmeans._inertia_large(xs, c, chunk, use_kernel=False).sum())
    return abs(inertia[True] - inertia[False]) / inertia[False], inertia, secs, xs, init


def quality_path(dev, launches, card):
    """The quality ladder on lm_l_v1 at full width (d=64, 6 layers, 8 / 4 heads,
    f32): K/V sampled from its dense prefill, codebooks trained with the port's
    k-means (every Lloyd assignment through the encode kernel), distorted-
    prefill perplexity (every PQ prefill encodes through the kernel), dense
    first, then the four rungs of quality_ladder.FROZEN_RUNGS, each against
    its bar and against million_tpu's numbers on the same stream (Q_REF_*).
    Then the kernel against its plain version: one layer and side of dm2 trained twice
    from one init, and the dm2 perplexity again through the plain encode; and
    the native trainer's encode against the kernel's. B7's launches of the
    rungs go into launches["pq_encode"]["quality"]."""
    import hashlib

    import numpy as np
    import torch

    from million_tpu_torch import native
    from million_tpu_torch.benchmarks import quality_ladder as ql
    from million_tpu_torch.benchmarks.tiny_lm import build_corpus_frozen, checkpoint_path_l, load_checkpoint
    from million_tpu_torch.ops.pq_encode_kernel import encode_bytes, encode_ops, pq_encode_fused_stacked
    from million_tpu_torch.pq import kmeans

    t_phase = time.perf_counter()
    params, cfg = load_checkpoint(checkpoint_path_l(), device=dev)
    tokens = build_corpus_frozen()
    sha = hashlib.sha256(tokens.astype(np.uint8).tobytes()).hexdigest()
    sample, eval_tokens = ql.frozen_split(tokens)
    ctx, n_eval, iters = ql.FROZEN_CTX, ql.FROZEN_EVAL_WINDOWS, ql.FROZEN_ITERS
    log(f"[quality] lm_l_v1: d={cfg.head_dim}, {cfg.num_layers} layers, {cfg.num_heads} / "
        f"{cfg.num_kv_heads} heads, hidden {cfg.hidden_size}, {cfg.dtype}; stream {len(tokens)} bytes, "
        f"sha256 {sha}; sample {len(sample)} head tokens, eval {len(eval_tokens)} tail tokens")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    pq_encode_fused_stacked.launches = 0
    (kv_k, kv_v), sample_s = timed(lambda: ql.sample_kv(params, cfg, sample, windows=ql.FROZEN_SAMPLE_WINDOWS,
                                                          ctx=ctx, bs=8))
    dense, dense_s = timed(lambda: ql.dense_perplexity(params, cfg, eval_tokens, max_length=ctx,
                                                         max_windows=n_eval))
    log(f"[quality] samples {kv_k.shape} f16 a side in {sample_s:.2f} s; dense ppl {dense['ppl']!r} "
        f"({dense['windows']} windows, {dense_s:.2f} s)")
    if not abs(dense["ppl"] - Q_REF_DENSE) <= Q_DENSE_RTOL * Q_REF_DENSE:
        raise RuntimeError(f"dense perplexity {dense['ppl']!r} is not the reference's {Q_REF_DENSE!r}")
    rows, tables, want_launches = {}, {}, 0
    L, n_rows = cfg.num_layers, kv_k.shape[1]
    for name, geom in ql.FROZEN_RUNGS.items():
        cents, train_s = timed(lambda: ql.rung_cents(cfg, kv_k, kv_v, train_iters=iters, device=dev, **geom))
        r, eval_s = timed(lambda: ql.rung_perplexity(params, cfg, eval_tokens, cents, max_length=ctx,
                                                     max_windows=n_eval))
        for side in ("key", "value"):  # Lloyd steps per layer and side: 2 launches on the large-n path
            M, C, _ = cents[side].shape[1:]
            n = min(n_rows, 256 * C)
            want_launches += L * iters * (2 if n * C * M > kmeans.LARGE_N else 1)
        want_launches += n_eval * L * 2  # one encode a layer and side in every prefill
        dppl = r["ppl"] - dense["ppl"]
        rows[name] = {"rung": name, **geom, "ppl": r["ppl"], "dppl": dppl, "rel": dppl / dense["ppl"],
                      "bar": Q_BARS[name], "ref_dppl": Q_REF_DPPL[name], "ref_tol": Q_REF_DPPL_TOL[name],
                      "train_s": train_s, "eval_s": eval_s, "card": card}
        tables[name] = cents
        print(json.dumps(rows[name]), flush=True)
    launches["pq_encode"]["quality"] = pq_encode_fused_stacked.launches
    log(f"[quality] launches {json.dumps({'pq_encode': pq_encode_fused_stacked.launches})} "
        f"(want {want_launches}: Lloyd assignments and prefill encodes)")
    failed = [f"{n} above its bar" for n, row in rows.items() if row["rel"] > row["bar"]]
    failed += [f"{n} off the reference" for n, row in rows.items()
               if abs(row["dppl"] - row["ref_dppl"]) > row["ref_tol"]]
    if launches["pq_encode"]["quality"] != want_launches or failed:
        raise RuntimeError(f"quality path check failed: {failed or 'launch count'}")

    # kernel against plain version: one layer and side of dm2 from one k-means++ init
    gap, inertia, lloyd_s, xs, init = lloyd_pair(torch.as_tensor(kv_k[0], device=dev), 32, 256, iters)
    log(f"[quality] dm2 layer 0 K, {iters} Lloyd steps from one init: inertia kernel {inertia[True]!r}, "
        f"plain {inertia[False]!r}, rel gap {gap:.3g} (tol {Q_INERTIA_RTOL}); {lloyd_s[True]:.3f} s vs "
        f"{lloyd_s[False]:.3f} s")
    # one assignment at the Lloyd shape, kernel against plain version
    M, C, d_m = init.shape
    ms = cuda_ms(lambda: kmeans.assign(xs, init), 20)
    plain_ms = cuda_ms(lambda: kmeans._assign(xs, init, kmeans.large_n_chunk(M, C)), 3, warm=1)
    nbytes, ops = encode_bytes(xs.shape[0], M * d_m, M, 4), encode_ops(xs.shape[0], M, C, d_m)
    bound_ms, bound_by = bound_of(nbytes, ops, F32_OPS_PER_S)
    log(f"[quality] Lloyd assignment ({xs.shape[0]} rows, M={M}, C={C}, d_m={d_m}, exact): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    plain = ql.rung_perplexity(params, cfg, eval_tokens, tables["dm2"], max_length=ctx,
                               max_windows=n_eval, use_kernel=False)
    ppl_gap = abs(plain["ppl"] - rows["dm2"]["ppl"]) / plain["ppl"]
    log(f"[quality] dm2 ppl, prefill encode through the plain version: {plain['ppl']!r} against the kernel's "
        f"{rows['dm2']['ppl']!r}: rel gap {ppl_gap:.3g} (tol {Q_PPL_RTOL})")
    # the native trainer's library, built beside the kernels: its encode against the kernel's
    xk = kv_k[0].astype(np.float32)
    cents0 = tables["dm2"]["key"][0]
    agree = float((torch.from_numpy(native.encode_native(xk, cents0.cpu().numpy(), "strided")).to(dev)
                   == kmeans.assign(xs, cents0)).float().mean())
    log(f"[quality] native encode (host threads) against the kernel, dm2 layer 0 K: {agree:.6f} equal codes")
    if gap > Q_INERTIA_RTOL or ppl_gap > Q_PPL_RTOL or agree < ENCODE_AGREE:
        raise RuntimeError("quality path: kernel against plain version failed")
    log(f"[quality] phase wall {time.perf_counter() - t_phase:.2f} s on {card}")


def pipeline_path(dev, launches, card):
    """The pipeline CLI (`million_tpu_torch.cli.main`, as `python -m
    million_tpu_torch.cli` runs it) at full llama-3.2-3b width, artifacts and
    results in one temporary directory: all four stages at dm2 and at the
    dm4o128 geometry (speedtest at PIPE_LENGTHS, PIPE_DECODE new tokens),
    then the evaluation stage with OPQ (load_cents's random orthogonal
    rotations) and the perplexity kind on PIPE_TEXT with the dm2 run's
    trained tables (copied into that dataset's artifact directory). Every
    count is set to 0 before a run and read after it
    (launches[k][geometry]["pipeline"]). Checks: the sample rows a layer,
    the artifact's shapes, the Lloyd steps at each geometry's shapes (layer
    0 K of the run's own samples) kernel against plain version, the tables
    each evaluation row names, finite TTFT / TPOT rows without an OOM
    entry, B7 and B1 launched; then one teacher-forced decode with the
    trained dm2 tables and one with the rotations, kernel against the plain
    oracle."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from million_tpu_torch import cli
    from million_tpu_torch.runtime.generate import generate
    from million_tpu_torch.pq.ops import zero_channels
    from million_tpu_torch.utils.config import load_config
    from million_tpu_torch.utils.fvecs import reservoir_sample_fvecs
    from million_tpu_torch.utils.ledger import read_results

    wrappers = path_wrappers()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_") as tmp:
        common = ["-o", f"run.artifacts={tmp}/artifacts", "-o", f"run.results={tmp}/results_torch.jsonl",
                  "-o", f"run.prefill_lengths={json.dumps(PIPE_LENGTHS)}", "-o", f"run.decode_length={PIPE_DECODE}"]
        trained = {}  # run name -> its artifact
        for name, geom, config, args, tables in PIPE_RUNS:
            if tables in trained:  # that run's tables, where this run's dataset looks for them
                src = Path(trained[tables])
                want_cents = src.parent.parent / PIPE_TEXT.name / src.name
                want_cents.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(src, want_cents)
            else:
                want_cents = tables
            n_rows = len(read_results(f"{tmp}/results_torch.jsonl"))
            torch.cuda.reset_peak_memory_stats()
            for w in wrappers.values():
                w.launches = 0
            out = cli.main(["-f", str(ROOT / "configs" / config), *args, *common])
            for k, w in wrappers.items():
                launches[k][geom]["pipeline"] = launches[k][geom].get("pipeline", 0) + w.launches
            got = {k: w.launches for k, w in wrappers.items()}
            walls = {s: round(wall, 2) for s, (_, wall) in out.items()}
            log(f"[pipeline] {name}: stage walls {walls} s, launches {got}, peak mem "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            if got["pq_encode"] <= 0 or ("perplexity" not in name and got["pq_decode_attention"] <= 0):
                raise RuntimeError(f"pipeline {name}: B7 / B1 not launched: {got}")
            if "sampling" in out:
                budget, shape = PIPE_BUDGET[name]
                res = out["sampling"][0]
                tr = out["training"][0]
                L, d = shape[0], shape[1] * shape[3]
                sizes = {f.name: os.path.getsize(f) for f in Path(tr["path"]).parent.glob("layer*.fvecs")}
                want = budget * (d + 1) * 4
                log(f"[pipeline] {name}: sampling {res['rows_per_layer']} rows a layer and side from "
                    f"{res['windows']} windows, {res['bytes']} B of fvecs ({len(sizes)} files)")
                if res["rows_per_layer"] != budget or len(sizes) != 2 * L or set(sizes.values()) != {want}:
                    raise RuntimeError(f"pipeline {name}: sample files {res} / sizes {set(sizes.values())}")
                secs = np.asarray(tr["seconds_per_layer_side"])
                log(f"[pipeline] {name}: training {tr['samples']} samples a layer and side, s per layer: "
                    f"K mean {secs[:, 0].mean():.3f} (min {secs[:, 0].min():.3f}, max {secs[:, 0].max():.3f}), "
                    f"V mean {secs[:, 1].mean():.3f} (min {secs[:, 1].min():.3f}, max {secs[:, 1].max():.3f})")
                with np.load(tr["path"]) as z:
                    arrays = {k: z[k] for k in z.files}
                ok = all(arrays[k].shape == shape and np.isfinite(arrays[k]).all() for k in ("key", "value"))
                exact = json.loads((ROOT / "configs" / config).read_text()).get("pq", {}).get("outlier_k", 0)
                if exact:
                    ok = ok and all(arrays[k].shape == (L, exact) and arrays[k].dtype == np.int32
                                    for k in ("k_outlier_idx", "v_outlier_idx"))
                log(f"[pipeline] {name}: artifact {Path(tr['path']).name}: "
                    f"{ {k: v.shape for k, v in arrays.items()} }")
                if not ok:
                    raise RuntimeError(f"pipeline {name}: artifact shapes or values wrong")
                trained[name] = want_cents = tr["path"]
                # the Lloyd steps at this geometry, kernel against plain version: layer 0 K as the
                # training stage read it (its exact channels zeroed)
                xk = torch.from_numpy(reservoir_sample_fvecs(Path(tr["path"]).parent / "layer0.key.fvecs",
                                                             budget, seed=0)).to(dev)
                if exact:
                    xk = zero_channels(xk, torch.as_tensor(arrays["k_outlier_idx"][0], device=dev))
                iters = load_config([str(ROOT / "configs" / config)], [], base=cli.DEFAULTS).pq.train_iters
                gap, inertia, secs, _, _ = lloyd_pair(xk, shape[1], shape[2], iters)
                log(f"[pipeline] {name} layer 0 K ({budget} rows, M={shape[1]}, C={shape[2]}, d_m={shape[3]}), "
                    f"{iters} Lloyd steps from one init: inertia kernel {inertia[True]!r}, plain "
                    f"{inertia[False]!r}, rel gap {gap:.3g} (tol {Q_INERTIA_RTOL}); {secs[True]:.3f} s vs "
                    f"{secs[False]:.3f} s")
                if not gap <= Q_INERTIA_RTOL:
                    raise RuntimeError(f"pipeline {name}: Lloyd steps, kernel against plain version failed")
                del xk
            for row in read_results(f"{tmp}/results_torch.jsonl")[n_rows:]:
                if row["stage"] == "evaluation":
                    log(f"[pipeline] {name}: evaluation tables {row['centroids']}")
                    if row["centroids"] != str(want_cents):
                        raise RuntimeError(f"pipeline {name}: evaluation ran on {row['centroids']}, "
                                           f"not {want_cents}")
                res = row["result"]
                if "ppl" in res:
                    log(f"[pipeline] {name}: {row['stage']} ({row['mode']}) perplexity {res['ppl']!r} over "
                        f"{res['windows']} windows ({card})")
                    if not np.isfinite(res["ppl"]):
                        raise RuntimeError(f"pipeline {name}: perplexity not finite")
                    continue
                for r in res["results"]:
                    bad = "oom" in r or not (np.isfinite(r["ttft_s"]) and np.isfinite(r["tpot_s"]))
                    log(f"[speedtest] {name} {row['stage']} {row['mode']}: prefill {r['prefill_length']}: "
                        f"TTFT {r.get('ttft_s', float('nan')):.4f} s, TPOT {r.get('tpot_s', float('nan')) * 1e3:.3f} "
                        f"ms ({card})")
                    if bad:
                        raise RuntimeError(f"pipeline {name}: bad speedtest row {r}")

        # teacher-forced decode steps, kernel against the plain oracle: the trained dm2 tables, the rotations
        cfg = load_config([str(ROOT / "configs" / "llama-3.2-3b.json")],
                          [f"run.artifacts={tmp}/artifacts"], base=cli.DEFAULTS)
        mcfg, params = cli.build_model(cfg, device=dev)
        ids = torch.randint(0, mcfg.vocab_size, (1, PIPE_CHECK_PROMPT), generator=torch.Generator(device=dev).manual_seed(2),
                            device=dev)
        for what, c in (("trained dm2", cfg), ("OPQ", load_config([], ["pq.opq=true"], base=cfg.to_dict()))):
            if cli.cents_path(c, mcfg).exists() != (what == "trained dm2"):
                raise RuntimeError(f"pipeline teacher-forced check ({what}): unexpected artifact state")
            tables = cli.load_cents(c, mcfg, device=dev)
            res, _ = generate(params, mcfg, ids, cli.make_pq_cache_factory(c, mcfg, device=dev)(), tables,
                              mode="pq_kernel", max_new_tokens=5, selfcheck_every=1, device=dev)
            log(f"[pipeline] {what} tables: teacher-forced max |logit(pq_kernel) - logit(pq)| over 4 steps "
                f"{res.selfcheck_max_diff:.4g} (tol {LOGIT_TOL}); rotations {'Rk' in tables}")
            if not res.selfcheck_max_diff <= LOGIT_TOL or ("Rk" in tables) != (what == "OPQ"):
                raise RuntimeError(f"pipeline teacher-forced check failed ({what})")
        del params
    torch.cuda.empty_cache()
    log(f"[pipeline] phase wall {time.perf_counter() - t_phase:.2f} s on {card}")


def c9_sweep(dev):
    """Every geometry of fault C.9's target set at a small shape, kernel (the
    route each wrapper picks) against its plain version: d in {64, 128}, every
    M that divides d (d_m 2 ... d for the decode kernels and B3, 1 ... d for
    the encode), C in {128, 256}, 0 or 16 exact channels a side. Integer-
    valued encode inputs, so the codes must be bit-equal."""
    import torch

    from million_tpu_torch.ops import pq_attention_kernel as K
    from million_tpu_torch.ops import pq_chunk_attention_kernel as B3
    from million_tpu_torch.ops import pq_encode_kernel as E
    from million_tpu_torch.ops import pq_paged_attention_kernel as P

    gen = torch.Generator(device=dev).manual_seed(23)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nh_k, G, Lt, N, n_codes, ps = 2, 3, 128, 1024, 1000, 256
    worst = {"B1": 0.0, "B4": 0.0, "B3": 0.0}
    routes = {"B1/B4": set(), "B7": set(), "B3": set()}
    count = 0

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def codes(C, *shape):
        return torch.randint(0, C, shape, generator=gen, device=dev, dtype=torch.uint8)

    def err(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    for d in (64, 128):
        for dm in (1, 2, 4, 8, 16, 32, 64, 128):
            if dm > d:
                continue
            M = d // dm
            for C in (128, 256):
                # B7: integer-valued x and codebooks, strided ("fast") and contiguous ("exact")
                xi = torch.randint(-4, 5, (2, 512, d), generator=gen, device=dev).float()
                ci = torch.randint(-4, 5, (M, C, dm), generator=gen, device=dev).float()
                for layout, precision, x in (("strided", "fast", xi.bfloat16()), ("contiguous", "exact", xi)):
                    same = bool((E.pq_encode_fused(x, ci, layout, precision)
                                 == E.pq_encode_fused_plain(x[None], ci[None], layout, precision)[0]).all())
                    if not same:
                        raise RuntimeError(f"C.9 sweep: pq_encode d={d} d_m={dm} C={C} {layout} differs")
                routes["B7"].add(f"d_m={dm}: {E.encode_route(dm, C)}")
                if dm == 1:
                    continue
                for O in (0, 16):
                    count += 1
                    cents = [randn(1, M, C, dm) for _ in range(2)]
                    idx = [torch.randperm(d, generator=torch.Generator().manual_seed(s))[:O].sort().values
                           for s in (d + dm + C, d + dm + C + 1)]
                    for c, ix in zip(cents, idx):  # exact channels have zero centroid components
                        for ch in ix.tolist():
                            c[0, ch % M, :, ch // M] = 0.0
                    ocw = dict(k_oidx=idx[0][None].to(torch.int32).to(dev),
                               v_oidx=idx[1][None].to(torch.int32).to(dev)) if O else {}
                    routes["B1/B4"].add(K.decode_route(d, M, M, C, C, G, O, O).name)
                    # B1: one sequence over a flat arena, a bf16 residual window with 7 live rows
                    q = randn(1, nh_k, G, d) / d**0.5
                    kc, vc = codes(C, 1, 1, nh_k, N, M), codes(C, 1, 1, nh_k, N, M)
                    fkw = dict(ocw, k_residual=randn(1, 1, nh_k, Lt, d, dtype=torch.bfloat16),
                               v_residual=randn(1, 1, nh_k, Lt, d, dtype=torch.bfloat16), r=7)
                    if O:
                        fkw.update(k_outliers=randn(1, 1, nh_k, N, O, dtype=torch.bfloat16),
                                   v_outliers=randn(1, 1, nh_k, N, O, dtype=torch.bfloat16))
                    a = (q, kc, vc, cents[0], cents[1], 0, n_codes)
                    worst["B1"] = max(worst["B1"], err(K.pq_codes_attention_stacked(*a, **fkw),
                                                       K.pq_codes_attention_plain(*a, **fkw, n_sm=n_sm)))
                    # B4: two slots of 256-token pages, ragged lengths
                    qp = randn(2, nh_k, G, d) / d**0.5
                    kp, vp = codes(C, 1, 9, nh_k, ps, M), codes(C, 1, 9, nh_k, ps, M)
                    table = torch.randperm(8, generator=torch.Generator().manual_seed(dm)).reshape(2, 4)
                    table[1, 2:] = -1
                    pkw = dict(ocw, k_residual=randn(1, 2, nh_k, Lt, d, dtype=torch.bfloat16),
                               v_residual=randn(1, 2, nh_k, Lt, d, dtype=torch.bfloat16),
                               r=torch.tensor([7, 0], dtype=torch.int32, device=dev))
                    if O:
                        pkw.update(k_outliers=randn(1, 9, nh_k, ps, O, dtype=torch.bfloat16),
                                   v_outliers=randn(1, 9, nh_k, ps, O, dtype=torch.bfloat16))
                    a = (qp, kp, vp, cents[0], cents[1], 0, table.to(torch.int32).to(dev),
                         torch.tensor([1000, 300], dtype=torch.int32, device=dev))
                    worst["B4"] = max(worst["B4"], err(P.pq_paged_attention_stacked(*a, **pkw),
                                                       P.pq_paged_attention_plain(*a, **pkw, n_sm=n_sm)))
                    # B3: a 64-token chunk of a bf16 model over the flat arena, B3's route
                    qc = randn(1, nh_k * G, 64, d, dtype=torch.bfloat16)
                    hkw = {}
                    if O:
                        hkw = dict(koidx=ocw["k_oidx"][0], voidx=ocw["v_oidx"][0], k_outliers=fkw["k_outliers"][0],
                                   v_outliers=fkw["v_outliers"][0])
                    pr = B3.history_precision(qc, vc[0], hkw.get("k_outliers"), hkw.get("v_outliers"), kc[0])
                    routes["B3"].add(f"d_m={dm} O={O}: {pr}")
                    qr = B3.group_rows(qc, nh_k, 1.0 / d**0.5).contiguous()
                    a = (qr, kc[0], vc[0], cents[0][0], cents[1][0], n_codes)
                    got = B3.pq_chunk_attention(*a, precision=pr, **hkw)
                    want = B3.pq_chunk_attention_plain(*a, precision=pr, **hkw)
                    e3 = (float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
                    if max(e3) > C9_SWEEP_B3_TOL[pr]:
                        raise RuntimeError(f"C.9 sweep: pq_chunk_attention d={d} d_m={dm} C={C} O={O} {pr}: {e3}")
                    worst["B3"] = max(worst["B3"], max(e3))
                    if max(worst["B1"], worst["B4"]) > KERNEL_TOL:
                        raise RuntimeError(f"C.9 sweep: decode kernels d={d} d_m={dm} C={C} O={O}: {worst}")
    torch.cuda.synchronize()
    log(f"[c9] target set: {count} decode geometries (d 64 / 128, d_m 2-128, C 128 / 256, 0 / 16 exact), "
        f"every encode width 1-128 at C 128 / 256: B1 max err {worst['B1']:.3g}, B4 {worst['B4']:.3g} "
        f"(tol {KERNEL_TOL}), B3 {worst['B3']:.3g} (tol {C9_SWEEP_B3_TOL}), B7 bit-equal on integer inputs; "
        f"decode builds {sorted(routes['B1/B4'])}; encode {sorted(routes['B7'])}; B3 {sorted(routes['B3'])}")


def c9_kernels(dev):
    """Fault C.9 repaired, kernels: B1, B4, B7 and B3 (its route) at d_m = 16
    (M = 8 at d = 128, pure PQ at C = 256 and 16 + 16 exact channels at C =
    128) against their plain versions at the main paths' shapes, timed beside
    their bounds; then the generic width (d_m = 32) the same way; then the
    whole target set at a small shape. Returns the d_m = 16 rows of each
    kernel, as the kernels line takes them."""
    from million_tpu_torch.ops import pq_attention_kernel as K
    from million_tpu_torch.ops import pq_chunk_attention_kernel as B3
    from million_tpu_torch.ops import pq_encode_kernel as E

    for name, g in {**C9_GEOMETRIES, **C9_GENERIC}.items():
        route = K.decode_route(128, g["M"], g["M"], g["C"], g["C"], 3, g["O"], g["O"])
        log(f"[c9] {name} (M={g['M']}, d_m={128 // g['M']}, C={g['C']}, {g['O']} + {g['O']} exact): "
            f"decode passes {route.name}, encode {E.encode_route(128 // g['M'], g['C'])}, B3 "
            f"{'bf16' if B3.mma_geometry(128, g['M'], g['O'], g['O'], g['M']) else 'f32'} for a bf16 model")
    rows = {"pq_decode_attention": {g: r for (g, e), r in kernel_phase(dev, C9_GEOMETRIES, ("dm16",)).items()
                                    if e == "stacked"},
            "pq_paged_attention": paged_phase(dev, C9_GEOMETRIES),
            "pq_encode": encode_phase(dev, tuple(C9_GEOMETRIES)),
            "pq_chunk_attention": {g: r for (g, shape, pr), r in chunk_phase(dev, C9_GEOMETRIES, ()).items()
                                   if shape == "chunk"}}
    log("[c9] the generic width:")
    kernel_phase(dev, C9_GENERIC, ())
    paged_phase(dev, C9_GENERIC)
    encode_phase(dev, tuple(C9_GENERIC))
    chunk_phase(dev, C9_GENERIC, ())
    c9_sweep(dev)
    return rows


def c9_paths(dev, cfg, params, launches):
    """Fault C.9 repaired, paths: llama-3.2-3b at full width with M = 8
    (d_m = 16, C = 256) through generate() (flat: bs 1, a 4,096-token prompt,
    160 new tokens with F = 16 sub-window flushes, then four teacher-forced
    steps against the plain oracle, one just after a flush; chunked: the same
    prompt in chunks of 2,048, 17 new tokens) and a Scheduler (two 4,000-token
    requests, one group admission, 40 new tokens each). Each drive sets the
    launch counts to 0 just before and reads them just after, into
    `launches[kernel][path]`."""
    import numpy as np
    import torch

    from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models import llama
    from million_tpu_torch.runtime.generate import generate
    from million_tpu_torch.runtime.scheduler import Request, Scheduler

    wrappers = path_wrappers()
    L, d, nh_k = cfg.num_layers, cfg.head_dim, cfg.num_kv_heads
    g = C9_GEOMETRIES["dm16"]
    cents = cents_from_numpy(synthetic_cents(L, d, "dm16", seed=21), device=dev)
    ids = torch.randint(0, cfg.vocab_size, (1, C9_PROMPT), generator=torch.Generator(device=dev).manual_seed(22),
                        device=dev)
    pqc = PQCacheConfig(bs=1, nh_k=nh_k, d=d, M=g["M"], C=g["C"], Lt=128, N_max=2 * C9_PROMPT)

    def drive(path, fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        for k, w in wrappers.items():
            launches[k][path] = w.launches
        return out

    cache = init_state(pqc, L, device=dev)
    res, cache = drive("flat", lambda: generate(params, cfg, ids, cache, cents, mode="pq_kernel", device=dev,
                                                max_new_tokens=C9_NEW_TOKENS, flush_chunk=FLUSH))
    got = {k: launches[k]["flat"] for k in wrappers}
    want = {"pq_decode_attention": L * (C9_NEW_TOKENS - 1), "pq_chunk_attention": 0,
            "pq_encode": 2 * L + 2 * res.n_flushes, "pq_paged_attention": 0, "causal_attention": 0}
    in_vocab = bool(((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all())
    log(f"[c9] dm16 flat generate (bs 1, {C9_PROMPT}-token prompt): TTFT {res.ttft_s:.3f} s, TPOT "
        f"{res.tpot_s * 1e3:.3f} ms, flushes {res.n_flushes}, launches {got} (want {want})")
    if got != want or res.n_flushes < 1 or res.tokens.shape != (1, C9_NEW_TOKENS) or not in_vocab:
        raise RuntimeError("C.9: the d_m = 16 flat generate check failed")
    tok = torch.from_numpy(res.tokens[:, -1]).to(dev)
    pos, gaps, after_flush = C9_PROMPT + C9_NEW_TOKENS - 1, [], []
    for _ in range(4):
        flushed = cache["r"] >= cache["key_residual"].shape[3]
        if flushed:
            llama.flush_windows(cache, cents, n=FLUSH)
        ref = llama.decode_step(params, cfg, tok, pos, cache, cents, mode="pq")
        cache["r"] -= 1  # the kernel step rewrites the same residual row
        ker = llama.decode_step(params, cfg, tok, pos, cache, cents, mode="pq_kernel")
        if not torch.isfinite(ker).all():
            raise RuntimeError("C.9: non-finite logits")
        gaps.append(float((ker - ref).abs().max()))
        after_flush.append(flushed)
        tok, pos = ker.argmax(-1), pos + 1
    log(f"[c9] dm16 teacher-forced: max |logit(pq_kernel) - logit(pq)| per step {['%.4g' % x for x in gaps]} "
        f"(after flush: {after_flush}; tol {LOGIT_TOL})")
    if max(gaps) > LOGIT_TOL or not any(after_flush):
        raise RuntimeError("C.9: the d_m = 16 teacher-forced check failed")
    del cache
    cache = init_state(pqc, L, device=dev)
    res, cache = drive("chunked", lambda: generate(params, cfg, ids, cache, cents, mode="pq_kernel", device=dev,
                                                   max_new_tokens=CHUNK_NEW_TOKENS, prefill_chunk=2048))
    got = {k: launches[k]["chunked"] for k in wrappers}
    want = {"pq_decode_attention": L * (CHUNK_NEW_TOKENS - 1), "pq_chunk_attention": L,
            "pq_encode": 4 * L, "pq_paged_attention": 0, "causal_attention": 2 * L}
    log(f"[c9] dm16 chunked generate (2 chunks of 2,048): TTFT {res.ttft_s:.3f} s, launches {got} (want {want})")
    if got != want or (cache["n_codes"], cache["r"]) != (C9_PROMPT, CHUNK_NEW_TOKENS - 1):
        raise RuntimeError("C.9: the d_m = 16 chunked generate check failed")
    del cache
    torch.cuda.empty_cache()
    pcfg = PagedPQCacheConfig(num_layers=L, nh_k=nh_k, d=d, M=g["M"], C=g["C"], Lt=128, page_size=2048,
                              n_pages=8, max_seqs=2, pages_per_seq=4, dtype=cfg.dtype)
    sched = Scheduler(params, cfg, pcfg, cents, device=dev)
    rng = np.random.default_rng(24)
    for rid in range(2):
        sched.submit(Request(rid, rng.integers(0, cfg.vocab_size, 4000), 40))
    done = drive("serving", lambda: sched.run_to_completion())
    got = {k: launches[k]["serving"] for k in wrappers}
    ok = (len(done) == 2 and all(len(f.tokens) == 40 for f in done)
          and got["pq_paged_attention"] == L * sched.ticks_dispatched and got["pq_chunk_attention"] > 0
          and got["pq_encode"] > 0)
    log(f"[c9] dm16 serving (2 x 4,000-token requests, 40 new tokens): {sched.ticks_dispatched} ticks, "
        f"launches {got}; {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("C.9: the d_m = 16 serving check failed")
    del sched
    torch.cuda.empty_cache()


def long_context_phase(dev, cfg, params, launches, card):
    """long_context_bench at 131,072 tokens, bs 1, llama-3.2-3b at full width:
    decode TPOT (p10 / p50 / p90 of 5 chains of 12 steps, CUDA events) for
    the dense bf16 cache, dm2 and dm4_outlier_c128, each cache freed before
    the next; dm2 also times a chunked prefill of 130,560 tokens (chunks of
    4,096). Peak memory of each. The PQ runs' launches go to `launches`."""
    from million_tpu_torch.benchmarks import long_context_bench as LCB

    wrappers = path_wrappers()
    rows = {}
    for geom in ("dense",) + PATH_GEOMETRIES:
        for w in wrappers.values():
            w.launches = 0
        row = LCB.run_geometry(params, cfg, geom, ctx=LC_CTX, bs=1, iters=LC_ITERS, repeats=LC_REPEATS,
                               ttft_chunk=CHUNK if geom == "dm2" else 0, device=dev)
        got = {k: w.launches for k, w in wrappers.items()}
        steps = 2 + LC_REPEATS * LC_ITERS  # warm-up and the timed chains
        ok = (row["tpot_ms_p10"] <= row["tpot_ms_p50"] <= row["tpot_ms_p90"] and row["tpot_ms_p10"] > 0
              and (geom == "dense" or got["pq_decode_attention"] == cfg.num_layers * steps))
        if geom != "dense":
            for k in wrappers:
                launches[k][geom]["long_context"] = got[k]
        rows[geom] = row
        log(f"[long] {json.dumps({k: v for k, v in row.items() if k != 'tpot_ms_samples'})} "
            f"samples {['%.3f' % x for x in row['tpot_ms_samples']]} launches {got}; {card}; "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"long-context check failed for {geom}")
    return rows


def mixed_phase(dev, cfg, params, launches, card):
    """serving_bench's mixed-length mode with the reference's defaults: 16
    requests from 4 prompt buckets of 128-1,024 tokens, 64 new tokens each, 8
    slots of 512-token pages (32 a slot), dm2 and dm4_outlier_c128; a warm-up
    scheduler, then a timed one ticked explicitly."""
    import argparse

    import numpy as np
    import torch

    from million_tpu_torch.benchmarks import serving_bench as SB
    from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.runtime.scheduler import Scheduler

    wrappers = path_wrappers()
    args = argparse.Namespace(requests=16, min_prompt=128, max_prompt=1024, max_new=64, seed=0,
                              preset="llama-3.2-3b")
    for geom in PATH_GEOMETRIES:
        cents_np, M, C, O = SB.synthetic_cents(cfg.num_layers, cfg.head_dim, geom, np.random.default_rng(0))
        tables = cents_from_numpy(cents_np, device=dev)
        pcfg = PagedPQCacheConfig(num_layers=cfg.num_layers, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M, C=C,
                                  Lt=128, page_size=512, n_pages=8 * 32, max_seqs=8, pages_per_seq=32,
                                  dtype=cfg.dtype, OK=O, OV=O)
        for w in wrappers.values():
            w.launches = 0
        row, sched = SB.mixed(args, cfg, pcfg, lambda: Scheduler(params, cfg, pcfg, tables, device=dev), card)
        got = {k: w.launches for k, w in wrappers.items()}
        for k in wrappers:
            launches[k][geom]["mixed"] = got[k]
        toks_ok = all(len(f.tokens) == args.max_new and ((0 <= f.tokens) & (f.tokens < cfg.vocab_size)).all()
                      for f in sched.finished)
        ok = (len(sched.finished) == args.requests and toks_ok and row["peak_pages_used"] <= row["pool_pages"]
              and got["pq_paged_attention"] > 0 and got["pq_encode"] > 0)
        log(f"[mixed] {geom}: the row above; launches {got} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"mixed serving check failed for {geom}")
        del sched
        torch.cuda.empty_cache()


def checkpoint_phase(dev, cfg, params, launches, card):
    """Session save and resume at full width (dm2): two slots of 8,192-token
    prompts in 2048-token pages, 144 new tokens each, 16 ticks chained a
    step. A session is saved after admission and 8 steps (128 ticks: every
    window full, its flush pending), the scheduler dropped, the session
    loaded and run to the end; its tokens must equal an uninterrupted run's,
    greedy and sampled (temperature 0.8, top-k 20, seed 7)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.runtime.checkpoint import load_session, save_session
    from million_tpu_torch.runtime.sampling import SamplingConfig
    from million_tpu_torch.runtime.scheduler import Request, Scheduler

    wrappers = path_wrappers()
    for w in wrappers.values():
        w.launches = 0
    g = GEOMETRIES["dm2"]
    tables = cents_from_numpy(synthetic_cents(cfg.num_layers, cfg.head_dim, "dm2", seed=25), device=dev)
    pcfg = PagedPQCacheConfig(num_layers=cfg.num_layers, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=g["M"],
                              C=g["C"], Lt=128, page_size=2048, n_pages=10, max_seqs=2, pages_per_seq=5,
                              dtype=cfg.dtype)
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, cfg.vocab_size, CKPT_PROMPT) for _ in range(2)]

    def fresh(sampling):
        s = Scheduler(params, cfg, pcfg, tables, sampling, seed=7, tick_chain=16, device=dev)
        for rid, p in enumerate(prompts):
            s.submit(Request(rid, p, CKPT_NEW_TOKENS))
        return s

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.npz")
        for name, sampling in (("greedy", SamplingConfig()), ("sampled", SamplingConfig(temperature=0.8, top_k=20))):
            ref = fresh(sampling)
            want = {f.rid: f.tokens for f in ref.run_to_completion()}
            del ref
            sched = fresh(sampling)
            for _ in range(8):
                sched.step()
            pending = all(sched.slot_r[i] >= pcfg.Lt for i, r in enumerate(sched.slot_req) if r is not None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_session(path, sched)
            t_save = time.perf_counter() - t0
            del sched
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            resumed = load_session(path, params, cfg, pcfg, tables, sampling, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            got = {f.rid: f.tokens for f in resumed.run_to_completion()}
            same = sorted(got) == sorted(want) == [0, 1] and all(np.array_equal(got[r], want[r]) for r in want)
            nbytes = os.path.getsize(path)
            log(f"[checkpoint] {name}: snapshot {nbytes / 1e9:.3f} GB after 8 steps (flush pending: {pending}), "
                f"save {t_save:.3f} s, load {t_load:.3f} s; resumed tokens equal the uninterrupted run's: {same} "
                f"({[len(t) for t in got.values()]} tokens); {card}")
            if not (same and pending and nbytes < 1e9):
                raise RuntimeError(f"session checkpoint check failed ({name})")
            del resumed
            torch.cuda.empty_cache()
    for k, w in wrappers.items():
        launches[k]["dm2"]["checkpoint"] = w.launches


def wide_kernels(dev, card):
    """Fault C.10 repaired, kernel: B7's wide build (int16 codes) through
    encode_phase at each of WIDE_GEOMETRIES (the prefill, chunk, admission
    and flush shapes, integer inputs; timed beside its bound, the plain
    version and torch's baddbmm + argmin), then at d_m 1, 8, 16 and 32 at
    C = 1024 on a small shape, integer inputs bit-equal in both precisions.
    Returns the kernels line's rows by geometry."""
    import torch

    from million_tpu_torch.ops import pq_encode_kernel as E

    d, nh_k = 128, 8
    routes = {g: E.encode_route(d // w["M"], w["C"]) for g, w in WIDE_GEOMETRIES.items()}
    log(f"[wide] B7 routes {routes} ({card})")
    if set(routes.values()) != {"wide"}:
        raise RuntimeError("a wide geometry does not take the wide build")
    rows = encode_phase(dev, tuple(WIDE_GEOMETRIES))
    gen = torch.Generator(device=dev).manual_seed(31)
    for dm in WIDE_SMALL_DM:  # the other tiled widths and a generic one, on a small shape
        M = d // dm
        xs = torch.randn((2, 700, nh_k, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
        cs = torch.randn((M, WIDE_SMALL_C, dm), generator=gen, device=dev)
        got = E.pq_encode_fused(xs, cs, "strided", "fast")
        if got.dtype != torch.int16:
            raise RuntimeError(f"the wide build wrote {got.dtype} codes")
        encode_compare(got[None], E.pq_encode_fused_plain(xs[None], cs[None], "strided", "fast"), xs[None],
                       cs[None], f"wide d_m={dm} (M={M}, C={WIDE_SMALL_C}) small shape (2 x {nh_k} x 700 rows)")
        xi = torch.randint(-4, 5, (1, 333, d), generator=gen, device=dev).float()
        ci = torch.randint(-4, 5, (1, M, WIDE_SMALL_C, dm), generator=gen, device=dev).float()
        for pr in ("fast", "exact"):
            if not bool((E.pq_encode_fused_stacked(xi, ci, "contiguous", pr)
                         == E.pq_encode_fused_plain(xi, ci, "contiguous", pr)).all()):
                raise RuntimeError(f"pq_encode's wide build differs on integer inputs (d_m={dm}, {pr})")
    log(f"[wide] d_m {WIDE_SMALL_DM} at C={WIDE_SMALL_C}: integer-valued inputs bit-equal ({card})")
    return rows


def wide_lloyd(dev, card):
    """Fault C.10 repaired, k-means: lloyd_pair (25 Lloyd steps from one
    k-means++ init, every assignment through B7's wide build, then through
    its plain version) at each of WIDE_LLOYD on quality_bench's synthetic
    K (d = 128), final inertias within Q_INERTIA_RTOL; the init's time
    beside the Lloyd steps'."""
    import numpy as np
    import torch

    from million_tpu_torch.benchmarks.quality_bench import synth_kv
    from million_tpu_torch.pq import kmeans
    from million_tpu_torch.pq.ops import subspace_view

    for M, C, n in WIDE_LLOYD:
        x = torch.from_numpy(synth_kv(np.random.default_rng(33), n, 128)).to(dev)
        xs = subspace_view(x, M, "strided").contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kmeans._kmeanspp_init(xs, C, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        del xs
        gap, inertia, secs, _, _ = lloyd_pair(x, M, C, 25)
        log(f"[wide] Lloyd M={M}, C={C}, {n} rows (d=128), 25 steps from one init: inertia kernel "
            f"{inertia[True]!r}, plain {inertia[False]!r}, rel gap {gap:.3g} (tol {Q_INERTIA_RTOL}); "
            f"k-means++ init {init_s:.3f} s, Lloyd {secs[True]:.3f} s (kernel) vs {secs[False]:.3f} s "
            f"(plain) ({card})")
        if not gap <= Q_INERTIA_RTOL:
            raise RuntimeError(f"wide Lloyd steps at M={M}, C={C}: kernel against plain version failed")
        del x
    torch.cuda.empty_cache()


def wide_paths(dev, cfg, params, launches, card):
    """Fault C.10 repaired, model: llama-3.2-3b at full width and depth, dm2
    at C = 1024 (int16 arenas, bench.py's synthetic codebooks). Flat
    generate at bs 1 (a 4,096-token prompt, 64 new tokens, Lt = 32 with F =
    16 flushes) through B7 on the card and the plain attention route that
    an int16 arena takes in both packages; then the same tokens teacher-
    forced on two caches, one through B7 and one all-plain, logits within
    LOGIT_TOL. Chunked generate (2 chunks of 2,048, 17 new tokens: the causal
    kernel, B7, the plain history); the last chunk through the kernels
    against the plain partials and against the flat prefill's last logits,
    each within LOGIT_TOL. Launches into launches[kernel][path]."""
    import dataclasses

    import torch

    from million_tpu_torch.cache.pq_cache import PQCacheConfig, cache_memory_bytes, init_state
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models import llama
    from million_tpu_torch.models.chunked_prefill import _prefill_one_chunk
    from million_tpu_torch.runtime.generate import generate

    wrappers = path_wrappers()
    L, d, nh_k = cfg.num_layers, cfg.head_dim, cfg.num_kv_heads
    g = WIDE_GEOMETRIES[WIDE_PATH_GEOM]
    cents = cents_from_numpy(synthetic_cents(L, d, WIDE_PATH_GEOM, seed=34), device=dev)
    ids = torch.randint(0, cfg.vocab_size, (1, WIDE_PROMPT), generator=torch.Generator(device=dev).manual_seed(35),
                        device=dev)
    pqc = PQCacheConfig(bs=1, nh_k=nh_k, d=d, M=g["M"], C=g["C"], Lt=WIDE_LT, N_max=WIDE_PROMPT + 128)

    def drive(path, fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        for k, w in wrappers.items():
            launches[k][path] = w.launches
        return out

    cache = init_state(pqc, L, device=dev)
    route = llama.attention_route(cache["key_codes"].dtype)
    res, cache = drive("flat", lambda: generate(params, cfg, ids, cache, cents, mode="pq_kernel", device=dev,
                                                max_new_tokens=WIDE_NEW_TOKENS, flush_chunk=FLUSH))
    got = {k: launches[k]["flat"] for k in wrappers}
    want = {"pq_decode_attention": 0, "pq_chunk_attention": 0, "pq_encode": 2 * L + 2 * res.n_flushes,
            "pq_paged_attention": 0, "causal_attention": 0}
    narrow = cache_memory_bytes(dataclasses.replace(pqc, C=256), L)["codes"]
    in_vocab = bool(((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all())
    log(f"[wide] dm2 C={g['C']} flat generate (bs 1, {WIDE_PROMPT}-token prompt, Lt={WIDE_LT}, F={FLUSH}): "
        f"attention route {route!r} ({cache['key_codes'].dtype} arena), TTFT {res.ttft_s:.3f} s, TPOT "
        f"{res.tpot_s * 1e3:.3f} ms, flushes {res.n_flushes}, launches {got} (want {want}); code arena "
        f"{cache_memory_bytes(pqc, L)['codes'] / 1e6:.2f} MB (8-bit: {narrow / 1e6:.2f} MB) ({card})")
    if (got != want or route != "pq" or res.n_flushes < 2 or res.tokens.shape != (1, WIDE_NEW_TOKENS)
            or not in_vocab or cache["key_codes"].dtype != torch.int16):
        raise RuntimeError("C.10: the wide flat generate check failed")
    # teacher-forced: the generated tokens through a cache encoded by B7 and an all-plain one
    caches = {True: init_state(pqc, L, device=dev), False: init_state(pqc, L, device=dev)}
    logits = {k: llama.prefill(params, cfg, ids, c, cents, last_logit_only=True, use_kernel=k)[:, -1]
              for k, c in caches.items()}
    gaps, after_flush = [float((logits[True] - logits[False]).abs().max())], [False]
    for i, tok in enumerate(res.tokens[0, :-1]):
        flushed = caches[True]["r"] >= WIDE_LT
        for k, c in caches.items():
            if flushed:
                llama.flush_windows(c, cents, n=FLUSH, use_kernel=k)
            logits[k] = llama.decode_step(params, cfg, torch.tensor([int(tok)], device=dev), WIDE_PROMPT + i, c,
                                          cents, mode="pq_kernel")
        if not torch.isfinite(logits[True]).all():
            raise RuntimeError("C.10: non-finite logits")
        gaps.append(float((logits[True] - logits[False]).abs().max()))
        after_flush.append(flushed)
    log(f"[wide] teacher-forced {len(gaps) - 1} steps, B7 against the all-plain run: max |logit gap| "
        f"{max(gaps):.4g} (tol {LOGIT_TOL}), prefill {gaps[0]:.4g}, steps after a flush "
        f"{sum(after_flush)} ({card})")
    if max(gaps) > LOGIT_TOL or sum(after_flush) < 2:
        raise RuntimeError("C.10: the wide teacher-forced check failed")
    flat_last = llama.prefill(params, cfg, ids, init_state(pqc, L, device=dev), cents, last_logit_only=True)[:, -1]
    del caches, cache
    torch.cuda.empty_cache()
    cache = init_state(pqc, L, device=dev)
    n_chunks = WIDE_PROMPT // WIDE_CHUNK
    res, cache = drive("chunked", lambda: generate(params, cfg, ids, cache, cents, mode="pq_kernel", device=dev,
                                                   max_new_tokens=CHUNK_NEW_TOKENS, prefill_chunk=WIDE_CHUNK))
    got = {k: launches[k]["chunked"] for k in wrappers}
    want = {"pq_decode_attention": 0, "pq_chunk_attention": 0, "pq_encode": 2 * L * n_chunks + 2 * res.n_flushes,
            "pq_paged_attention": 0, "causal_attention": L * n_chunks}
    log(f"[wide] dm2 C={g['C']} chunked generate ({n_chunks} chunks of {WIDE_CHUNK}): TTFT {res.ttft_s:.3f} s, "
        f"TPOT {res.tpot_s * 1e3:.3f} ms, launches {got} (want {want}) ({card})")
    if got != want or (cache["n_codes"], cache["r"]) != (WIDE_PROMPT, CHUNK_NEW_TOKENS - 1):
        raise RuntimeError("C.10: the wide chunked generate check failed")
    s_last = (n_chunks - 1) * WIDE_CHUNK
    last = []
    for use_kernel in (True, False):
        cache["n_codes"], cache["r"] = s_last, 0
        last.append(_prefill_one_chunk(params, cfg, ids[:, s_last:], cache, cents, s_last, last_chunk=True,
                                       hist_block=1024, use_kernel=use_kernel))
    gap = float((last[0] - last[1]).abs().max())
    flat_gap = float((last[0] - flat_last).abs().max())
    log(f"[wide] chunked last chunk, kernels (causal, B7) and the plain history against all-plain partials: "
        f"max gap {gap:.4g}; against the flat prefill's last logits {flat_gap:.4g} (tol {LOGIT_TOL} each) "
        f"({card})")
    if gap > LOGIT_TOL or flat_gap > LOGIT_TOL or not bool(torch.isfinite(last[0]).all()):
        raise RuntimeError("C.10: the wide chunked last-chunk check failed")
    del cache, last
    torch.cuda.empty_cache()


def wide_quality(dev, launches, card):
    """Fault C.10 repaired, quality: the ladder's wide rungs
    (quality_ladder.FROZEN_WIDE_RUNGS: dm2 at nbits 9-12, then the coarse
    sweep M = d/4 at nbits 8-12) on lm_l_v1 over the frozen stream, as the
    quality phase runs its four rungs (B7 in every Lloyd step and prefill),
    each against Q_WIDE_BAR and, where million_tpu ran it, its Δppl
    (wide_ref_tol). After each rung, its own encodes against the plain
    version at their shapes: lloyd_pair on layer 0 K (the sample's rows at
    the rung's M and C; inertias within Q_INERTIA_RTOL), one of those Lloyd
    assignments timed beside its bound and the plain version's, one prefill
    encode at the rung's shape (layer 0 K of a sample window) through
    encode_compare and timed likewise, and the perplexity again through the
    plain prefill encode (within Q_PPL_RTOL).
    Then quality_bench at its defaults, its JSON line. B7's launches of each
    rung (its training and evaluation, not the checks) go to
    launches["pq_encode"][entry]."""
    import numpy as np
    import torch

    from million_tpu_torch.benchmarks import quality_ladder as ql
    from million_tpu_torch.benchmarks import quality_bench
    from million_tpu_torch.benchmarks.tiny_lm import build_corpus_frozen, checkpoint_path_l, load_checkpoint
    from million_tpu_torch.models.llama import SUBSPACE_LAYOUT
    from million_tpu_torch.ops.pq_encode_kernel import (encode_bytes, encode_ops, pq_encode_fused_plain,
                                                        pq_encode_fused_stacked)
    from million_tpu_torch.pq import kmeans
    from million_tpu_torch.pq.ops import RUNTIME_ENCODE_PRECISION

    t_phase = time.perf_counter()
    params, cfg = load_checkpoint(checkpoint_path_l(), device=dev)
    sample, eval_tokens = ql.frozen_split(build_corpus_frozen())
    ctx, n_eval, iters = ql.FROZEN_CTX, ql.FROZEN_EVAL_WINDOWS, ql.FROZEN_ITERS
    nh_k = cfg.num_kv_heads
    kv_k, kv_v = ql.sample_kv(params, cfg, sample, windows=ql.FROZEN_SAMPLE_WINDOWS, ctx=ctx, bs=8)
    dense = ql.dense_perplexity(params, cfg, eval_tokens, max_length=ctx, max_windows=n_eval)["ppl"]
    if not abs(dense - Q_REF_DENSE) <= Q_DENSE_RTOL * Q_REF_DENSE:
        raise RuntimeError(f"dense perplexity {dense!r} is not the reference's {Q_REF_DENSE!r}")
    failed = []
    for name, geom in ql.FROZEN_WIDE_RUNGS.items():
        pq_encode_fused_stacked.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cents = ql.rung_cents(cfg, kv_k, kv_v, train_iters=iters, device=dev, **geom)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ppl = ql.rung_perplexity(params, cfg, eval_tokens, cents, max_length=ctx, max_windows=n_eval)["ppl"]
        torch.cuda.synchronize()
        n_launch = pq_encode_fused_stacked.launches
        if name in WIDE_RUNG_ENTRY:
            launches["pq_encode"][WIDE_RUNG_ENTRY[name]]["quality"] = n_launch
        eval_s = time.perf_counter() - t1
        # the rung's own encodes against the plain version, at the shapes it gave the kernel
        M, C = geom["M_k"], 2 ** geom["nbits_k"]
        gap, _, _, xs, init = lloyd_pair(torch.as_tensor(kv_k[0], device=dev), M, C, iters)
        assign_ms = cuda_ms(lambda: kmeans.assign(xs, init), 20)
        assign_plain_ms = cuda_ms(lambda: kmeans._assign(xs, init, kmeans.large_n_chunk(M, C)), 3, warm=1)
        assign_bound_ms, assign_bound_by = bound_of(encode_bytes(xs.shape[0], cfg.head_dim, M, 4,
                                                                 2 if C > 256 else 1),
                                                    encode_ops(xs.shape[0], M, C, cfg.head_dim // M),
                                                    F32_OPS_PER_S)
        # one prefill encode at the rung's shape: layer 0 K of the first sample window as the dense
        # cache held it, (1, heads, ctx, d), under the rung's layer 0 K table
        xp = torch.as_tensor(kv_k[0][:nh_k * ctx], device=dev).float().reshape(1, nh_k, ctx, cfg.head_dim)
        kp = cents["key"][:1]

        def prefill_kern():
            return pq_encode_fused_stacked(xp[None], kp, SUBSPACE_LAYOUT, RUNTIME_ENCODE_PRECISION)

        def prefill_plain():
            return pq_encode_fused_plain(xp[None], kp, SUBSPACE_LAYOUT, RUNTIME_ENCODE_PRECISION)

        prefill_miss = encode_compare(prefill_kern(), prefill_plain(), xp[None], kp,
                                      f"{name} prefill shape (layer 0 K, 1 x {nh_k} x {ctx} rows, f32)")
        prefill_ms, prefill_plain_ms = cuda_ms(prefill_kern, 20), cuda_ms(prefill_plain, 3, warm=1)
        prefill_bound_ms, prefill_bound_by = bound_of(
            encode_bytes(nh_k * ctx, cfg.head_dim, M, 4, 2 if C > 256 else 1),
            encode_ops(nh_k * ctx, M, C, cfg.head_dim // M), FAST_ENCODE_OPS_PER_S)
        plain_ppl = ql.rung_perplexity(params, cfg, eval_tokens, cents, max_length=ctx, max_windows=n_eval,
                                       use_kernel=False)["ppl"]
        ppl_gap = abs(plain_ppl - ppl) / plain_ppl
        dppl = ppl - dense
        ref = wide_ref_tol(name)
        row = {"rung": name, **geom, "ppl": ppl, "dppl": dppl, "rel": dppl / dense, "bar": Q_WIDE_BAR,
               "ref_dppl": ref and ref[0], "ref_tol": ref and ref[1], "train_s": t1 - t0,
               "eval_s": eval_s, "pq_encode_launches": n_launch, "lloyd_layer0_k_rel_gap": gap,
               "ppl_plain_encode": plain_ppl, "ppl_plain_encode_rel_gap": ppl_gap,
               "lloyd_assign": {"rows": xs.shape[0], "M": M, "C": C, "precision": "exact", "ms": assign_ms,
                                "plain_ms": assign_plain_ms, "bound_ms": assign_bound_ms,
                                "bound_by": assign_bound_by},
               "prefill_encode": {"rows": nh_k * ctx, "M": M, "C": C, "precision": RUNTIME_ENCODE_PRECISION,
                                  "miss": prefill_miss, "ms": prefill_ms, "plain_ms": prefill_plain_ms,
                                  "bound_ms": prefill_bound_ms, "bound_by": prefill_bound_by}, "card": card}
        print(json.dumps(row), flush=True)
        if row["rel"] > Q_WIDE_BAR or n_launch <= 0:
            failed.append(f"{name} above its bar or not through B7")
        if ref and abs(dppl - ref[0]) > ref[1]:
            failed.append(f"{name} off the reference")
        if not (gap <= Q_INERTIA_RTOL and ppl_gap <= Q_PPL_RTOL):
            failed.append(f"{name}: its encodes differ from the plain version's")
        del cents, xs, init, xp
    if failed:
        raise RuntimeError(f"wide quality check failed: {failed}")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = quality_bench.sweep(device=dev)
    print(json.dumps(out), flush=True)
    by = {(r["M"], r["nbits"]): r for r in out["sweep"]}
    d = 64
    ok = all(np.isfinite(r["rel_mse"]) and np.isfinite(r["attn_mae"]) for r in out["sweep"]) \
        and by[(d // 4, 10)]["rel_mse"] < by[(d // 4, 8)]["rel_mse"]
    log(f"[wide] quality_bench (defaults) in {time.perf_counter() - t0:.2f} s: (d/4, 10) rel_mse "
        f"{by[(d // 4, 10)]['rel_mse']} against (d/4, 8) {by[(d // 4, 8)]['rel_mse']} ({card})")
    if not ok:
        raise RuntimeError("quality_bench: non-finite errors, or nbits 10 no better than nbits 8")
    log(f"[wide] quality phase wall {time.perf_counter() - t_phase:.2f} s on {card}")


def wide_pipeline(dev, launches, card):
    """Fault C.10 repaired, pipeline: `cli.main` on llama-3.2-3b at pq.nbits
    = 10 (C = 1024, int16 arenas), all four stages, the sample budget cut to
    WIDE_PIPE_ROWS rows a layer and side (from 256 x 2^10), artifacts in a
    temporary directory. Checks the samples, the artifact's shapes, an
    evaluation row on the plain "pq" route, B7 launched, and the run's Lloyd
    steps (layer 0 K's samples) kernel against plain through lloyd_pair;
    prints the stage walls and the training s per layer and side."""
    import tempfile

    import numpy as np
    import torch

    from million_tpu_torch import cli
    from million_tpu_torch.models import llama
    from million_tpu_torch.utils.config import load_config
    from million_tpu_torch.utils.fvecs import reservoir_sample_fvecs
    from million_tpu_torch.utils.ledger import read_results

    wrappers = path_wrappers()
    config = ROOT / "configs" / "llama-3.2-3b.json"
    c = load_config([str(config)], ["pq.nbits=10"], base=cli.DEFAULTS)
    mcfg = llama.PRESETS[c.model.preset]
    M = cli.pq_m(c, mcfg)
    shape = (mcfg.num_layers, M, 1024, mcfg.head_dim // M)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wide_pipeline_") as tmp:
        for w in wrappers.values():
            w.launches = 0
        out = cli.main(["-f", str(config),
                        "-p", "baseline", "sampling", "training", "evaluation",
                        "-o", "pq.nbits=10", "-o", f"pq.sample_target={WIDE_PIPE_ROWS}",
                        "-o", f"pq.train_samples={WIDE_PIPE_ROWS}",
                        "-o", f"run.artifacts={tmp}/artifacts", "-o", f"run.results={tmp}/results_torch.jsonl",
                        "-o", f"run.prefill_lengths={json.dumps(PIPE_LENGTHS)}",
                        "-o", f"run.decode_length={PIPE_DECODE}"])
        got = {k: w.launches for k, w in wrappers.items()}
        launches["pq_encode"][WIDE_PATH_GEOM]["pipeline"] = got["pq_encode"]
        walls = {s: round(wall, 2) for s, (_, wall) in out.items()}
        tr = out["training"][0]
        secs = np.asarray(tr["seconds_per_layer_side"])
        with np.load(tr["path"]) as z:
            shapes = {k: z[k].shape for k in ("key", "value")}
            finite = all(np.isfinite(z[k]).all() for k in ("key", "value"))
        rows = [r for r in read_results(f"{tmp}/results_torch.jsonl") if r["stage"] == "evaluation"]
        log(f"[wide] pipeline pq.nbits=10: stage walls {walls} s, launches {got}; sampling "
            f"{out['sampling'][0]['rows_per_layer']} rows a layer and side; training s per layer: K mean "
            f"{secs[:, 0].mean():.3f} (max {secs[:, 0].max():.3f}), V mean {secs[:, 1].mean():.3f} "
            f"(max {secs[:, 1].max():.3f}); artifact {shapes}; evaluation route "
            f"{[r.get('attention_route') for r in rows]} ({card})")
        for r in rows[0]["result"]["results"] if rows else []:
            log(f"[speedtest] wide nbits 10 evaluation {rows[0]['mode']} (route {rows[0]['attention_route']}): "
                f"prefill {r['prefill_length']}: TTFT {r.get('ttft_s', float('nan')):.4f} s, TPOT "
                f"{r.get('tpot_s', float('nan')) * 1e3:.3f} ms ({card})")
        ok = (out["sampling"][0]["rows_per_layer"] == WIDE_PIPE_ROWS and finite
              and shapes == {"key": shape, "value": shape}
              and len(rows) == 1 and rows[0].get("attention_route") == "pq" and got["pq_encode"] > 0
              and got["pq_decode_attention"] == 0
              and all("oom" not in r and np.isfinite(r["tpot_s"]) for r in rows[0]["result"]["results"]))
        if not ok:
            raise RuntimeError("C.10: the nbits 10 pipeline check failed")
        # the run's Lloyd steps, kernel against plain version: layer 0 K as the training stage read it
        xk = torch.from_numpy(reservoir_sample_fvecs(Path(tr["path"]).parent / "layer0.key.fvecs",
                                                     WIDE_PIPE_ROWS, seed=0)).to(dev)
        gap, inertia, lloyd_s, _, _ = lloyd_pair(xk, M, 1024, c.pq.train_iters)
        log(f"[wide] pipeline layer 0 K, {c.pq.train_iters} Lloyd steps from one init (M={M}, C=1024, "
            f"{xk.shape[0]} rows): inertia kernel {inertia[True]!r}, plain {inertia[False]!r}, rel gap {gap:.3g} "
            f"(tol {Q_INERTIA_RTOL}); {lloyd_s[True]:.3f} s vs {lloyd_s[False]:.3f} s ({card})")
        if not gap <= Q_INERTIA_RTOL:
            raise RuntimeError("C.10: the nbits 10 pipeline's Lloyd steps, kernel against plain version, failed")
        del xk
    torch.cuda.empty_cache()


def wide_phase(dev, card, launches):
    """Fault C.10's phases, in order: the kernel, the Lloyd steps, the model
    paths, the quality ladder's wide rungs with quality_bench, and the
    pipeline at nbits 10. Returns the kernels line's rows of B7's wide
    build; the launches of its drives go to launches["pq_encode"][geometry]."""
    import torch

    t0 = time.perf_counter()
    rows = wide_kernels(dev, card)
    wide_lloyd(dev, card)
    cfg, params = build_model(dev)
    by_path = {k: {} for k in KERNELS}
    wide_paths(dev, cfg, params, by_path, card)
    launches["pq_encode"][WIDE_PATH_GEOM].update(by_path["pq_encode"])
    del params
    torch.cuda.empty_cache()
    wide_quality(dev, launches, card)
    wide_pipeline(dev, launches, card)
    log(f"[wide] phase wall {time.perf_counter() - t0:.2f} s on {card}")
    return rows


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

    # one nvcc per source, all started together, and g++ for the native trainer's library beside them
    from million_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS) + 1) as pool:
        native_built = pool.submit(native.load)
        builds = list(pool.map(cuda_build.build, KERNELS))
        native_built.result()
    log(f"[build] {native.library_path().name} (g++, the native trainer)")
    for built in builds:
        usage = [ln.strip() for ln in built.log.splitlines() if "registers" in ln]
        warned = [ln.strip() for ln in built.log.splitlines() if "warning" in ln.lower()]
        log(f"[build] {built.path.name}: nvcc {built.build_s:.2f} s; ptxas: "
            f"{' | '.join(usage[-4:]) if built.log else 'cached'}"
            f"{'; warnings: ' + ' | '.join(warned) if warned else ''}")
    log(f"[build] {len(builds)} libraries in {time.perf_counter() - t0:.2f} s wall")

    if "--pipeline-only" in sys.argv[1:]:
        pipeline_path(dev, {k: {g: {} for g in PATH_GEOMETRIES} for k in KERNELS}, card)
        return 0
    wide_launches = {"pq_encode": {g: {} for g in WIDE_GEOMETRIES}}
    if "--wide-only" in sys.argv[1:]:
        wide_phase(dev, card, wide_launches)
        return 0
    only = {a for a in sys.argv[1:] if a in ("--c9-only", "--sessions-only")}
    if only:  # fault C.9's phases and / or the long-context, mixed-serving and checkpoint phases
        if "--c9-only" in only:
            c9_kernels(dev)
        cfg, params = build_model(dev)
        if "--c9-only" in only:
            c9_paths(dev, cfg, params, {k: {} for k in KERNELS})
        if "--sessions-only" in only:
            launches = {k: {g: {} for g in PATH_GEOMETRIES} for k in KERNELS}
            long_context_phase(dev, cfg, params, launches, card)
            mixed_phase(dev, cfg, params, launches, card)
            checkpoint_phase(dev, cfg, params, launches, card)
        return 0
    # the paths run a bf16 model, whose partials take the tensor-core versions
    causal = causal_phase(dev)
    rows = {"pq_decode_attention": {g: r for (g, e), r in kernel_phase(dev).items() if e == "stacked"},
            "pq_paged_attention": paged_phase(dev),
            "pq_encode": encode_phase(dev),
            "pq_chunk_attention": {g: r for (g, shape, pr), r in chunk_phase(dev).items()
                                   if shape == "chunk" and pr == "bf16"},
            "causal_attention": {g: causal["chunk"] for g in PATH_GEOMETRIES}}
    c4_phase(dev)
    c9_rows = c9_kernels(dev)
    if "--kernels-only" in sys.argv[1:]:
        return 0
    tiny_check(dev)
    tiny_serving_check(dev)
    cfg, params = build_model(dev)
    c1_phase(dev, cfg, params)
    launches = {k: {g: {} for g in PATH_GEOMETRIES} for k in KERNELS}
    main_path(dev, cfg, params, launches)
    c9_launches = {k: {} for k in KERNELS}
    c9_paths(dev, cfg, params, c9_launches)
    serving_path(dev, cfg, params, launches)
    long_context_phase(dev, cfg, params, launches, card)
    mixed_phase(dev, cfg, params, launches, card)
    checkpoint_phase(dev, cfg, params, launches, card)
    del params
    torch.cuda.empty_cache()
    quality_path(dev, launches, card)
    pipeline_path(dev, launches, card)
    wide_rows = wide_phase(dev, card, wide_launches)

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
    for name, by_geom in c9_rows.items():  # fault C.9's d_m = 16 builds, launched by the dm16 paths
        source, replaces = KERNELS[name]
        r = by_geom["dm16"]
        kernels.append({
            "name": f"{name}[dm16]", "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c9_launches[name].values()), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
        })
    source, replaces = KERNELS["pq_encode"]
    for geom, r in wide_rows.items():  # fault C.10: B7's wide build, launched by the wide drives
        kernels.append({
            "name": f"pq_encode[{geom}]", "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(wide_launches["pq_encode"][geom].values()), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
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

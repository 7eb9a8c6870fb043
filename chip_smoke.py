#!/usr/bin/env python3
"""Smoke run of million_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # the whole run
    python3 chip_smoke.py --kernels-only  # phases 1-3, no result line

Phases, each printed as it ends; any failure exits non-zero and prints no
result line:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the CUDA kernels from million_tpu_torch/csrc with nvcc;
  3. every kernel against its plain PyTorch version on the card at the main
     path's shapes (llama-3.2-3b: G=3, d=128, 8 KV heads, batch 4, a 32K
     arena holding 32768-512 codes, a bf16 residual window with 97 live
     rows merged in) in the three geometries and through the
     single-layer entry, with its time, its bound and the plain version's
     time; dense bf16 SDPA over the same length is printed as a yardstick;
  4. the main path: generate() at the full width of llama-3.2-3b (28 layers,
     random weights from a seed, bench.py's synthetic codebooks), 4 requests
     of 32,000-token prompts and 160 new tokens with F=16 sub-window flushes,
     in mode "pq_kernel" for dm2 and dm4_outlier_c128, with TTFT, TPOT,
     tokens/s and the kernel's launch count (= layers x decode steps); four
     teacher-forced steps, one just after a flush, against the plain oracle
     mode "pq"; a test-tiny generate on the card against the CPU; dense-mode
     TPOT beside;
  5. a JSON line of the kernels, then the card line, then the result line.
It needs no network and starts no process but nvidia-smi and nvcc.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

BS, PROMPT, N_MAX, NEW_TOKENS, FLUSH = 4, 32000, 32768, 160, 16
N_CODES = N_MAX - 512  # kernel phase: the arena fill of bench.py's decode
RESIDUAL_ROWS = 97  # kernel phase: live rows of the 128-row residual window
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
KERNEL_TOL = 1e-3  # f32 kernel vs f32 plain version: only summation order differs
LOGIT_TOL = 0.25  # bf16 model, pq_kernel vs pq: attention agrees to ~1e-6 in f32,
# then bf16 rounding of the activations compounds over 28 layers
GEOMETRIES = {  # bench.py:65-107
    "dm2": dict(M=64, C=256, O=0),
    "dm4_outlier": dict(M=32, C=256, O=16),
    "dm4_outlier_c128": dict(M=32, C=128, O=16),
}
REPLACES = "million_tpu/ops/pq_attention_pallas.py:837"
SOURCE = "million_tpu_torch/csrc/pq_decode_attention.cu"


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


def synthetic_cents(L: int, d: int, geom: str, seed: int = 0):
    """bench.py's synthetic codebooks: standard normal, and for the outlier
    geometries 16 + 16 random exact channels whose centroid components are 0."""
    import numpy as np

    g = GEOMETRIES[geom]
    M, C, O = g["M"], g["C"], g["O"]
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
    toks = []
    for d in ("cpu", dev):
        res, _ = generate(p_cpu if d == "cpu" else p_dev, cfg, ids.to(d), init_state(pqc, 2, device=d),
                          cents_from_numpy(c, device=d), max_new_tokens=16, flush_chunk=4, device=d)
        toks.append(res.tokens)
    same = bool((toks[0] == toks[1]).all())
    log(f"[tiny] test-tiny generate, card vs cpu greedy tokens equal: {same}")
    if not same:
        raise RuntimeError(f"test-tiny tokens differ: {toks}")


def main_path(dev):
    """generate() at full llama-3.2-3b width through the kernel."""
    import torch

    from million_tpu_torch.cache.dense_cache import DenseCacheConfig, init_dense_state
    from million_tpu_torch.cache.pq_cache import PQCacheConfig, cache_memory_bytes, init_state
    from million_tpu_torch.convert import cents_from_numpy
    from million_tpu_torch.models import llama
    from million_tpu_torch.ops import pq_attention_kernel as K
    from million_tpu_torch.runtime.generate import generate

    cfg = llama.PRESETS["llama-3.2-3b"]
    L, d = cfg.num_layers, cfg.head_dim
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for v in params["layers"].values()) + params["embed"].numel()
    log(f"[model] llama-3.2-3b random bf16 weights: {n_par / 1e9:.3f} B params, "
        f"init {time.perf_counter() - t0:.1f} s")
    ids = torch.randint(0, cfg.vocab_size, (BS, PROMPT), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    launches, results = {}, {}
    for geom in ("dm2", "dm4_outlier_c128"):
        g = GEOMETRIES[geom]
        cents = cents_from_numpy(synthetic_cents(L, d, geom), device=dev)
        pqc = PQCacheConfig(bs=BS, nh_k=cfg.num_kv_heads, d=d, M=g["M"], C=g["C"], Lt=128,
                            N_max=N_MAX, OK=g["O"], OV=g["O"])
        cache = init_state(pqc, L, device=dev)
        torch.cuda.reset_peak_memory_stats()
        K.pq_codes_attention_stacked.launches = 0  # counts from here: the main path only
        res, cache = generate(params, cfg, ids, cache, cents, mode="pq_kernel",
                              max_new_tokens=NEW_TOKENS, flush_chunk=FLUSH, device=dev)
        n_launch = K.pq_codes_attention_stacked.launches
        launches[geom] = n_launch
        want = L * (NEW_TOKENS - 1)
        toks_ok = res.tokens.shape == (BS, NEW_TOKENS) and ((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all()
        log(f"[generate] {geom}: TTFT {res.ttft_s:.3f} s, TPOT {res.tpot_s * 1e3:.3f} ms, "
            f"{BS / res.tpot_s:.1f} tok/s (bs={BS}), flushes={res.n_flushes}, "
            f"kernel launches={n_launch} (want {want}), peak mem "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, cache "
            f"{cache_memory_bytes(pqc, L)['total'] / 1e9:.2f} GB")
        if n_launch != want or res.n_flushes < 2 or not toks_ok:
            raise RuntimeError(f"main path check failed for {geom}")
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
        results[geom] = res
        del cache
        torch.cuda.empty_cache()
    dcache = init_dense_state(DenseCacheConfig(bs=BS, nh_k=cfg.num_kv_heads, d=d, N_max=N_MAX), L, device=dev)
    dres, _ = generate(params, cfg, ids, dcache, None, mode="dense", max_new_tokens=33, device=dev)
    log(f"[generate] dense bf16 KV: TTFT {dres.ttft_s:.3f} s, TPOT {dres.tpot_s * 1e3:.3f} ms, "
        f"{BS / dres.tpot_s:.1f} tok/s (bs={BS})")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from million_tpu_torch.ops import cuda_build
        from million_tpu_torch.ops import pq_attention_kernel as K
    except ImportError as e:
        print(f"chip_smoke: million_tpu_torch not importable ({e}); run from the repo root",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = cuda_build.build("pq_decode_attention")
    usage = [ln.strip() for ln in built.log.splitlines() if "registers" in ln]
    log(f"[build] {built.path.name}: nvcc {built.build_s:.2f} s (wall {time.perf_counter() - t0:.2f} s); "
        f"ptxas: {' | '.join(usage[-3:])}")

    rows = kernel_phase(dev)
    if "--kernels-only" in sys.argv[1:]:
        return 0
    tiny_check(dev)
    launches = main_path(dev)

    kernels = []
    for geom in ("dm2", "dm4_outlier_c128"):
        r = rows[(geom, "stacked")]
        kernels.append({
            "name": f"pq_decode_attention[{geom}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[geom], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
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

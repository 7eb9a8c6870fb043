"""Microbenchmark and on-device parity check of the one-layer PQ decode
kernel (B2, ops/pq_attention_kernel.pq_codes_attention).

Counterpart of million_tpu/benchmarks/kernel_bench.py, the reference's
test_kernel.py protocol: the mean absolute error of the kernel against
scaled-dot-product attention over the decoded K / V at --parity-n tokens,
then a timed loop (CUDA events) at --n tokens beside a dense bf16 decode step
(torch's SDPA over a bf16 K / V cache of the same length), and with
--outliers the kernel with that many exact K and V channels. q is (bs, nh_k,
G, d) with G = --group query heads a KV head (the reference pads its group to
GROUP_PAD = 8 rows, all of which its bench fills; 8 is the default here).

    python -m million_tpu_torch.benchmarks.kernel_bench [--n 32768] [--heads 8] [--outliers 16]

On the CPU (`--device cpu`, only when asked) the wrapper runs the kernel's
plain version and the times are the host's.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from million_tpu_torch import resolve_device
from million_tpu_torch.ops.pq_attention_kernel import (
    pq_codes_attention,
    pq_codes_attention_plain,
    pq_codes_attention_stacked,
)
from million_tpu_torch.pq.ops import pq_decode


def _timer(dev: torch.device, fn, iters: int, warm: int = 3) -> float:
    """Milliseconds a call: CUDA events around `iters` calls on the card,
    the host clock on the CPU."""
    for _ in range(warm):
        fn()
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def parity(bs: int, nh_k: int, G: int, d: int, M: int, C: int, n: int, seed: int = 0,
           device="cuda") -> Dict[str, float]:
    """MAE and max error of the kernel over the first n - 100 of n random
    codes, against SDPA over the decoded K / V (f32)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    kcent = t(rng.standard_normal((M, C, d // M)).astype(np.float32))
    vcent = t(rng.standard_normal((M, C, d // M)).astype(np.float32))
    q = t((rng.standard_normal((bs, nh_k, G, d)) / np.sqrt(d)).astype(np.float32))
    kc = t(rng.integers(0, C, (bs, nh_k, n, M)).astype(np.uint8))
    vc = t(rng.integers(0, C, (bs, nh_k, n, M)).astype(np.uint8))
    n_codes = n - 100
    out, _ = pq_codes_attention(q, kc, vc, kcent, vcent, n_codes)
    khat = pq_decode(kc[:, :, :n_codes], kcent, "strided").float()
    vhat = pq_decode(vc[:, :, :n_codes], vcent, "strided").float()
    want = F.scaled_dot_product_attention(q, khat, vhat, scale=1.0)
    err = (out - want).abs()
    return {"n_codes": n_codes, "mae": float(err.mean()), "max_abs_err": float(err.max())}


def bench(bs: int = 1, nh_k: int = 8, G: int = 8, d: int = 128, M: int = 64, nbits: int = 8,
          n: int = 32768, parity_n: int = 2048, iters: int = 50, outliers: int = 0, seed: int = 0,
          device="cuda") -> Dict[str, Optional[float]]:
    """The parity check, then the kernel's and the dense step's times (ms)
    at n tokens; with outliers > 0 also the kernel with that many exact K
    and V channels. Each timed call's (out, lse) is also held against the
    kernel's plain version on the same inputs (timed_max_abs_err,
    outlier_max_abs_err)."""
    dev = resolve_device(device)
    C = 2**nbits
    res: Dict[str, Optional[float]] = {"bs": bs, "nh_k": nh_k, "G": G, "d": d, "M": M, "C": C, "n": n}
    res.update(parity(bs, nh_k, G, d, M, C, parity_n, seed, dev))
    if res["mae"] >= 2e-2:
        raise AssertionError(f"kernel does not match the decoded attention: MAE {res['mae']:.3g}")
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = lambda: torch.randint(0, C, (bs, nh_k, n, M), generator=g, device=dev, dtype=torch.uint8)  # noqa: E731
    kc, vc = codes(), codes()
    kcent = torch.randn((M, C, d // M), generator=g, device=dev)
    vcent = torch.randn((M, C, d // M), generator=g, device=dev)
    q = torch.randn((bs, nh_k, G, d), generator=g, device=dev) / d**0.5
    one = lambda x: x[None]  # noqa: E731
    res["kernel_ms"] = _timer(dev, lambda: pq_codes_attention(q, kc, vc, kcent, vcent, n), iters)
    # the timed call itself against the plain version on the same inputs
    res["timed_max_abs_err"] = _gap(pq_codes_attention(q, kc, vc, kcent, vcent, n),
                                    pq_codes_attention_plain(q, one(kc), one(vc), one(kcent), one(vcent), 0, n))
    code_bytes = 2 * bs * nh_k * M * n
    res["kernel_GBps"] = code_bytes / (res["kernel_ms"] * 1e-3) / 1e9
    kd = torch.randn((bs, nh_k, n, d), generator=g, device=dev).to(torch.bfloat16)
    vd = torch.randn((bs, nh_k, n, d), generator=g, device=dev).to(torch.bfloat16)
    qb = q.to(torch.bfloat16)
    res["dense_ms"] = _timer(dev, lambda: F.scaled_dot_product_attention(qb, kd, vd, scale=1.0), iters)
    res["speedup"] = res["dense_ms"] / res["kernel_ms"]
    res["outlier_ms"] = res["outlier_max_abs_err"] = None
    if outliers:
        O = outliers
        ko = torch.randn((1, bs, nh_k, n, O), generator=g, device=dev).to(torch.bfloat16)
        vo = torch.randn((1, bs, nh_k, n, O), generator=g, device=dev).to(torch.bfloat16)
        oidx = torch.randperm(d, generator=g, device=dev)[:O].sort().values.to(torch.int32)[None]
        args = (q, one(kc), one(vc), one(kcent), one(vcent), 0, n)
        okw = dict(k_outliers=ko, v_outliers=vo, k_oidx=oidx, v_oidx=oidx)
        res["outlier_ms"] = _timer(dev, lambda: pq_codes_attention_stacked(*args, **okw), iters)
        res["outlier_max_abs_err"] = _gap(pq_codes_attention_stacked(*args, **okw),
                                          pq_codes_attention_plain(*args, **okw))
    return res


def _gap(got, want) -> float:
    """The largest absolute difference of two (out, lse) pairs."""
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32768, help="quantized tokens")
    ap.add_argument("--heads", type=int, default=8, help="KV heads")
    ap.add_argument("--group", type=int, default=8, help="query heads a KV head")
    ap.add_argument("--bs", type=int, default=1)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--M", type=int, default=64)
    ap.add_argument("--nbits", type=int, default=8, help="bits per code (C = 2^nbits)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--parity-n", type=int, default=2048)
    ap.add_argument("--outliers", type=int, default=0,
                    help="also time the kernel with this many exact K / V channels")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    r = bench(a.bs, a.heads, a.group, a.d, a.M, a.nbits, a.n, a.parity_n, a.iters, a.outliers,
              device=a.device)
    print(f"parity n={r['n_codes']}: MAE={r['mae']:.2e} MaxAbsErr={r['max_abs_err']:.2e}")
    print(f"PQ decode kernel (B2): bs={a.bs} heads={a.heads} G={a.group} n={a.n} M={a.M}: "
          f"{r['kernel_ms'] * 1e3:.1f} us ({r['kernel_GBps']:.0f} GB/s effective over the codes)")
    print(f"dense bf16 attention (SDPA): {r['dense_ms'] * 1e3:.1f} us -> kernel speedup {r['speedup']:.2f}x")
    print(f"timed call against the plain version: max abs err {r['timed_max_abs_err']:.2e}")
    if r["outlier_ms"] is not None:
        print(f"with {a.outliers} exact K / V channels: {r['outlier_ms'] * 1e3:.1f} us "
              f"(max abs err against the plain version {r['outlier_max_abs_err']:.2e})")
    return r


if __name__ == "__main__":
    main()

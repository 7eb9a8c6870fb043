"""How many splits should the paged decode-attention kernel cut a sequence
into? Two measurements on the card behind `plan_paged_splits`:

    python3 -m million_tpu_torch.benchmarks.paged_split_sweep          # the kernel alone
    python3 -m million_tpu_torch.benchmarks.paged_split_sweep --tick   # a serving tick, A/B

The default mode times `pq_paged_attention_stacked` (CUDA events, 30
launches) for n_split = 1 .. 32 at the serving shape (8 KV heads, G=3, d=128,
2048-token pages, a bf16 residual window with 97 live rows per slot) for
several (slots, tokens per slot), and prints the planner's pick beside the
fastest split count and the wave model's cost, waves x (split length +
SPLIT_OVERHEAD_TOKENS), for each.

--tick traces `paged_decode_step` of llama-3.2-3b over six slots of 32,256
codes (benchmarks/decode_profile.py) with the one-wave plan S = n_sm // pairs
and with the planner, in turns within one process (old, new, new, old), so
that the two are compared on one card under one host. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from million_tpu_torch.benchmarks import decode_profile
from million_tpu_torch.models import llama
from million_tpu_torch.ops import pq_paged_attention_kernel as P

NH_K, G, D, PAGE, PPS, LT, ROWS = 8, 3, 128, 2048, 17, 128, 97
SPLITS = (1, 2, 3, 4, 6, 8, 11, 16, 22, 32)
SHAPES = ((6, 32640), (6, 8192), (6, 2048), (2, 32640), (1, 32640))


def cuda_ms(fn, iters: int = 30, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def one_wave_plan(n_bound, pairs, page_size, n_sm=P.SM_COUNT_DEFAULT, n_split=None, kpp=None):
    """The plan before the wave model: about one wave of blocks."""
    if kpp or n_split:
        return planner(n_bound, pairs, page_size, n_sm, n_split, kpp)
    return max(1, min(max(1, n_sm // max(pairs, 1)), -(-max(n_bound, 1) // P.TILE))), 0


planner = P.plan_paged_splits


def sweep_kernel(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for geom, (M, C, O) in decode_profile.GEOMETRIES.items():
        n_pages = 6 * PPS
        pools = [torch.randint(0, C, (1, n_pages + 1, NH_K, PAGE, M), generator=gen, device=dev,
                               dtype=torch.uint8) for _ in range(2)]
        cents = [torch.randn((1, M, C, D // M), generator=gen, device=dev) for _ in range(2)]
        okw = {}
        if O:
            idx = torch.randperm(D, generator=gen, device=dev)[:O].sort().values.int()[None].contiguous()
            okw = dict(k_oidx=idx, v_oidx=idx,
                       k_outliers=torch.randn((1, n_pages + 1, NH_K, PAGE, O), generator=gen, device=dev).bfloat16(),
                       v_outliers=torch.randn((1, n_pages + 1, NH_K, PAGE, O), generator=gen, device=dev).bfloat16())
        for slots, n in SHAPES:
            q = torch.randn((slots, NH_K, G, D), generator=gen, device=dev) / D**0.5
            res = torch.randn((1, slots, NH_K, LT, D), generator=gen, device=dev).bfloat16()
            table = torch.arange(slots * PPS, device=dev, dtype=torch.int32).reshape(slots, PPS)
            n_codes = torch.full((slots,), n, dtype=torch.int32, device=dev)
            r = torch.full((slots,), ROWS, dtype=torch.int32, device=dev)
            n_bound = -(-n // PAGE) * PAGE
            ms = {S: cuda_ms(lambda: P.pq_paged_attention_stacked(
                q, *pools, *cents, 0, table, n_codes, n_bound=n_bound, k_residual=res, v_residual=res,
                r=r, n_split=S, **okw)) for S in SPLITS}
            pick, _ = planner(n_bound, slots * NH_K, PAGE, n_sm)
            model = {S: -(-slots * NH_K * S // n_sm) * (P.seq_chunk(n_bound, S) + P.SPLIT_OVERHEAD_TOKENS)
                     for S in SPLITS}
            print(f"[sweep] {geom} slots={slots} tokens={n}: planner S={pick}, fastest S="
                  f"{min(ms, key=ms.get)}; ms by S: " + " ".join(f"{S}:{t:.4f}" for S, t in ms.items())
                  + "; model cost (tokens) by S: " + " ".join(f"{S}:{c}" for S, c in model.items()),
                  flush=True)


def ab_tick(dev, steps: int) -> None:
    cfg = llama.PRESETS["llama-3.2-3b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, gen, device=dev)
    try:
        for geom in decode_profile.GEOMETRIES:
            for name, plan in (("one wave", one_wave_plan), ("planner", planner), ("planner", planner),
                               ("one wave", one_wave_plan)):
                P.plan_paged_splits = plan
                print(f"[tick A/B] plan: {name}", flush=True)
                decode_profile.profile_mode(params, cfg, 6, f"paged:{geom}", steps, gen, dev)
                torch.cuda.empty_cache()
    finally:
        P.plan_paged_splits = planner


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tick", action="store_true", help="A/B the two plans on a serving tick")
    ap.add_argument("--steps", type=int, default=16, help="traced steps per A/B run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paged_split_sweep needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    (ab_tick(dev, args.steps) if args.tick else sweep_kernel(dev))


if __name__ == "__main__":
    main()

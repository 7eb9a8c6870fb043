"""Multi-GPU scaling: an analytic efficiency model of the sequence-sharded
decode step, and multi-rank parity of the mesh paths.

Counterpart of million_tpu/benchmarks/scaling_bench.py. The model is the
reference's:

    t(sp) = t_other + t_scan / sp + t_merge(sp)

  t_scan : the step's read of the code arena (both sides, every layer), the
           term that shards: each of sp shards reads N / sp tokens;
  t_other: everything else (projections, MLP, sampling, launches) =
           measured TPOT - t_scan; replicated over sp;
  t_merge: the LSE merge of parallel/sharded_decode.py, once a layer: a MAX
           all-reduce of the lse and one SUM all-reduce of (out, lse), whose
           payload a rank is (bs, nh_k, G, d + 1) f32 with G = nh / nh_k (the
           reference pads G to GROUP_PAD = 8), as a ring all-reduce at the
           link's rate plus a per-hop latency.

  eff(sp) = t_scan / (sp * (t_scan / sp + t_merge))   (the attention's
  strong-scaling efficiency), and the step's speedup t(1) / t(sp). dp needs
  no collective in decode (each rank owns whole sequences).

The hardware constants are an argument. H100 (the default) holds data-sheet
values of the H100 SXM5 80GB (700 W): HBM3 3.35 TB/s, NVLink 4 at 450 GB/s
a direction per GPU, and 400 Gb/s InfiniBand NDR a GPU as the dcn analogue;
the per-hop latencies are assumptions. None of them is a measurement. V5E
holds the reference's TPU v5e constants, for comparison with its numbers.
`measured_tpot_ms` is measured by this bench's own single-rank run on the
card (`--measure`), printed with the card's name and power limit.

    python -m million_tpu_torch.benchmarks.scaling_bench [--measure] [--parity] [--device cpu]

`--parity` runs the flat decode step on 2- and 4-rank meshes (sp) and the
serving tick on a tp 2 x sp 2 mesh, against one rank, and prints the logit
gaps (on the card the ranks share it over gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
from typing import Dict, Optional

import numpy as np

COLLECTIVES_PER_MERGE = 2  # a MAX all-reduce and one SUM all-reduce of (out, lse)


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    hbm_gbps: float  # device memory, GB/s
    ici_gbps: float  # within a node (NVLink; ICI on the TPU), GB/s a direction a device
    ici_alpha_us: float  # per hop
    dcn_gbps: float  # across nodes (InfiniBand; DCN on the TPU), GB/s a device
    dcn_alpha_us: float


H100 = Hardware(
    name="H100 SXM5 80GB (700 W): data-sheet rates; per-hop latencies assumed",
    hbm_gbps=3350.0,  # HBM3, data sheet
    ici_gbps=450.0,  # NVLink 4: 900 GB/s a GPU in both directions, data sheet
    ici_alpha_us=2.0,  # assumption
    dcn_gbps=50.0,  # 400 Gb/s InfiniBand NDR a GPU, data sheet
    dcn_alpha_us=5.0,  # assumption
)
V5E = Hardware(name="TPU v5e (million_tpu's constants)", hbm_gbps=819.0, ici_gbps=45.0,
               ici_alpha_us=1.0, dcn_gbps=12.5, dcn_alpha_us=10.0)


@dataclasses.dataclass(frozen=True)
class DecodeShape:
    """llama-3.2-3b at the reference bench's shape (bs 7, 32K arena, dm2)."""
    L: int = 28
    bs: int = 7
    nh_k: int = 8
    d: int = 128
    M: int = 64
    M_v: int = 64
    N: int = 32768
    group: int = 3  # G = nh / nh_k
    measured_tpot_ms: Optional[float] = None  # the card's single-rank TPOT at this shape


def arena_scan_bytes(s: DecodeShape) -> float:
    """A step's reads of the code arena (both sides, all layers), 1 B a code."""
    return s.L * s.bs * s.nh_k * (s.M + s.M_v) * s.N


def merge_payload_bytes(s: DecodeShape) -> float:
    """A rank's (out, lse) in one layer's merge: (bs, nh_k, G, d + 1) f32."""
    return s.bs * s.nh_k * s.group * (s.d + 1) * 4


def analytic_efficiency(s: DecodeShape, sp: int, *, dcn: int = 1, hw: Hardware = H100) -> Dict[str, float]:
    """Strong-scaling efficiency of the decode step over sp sequence shards
    (x dcn nodes, whose boundary rides the slower link)."""
    if s.measured_tpot_ms is None:
        raise ValueError("DecodeShape.measured_tpot_ms: measure it on the card (--measure)")
    t_scan_ms = arena_scan_bytes(s) / (hw.hbm_gbps * 1e6)
    t_other_ms = max(s.measured_tpot_ms - t_scan_ms, 0.1)
    n_shards = sp * dcn
    payload = merge_payload_bytes(s)
    lse_bytes = s.bs * s.nh_k * s.group * 4

    def coll_ms(n, bw_gbps, alpha_us):
        # ring all-reduce: the (out, lse) sum carries the payload, the max the
        # lse row; both pay the (n - 1)-hop latency
        return (2 * (n - 1) / max(n, 1) * (payload + lse_bytes) / (bw_gbps * 1e6)
                + COLLECTIVES_PER_MERGE * (n - 1) * alpha_us * 1e-3)

    ici_ms = s.L * coll_ms(sp, hw.ici_gbps, hw.ici_alpha_us)
    dcn_ms = s.L * coll_ms(dcn, hw.dcn_gbps, hw.dcn_alpha_us) if dcn > 1 else 0.0
    t1 = t_other_ms + t_scan_ms
    tn = t_other_ms / 1.0 + t_scan_ms / n_shards + ici_ms + dcn_ms
    scan = t_scan_ms / n_shards + ici_ms + dcn_ms
    scan_eff = (t_scan_ms / 1.0) / (n_shards * scan) if scan else 1.0
    return {"sp": sp, "dcn": dcn, "t_scan_ms": t_scan_ms, "t_other_ms": t_other_ms,
            "t_comm_ms": ici_ms + dcn_ms, "t_step_ms": tn, "step_speedup": t1 / tn,
            "attention_scaling_eff": scan_eff}


def throughput_scaling_note() -> Dict:
    return {"axis": "dp", "per_step_comm_bytes": 0, "weak_scaling_eff": 1.0,
            "note": "no collectives in the dp decode path (parallel/mesh.py layouts)"}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def measure_tpot_ms(s: DecodeShape, steps: int = 20, device="cuda") -> float:
    """The single-rank decode step's time at shape s on the card (mode
    "pq_kernel", llama-3.2-3b at full width and random weights, a full arena
    of random codes): CUDA events over `steps` steps after warm-up."""
    import torch

    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
    from million_tpu_torch.models import llama

    dev = torch.device(device)
    cfg = dataclasses.replace(llama.PRESETS["llama-3.2-3b"], num_layers=s.L)
    g = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, g, device=dev)
    cache = init_state(PQCacheConfig(bs=s.bs, nh_k=s.nh_k, d=s.d, M=s.M, M_v=s.M_v, N_max=s.N, Lt=128),
                       s.L, device=dev)
    for k in ("key_codes", "value_codes"):
        cache[k].random_(0, 256, generator=g)
    cache["n_codes"] = s.N
    C, dm = 256, s.d // s.M
    cents = {"key": torch.randn((s.L, s.M, C, dm), generator=g, device=dev),
             "value": torch.randn((s.L, s.M_v, C, s.d // s.M_v), generator=g, device=dev)}
    tok = torch.zeros(s.bs, dtype=torch.long, device=dev)

    def step():
        llama.decode_step(params, cfg, tok, s.N, cache, cents, mode="pq_kernel")
        cache["r"] = 0

    for _ in range(3):
        step()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps):
        step()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / steps


# --------------------------------------------------------------------------
# multi-rank parity
# --------------------------------------------------------------------------

def _tiny(device: str):
    import torch

    from million_tpu_torch.models import llama

    cfg = llama.PRESETS["test-tiny"]
    rng = np.random.default_rng(0)
    M = cfg.head_dim // 2
    cents = {k: torch.from_numpy(rng.standard_normal((cfg.num_layers, M, 64, 2)).astype(np.float32)).to(device)
             for k in ("key", "value")}
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    return cfg, params, cents, rng


def _flat_step(rank: int, sp: int, device: str):
    """The flat decode step's logits on an sp mesh (a 1-rank run without a
    process group when rank is None)."""
    import torch

    from million_tpu_torch.cache.pq_cache import PQCacheConfig, init_state
    from million_tpu_torch.models import llama
    from million_tpu_torch.parallel.mesh import make_mesh, shard_cache

    cfg, params, cents, rng = _tiny(device)
    M = cfg.head_dim // 2
    cache = init_state(PQCacheConfig(bs=1, nh_k=cfg.num_kv_heads, d=cfg.head_dim, M=M, C=64, Lt=16,
                                     N_max=512, dtype=torch.float32), cfg.num_layers, device="cpu")
    for k in ("key_codes", "value_codes"):
        cache[k] = torch.from_numpy(rng.integers(0, 64, cache[k].shape).astype(np.uint8))
    for k in ("key_residual", "value_residual"):
        cache[k] = torch.from_numpy(rng.standard_normal(cache[k].shape).astype(np.float32))
    cache["n_codes"], cache["r"] = 384, 3
    mesh = None if rank is None else make_mesh(sp=sp, device=device)
    cache = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in cache.items()}
    if mesh is not None:
        cache = shard_cache(cache, mesh)
    tok = torch.zeros(1, dtype=torch.long, device=device)
    return llama.decode_step(params, cfg, tok, 387, cache, cents, mode="pq_kernel", mesh=mesh).cpu().numpy()


def _paged_tick(rank: int, device: str):
    """Admit one prompt through a (Sharded)Scheduler, then one serving tick's
    logits; tp 2 x sp 2 with a rank, one device without."""
    import torch

    from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
    from million_tpu_torch.models.paged_decode import paged_decode_step
    from million_tpu_torch.parallel.mesh import make_mesh, shard_params
    from million_tpu_torch.runtime.scheduler import Request, Scheduler, ShardedScheduler

    cfg, params, cents, rng = _tiny(device)
    ps = 256 if device.startswith("cuda") else 128
    pcfg = PagedPQCacheConfig(num_layers=cfg.num_layers, nh_k=cfg.num_kv_heads, d=cfg.head_dim,
                              M=cfg.head_dim // 2, C=64, Lt=8, page_size=ps, n_pages=8, max_seqs=2,
                              pages_per_seq=4, dtype=torch.float32)
    prompt = rng.integers(0, cfg.vocab_size, ps + 60)
    if rank is None:
        mesh, sched = None, Scheduler(params, cfg, pcfg, cents, admit_chunk=ps, device=device)
    else:
        mesh = make_mesh(tp=2, sp=2, device=device)
        sched = ShardedScheduler(shard_params(params, mesh), cfg, pcfg, cents, mesh=mesh, admit_chunk=ps)
    sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    sched._try_admit()
    sched.drain()
    lg = paged_decode_step(sched.params, cfg, pcfg, sched.last_token, None, sched.state, cents, mesh=mesh)
    return lg.cpu().numpy()


def mesh_parity(device: str = "cuda") -> Dict[str, float]:
    """Logit gaps of the sharded paths against one rank."""
    from million_tpu_torch.parallel.launch import run_ranks

    out = {}
    ref = _flat_step(None, 1, device)
    for sp in (2, 4):
        got = run_ranks(_flat_step, sp, (sp, device), device=device)
        out[f"sp{sp}_max_logit_diff"] = float(max(np.abs(g - ref).max() for g in got))
    ref = _paged_tick(None, device)
    got = run_ranks(_paged_tick, 4, (device,), device=device)
    out["paged_tick_sp2tp2_max_logit_diff"] = float(max(np.abs(g - ref).max() for g in got))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", action="store_true", help="measure the TPOT on the card")
    ap.add_argument("--tpot-ms", type=float, default=None, help="a 32K TPOT measured before")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for label, shape in (("32K", DecodeShape(measured_tpot_ms=a.tpot_ms)),
                         ("128K", DecodeShape(bs=1, N=131072))):
        if a.measure:
            shape = dataclasses.replace(shape, measured_tpot_ms=measure_tpot_ms(shape, device=a.device))
            print(json.dumps({"shape": label, "measured_tpot_ms": shape.measured_tpot_ms,
                              "card": card_line()}))
        if shape.measured_tpot_ms is None:
            continue
        rows = [analytic_efficiency(shape, sp) for sp in (1, 2, 4, 8)]
        rows.append(analytic_efficiency(shape, 4, dcn=2))
        for r in rows:
            print(json.dumps({"shape": label, "hardware": H100.name, **r}))
    print(json.dumps(throughput_scaling_note()))
    if a.parity:
        print(json.dumps(mesh_parity(a.device)))


if __name__ == "__main__":
    main()

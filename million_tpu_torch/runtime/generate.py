"""Autoregressive generation: prefill, then a decode loop with a host-side
residual-flush schedule. Counterpart of million_tpu/runtime/generate.py.

Tokens stay on the device across steps and nothing reads them back until the
loop ends; the flush schedule and the arena fill level are host integers.
On the card TTFT and TPOT come from CUDA events recorded on the stream; on
the CPU from the host clock.

On a mesh (parallel/mesh.py) every rank calls generate with the whole batch
and its own shards of the parameters and cache: it runs its dp slice of the
batch, rank 0 samples and broadcasts, and every rank returns the same
tokens. `sequence_parallel=True` admits the prompt through
parallel/sp_prefill.prefill_sp.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from million_tpu_torch import resolve_device
from million_tpu_torch.models import llama
from million_tpu_torch.models.chunked_prefill import chunked_prefill
from million_tpu_torch.parallel.mesh import seq_shard
from million_tpu_torch.runtime.sampling import SamplingConfig, dp_slice, sample_on_mesh


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (bs, n_generated)
    ttft_s: float  # prefill + first token
    tpot_s: float  # mean per subsequent token
    decode_s: float  # decode loop time
    selfcheck_max_diff: float = 0.0  # max |pq_kernel - pq| logit gap seen
    n_flushes: int = 0


class _Clock:
    """Marks on the card's stream (CUDA events) or on the host clock."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return b - a


def capacity_check(n_prompt: int, max_new_tokens: int, cache: Dict[str, Any],
                   mode: str, flush_chunk: int, n_seq: int = 1) -> None:
    """Raise before prefill when the generation would overflow the cache
    (an arena split over n_seq sequence shards holds n_seq times its own)."""
    if mode != "dense":
        n_max = cache["key_codes"].shape[3] * n_seq
        lt = cache["key_residual"].shape[3]
        tail0 = n_prompt % 4
        fch = flush_chunk if 0 < flush_chunk < lt else lt
        n_flushes = max(0, (tail0 + max(max_new_tokens - 1, 0) - lt) // fch + 1)
        peak_codes = (n_prompt - tail0) + fch * n_flushes
        if peak_codes > n_max:
            raise ValueError(
                f"prompt({n_prompt}) + max_new_tokens({max_new_tokens}) would "
                f"flush {peak_codes} codes into an arena of N_max({n_max}); "
                f"increase N_max (Lt={lt})"
            )
    else:
        n_max = cache["k"].shape[3]
        if n_prompt + max_new_tokens > n_max:
            raise ValueError(
                f"prompt({n_prompt}) + max_new_tokens({max_new_tokens}) exceeds "
                f"dense cache capacity N_max({n_max})"
            )


@torch.no_grad()
def generate(
    params: Any,
    cfg: llama.ModelConfig,
    input_ids: torch.Tensor,  # (bs, n_prompt)
    cache: Dict[str, Any],
    cents: Optional[Dict[str, torch.Tensor]],
    *,
    mode: str = "pq_kernel",
    max_new_tokens: int = 64,
    sampling: SamplingConfig = SamplingConfig(),
    seed: int = 0,
    selfcheck_every: int = 0,
    prefill_chunk: int = 0,  # > 0: admit the prompt in bounded-memory chunks
    prefill_hist_block: int = 4096,  # history tokens the plain history route decodes at a time
    flush_chunk: int = 0,  # 0: flush the whole window; F < Lt: the oldest F rows
    device="cuda",
    mesh=None,  # parallel.mesh.Mesh: params and cache are this rank's shards
    sequence_parallel: bool = False,  # admit through prefill_sp (needs mesh, a PQ mode)
) -> Tuple[GenerationResult, Dict[str, Any]]:
    """Prefill + decode loop. Returns (result, the cache, updated in place).

    prefill_chunk=N (PQ modes): the prompt is admitted N tokens at a time
    (models/chunked_prefill.py); each chunk attends exactly within itself and
    over the quantized history of the earlier chunks. prefill_hist_block
    bounds the history transient where the history partial runs its plain
    version (CPU tensors); the kernel on the card tiles the history itself.

    selfcheck_every=N (mode "pq_kernel"): every N decode steps the step first
    runs through the plain version (mode "pq") on the same cache, and the max
    logit gap is recorded; the plain step's residual writes are then overwritten
    by the kernel step. Timings under selfcheck include the extra forward."""
    dev = resolve_device(device)
    if input_ids.device.type != dev.type:
        raise ValueError(f"input_ids on {input_ids.device}, generate(device={dev})")
    bs, n_prompt = input_ids.shape
    if flush_chunk % 4:
        raise ValueError(f"flush_chunk={flush_chunk} must be a multiple of 4")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if prefill_chunk and mode == "dense":
        raise ValueError("prefill_chunk requires a PQ mode (quantized history)")
    n_seq = 1 if mode == "dense" else seq_shard(mesh)[1]
    capacity_check(n_prompt, max_new_tokens, cache, mode, flush_chunk, n_seq)
    if sequence_parallel and (mesh is None or mode == "dense" or prefill_chunk):
        raise ValueError("sequence_parallel admits a PQ cache on a mesh, without prefill_chunk")
    gen = torch.Generator(device=dev).manual_seed(seed)
    clock = _Clock(dev)
    ids = dp_slice(input_ids, mesh)

    t0 = clock.mark()
    if prefill_chunk:
        last_logits, _ = chunked_prefill(params, cfg, ids, cache, cents, chunk=prefill_chunk,
                                         hist_block=prefill_hist_block, mesh=mesh)
    elif sequence_parallel:
        from million_tpu_torch.parallel.sp_prefill import prefill_sp

        last_logits = prefill_sp(params, cfg, ids, cache, cents, mesh)
    else:
        last_logits = llama.prefill(params, cfg, ids, cache, cents,
                                    mode="dense" if mode == "dense" else "pq",
                                    last_logit_only=True, mesh=mesh)[:, -1]
    tok = sample_on_mesh(last_logits, gen, sampling, mesh)
    t1 = clock.mark()

    toks = [tok]
    # Host-side flush schedule: after prefill the window holds the ragged
    # tail n_prompt % 4, +1 per decode step; a step that finds it full is
    # preceded by a flush of f_host rows.
    pq = mode != "dense"
    r_host = n_prompt % 4 if pq else 0
    lt_host = cache["key_residual"].shape[3] if pq else 0
    f_host = flush_chunk if 0 < flush_chunk < lt_host else lt_host
    codes_host = n_prompt - n_prompt % 4 if pq else 0
    selfcheck = torch.zeros((), dtype=torch.float32, device=dev)
    n_flushes = 0
    for i in range(max_new_tokens - 1):
        pos = n_prompt + i
        if pq and r_host >= lt_host:
            llama.flush_windows(cache, cents, n=flush_chunk, mesh=mesh)
            r_host -= f_host
            codes_host += f_host
            n_flushes += 1
        if pq and (cache["r"], cache["n_codes"]) != (r_host, codes_host):
            raise RuntimeError("cache counters left the host flush schedule")
        r_host += 1
        ref = None
        if selfcheck_every and mode == "pq_kernel" and i % selfcheck_every == 0:
            ref = llama.decode_step(params, cfg, dp_slice(tok, mesh), pos, cache, cents,
                                    mode="pq", mesh=mesh)
            cache["r"] -= 1  # the kernel step rewrites the same residual row
        logits = llama.decode_step(params, cfg, dp_slice(tok, mesh), pos, cache, cents,
                                   mode=mode, mesh=mesh)
        if ref is not None:
            selfcheck = torch.maximum(selfcheck, (logits - ref).abs().max())
        tok = sample_on_mesh(logits, gen, sampling, mesh)
        toks.append(tok)
    t2 = clock.mark()

    ttft = clock.seconds(t0, t1)
    decode_s = clock.seconds(t1, t2)
    tokens = torch.stack(toks, dim=1).cpu().numpy()
    return (
        GenerationResult(
            tokens=tokens, ttft_s=ttft,
            tpot_s=decode_s / max(max_new_tokens - 1, 1), decode_s=decode_s,
            selfcheck_max_diff=float(selfcheck), n_flushes=n_flushes,
        ),
        cache,
    )

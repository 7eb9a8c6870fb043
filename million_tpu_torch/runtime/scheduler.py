"""Continuous-batching scheduler over the paged PQ cache.

Counterpart of million_tpu/runtime/scheduler.py::Scheduler: a slot-based
scheduler in the vLLM style. It admits requests into free slots, allocates
pages ON DEMAND, runs one batched `paged_decode_step` for all active slots
per tick, retires finished sequences and recycles their pages.

Paging policy: admission charges only the PROMPT plus one residual-window
flush of headroom; each slot then grows by one page at a time, allocated just
before the tick whose window flush would cross a page boundary (the host runs
`flush_paged_slots` for any slot with slot_r == Lt BEFORE the decode step; an
unallocated table entry would route the flushed codes to the scratch page, so
growth lands first). When the pool cannot serve a required grow, the most
recently admitted slot is PREEMPTED (recompute-style: its pages are freed and
the request re-queued at the front with its generated-so-far tokens folded
into the re-admission prefill, so no emitted token is lost). Admission skips
ahead past a blocked head-of-line request within a bounded window so small
requests can fill pool gaps without starving the head.

Host/device split: page-capacity and completion decisions are host-side, on
host mirrors of the counters; all compute and cache state stay on the device.
A tick never waits for the device: it runs k chained decode steps whose
positions come from the device counters, samples on the device, and copies
the (k, S) tokens to pinned host memory behind an event; the host reads them
`pipeline_depth` steps later. The reference fuses the k steps into one XLA
program; here they are a Python loop of k un-synced steps.

A live scheduler saves to disk and resumes with runtime/checkpoint.py
(save_session / load_session).

ShardedScheduler serves on a mesh (parallel/paged_sharded.py): every rank
runs the same host logic on the same requests over its own slab of the pool,
with a host allocator of per-shard free maps and local page ids; rank 0
samples and broadcasts, so every rank emits the same tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from million_tpu_torch import resolve_device
from million_tpu_torch.cache.paged_pq_cache import (
    PagedPQCacheConfig,
    allocate_pages,
    free_sequence,
    init_paged_state,
    paged_cache_stats,
)
from million_tpu_torch.models.llama import ModelConfig, Params
from million_tpu_torch.models.paged_decode import (
    flush_paged_slots,
    paged_admit_chunked,
    paged_admit_chunked_batch,
    paged_decode_step,
    paged_prefill_seq,
)
from million_tpu_torch.ops.pq_attention_kernel import TILE
from million_tpu_torch.runtime.sampling import SamplingConfig, sample_on_mesh


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (n,) integer
    max_new_tokens: int
    eos_id: Optional[int] = None


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    tokens: np.ndarray  # generated ids
    prompt_len: int


@dataclasses.dataclass
class _PendingTick:
    tokens: torch.Tensor  # (k, S) on the host (pinned when the device is a card)
    ready: Optional[torch.cuda.Event]  # recorded after the copy; None on the CPU
    entries: List[tuple]  # [(slot, rid)] active at dispatch


class Scheduler:
    def __init__(
        self,
        params: Params,
        cfg: ModelConfig,
        pcfg: PagedPQCacheConfig,
        tables: Dict[str, torch.Tensor],
        sampling: SamplingConfig = SamplingConfig(),
        seed: int = 0,
        admit_chunk: int = 2048,
        admit_batch: int = 8,
        tick_chain: int = 8,
        mesh=None,
        device="cuda",
    ):
        self.mesh = mesh
        self.device = resolve_device(device)
        # fail early, not deep inside the first decode: the paged kernel walks
        # whole tiles inside a page
        if self.device.type == "cuda" and pcfg.page_size % TILE:
            raise ValueError(
                f"page_size={pcfg.page_size}: the paged kernel needs page_size % {TILE} == 0 "
                "(a tile must not straddle a page); the CPU path takes any multiple of 4")
        self.params = params
        self.cfg = cfg
        self.pcfg = pcfg
        self.tables = tables
        self.sampling = sampling
        self.state = self._init_state()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        S = pcfg.max_seqs
        self.slot_req: List[Optional[Request]] = [None] * S
        self.slot_generated: List[List[int]] = [[] for _ in range(S)]
        self.slot_pos = np.zeros(S, np.int64)  # absolute position of next token
        self.slot_pages = np.zeros(S, np.int64)  # host mirror of seq_n_pages
        self.slot_codes = np.zeros(S, np.int64)  # host mirror of seq_n_codes
        self.slot_r = np.zeros(S, np.int64)
        # tokens DISPATCHED per slot (admission token + decode ticks sent,
        # including in-flight ones whose readback is pending): bounds the
        # multi-tick chain so a slot near max_new_tokens doesn't drag the
        # whole batch through wasted ticks
        self.slot_sent = np.zeros(S, np.int64)
        self.last_token = torch.zeros((S,), dtype=torch.long, device=self.device)
        self.waiting: List[Request] = []
        self.finished: List[FinishedRequest] = []
        self.slot_order: List[int] = []  # admission order (oldest first)
        self._preempt_saved: Dict[int, List[int]] = {}  # rid -> generated
        self.admit_skip_window = 4  # skip-ahead bound (head never starved)
        self.preemptions = 0
        self.ticks_dispatched = 0  # decode steps sent to the device, chained ones counted singly
        # pipelined token readback: dispatch tick t FIRST, then read tick
        # t - pipeline_depth's tokens while the device runs. Token-dependent
        # bookkeeping (generated list, EOS) lags `pipeline_depth` ticks;
        # count-based retirement costs at most that many extra dispatched
        # ticks per request (their tokens are discarded by the rid guard).
        # Preemption drains the pipeline first, so no emitted token is lost.
        self.pipeline = True
        self.pipeline_depth = 2
        # multi-tick chaining: when nothing is waiting to admit, chain up to
        # tick_chain decode steps per step() with one token readback. k is
        # clamped so no residual window fills mid-chain and no slot
        # overshoots max_new_tokens by more than the chain.
        self.tick_chain = max(1, int(tick_chain))
        self._pending: List[_PendingTick] = []
        # prompts longer than this admit via the CHUNKED path: bounded
        # activation memory per chunk
        self.admit_chunk = admit_chunk
        # batched admission: equal-bucket long prompts waiting together admit
        # through ONE chunked pass; admit_batch caps the group (activation
        # transients scale with it)
        self.admit_batch = admit_batch
        # pages much larger than the admission chunk blow the per-chunk
        # history-gather transients beside the pool
        if pcfg.page_size > 2 * self.admit_chunk:
            raise ValueError(
                f"page_size={pcfg.page_size} > 2*admit_chunk({2 * self.admit_chunk}): "
                "long-prompt admission gathers history at page granularity; use smaller "
                "pages or raise admit_chunk")

    # ---------------- the allocator (ShardedScheduler overrides these) -----
    def _init_state(self):
        if self.mesh is not None:
            raise ValueError("a mesh-backed scheduler must be constructed as ShardedScheduler")
        return init_paged_state(self.pcfg, device=self.device)

    def _do_allocate(self, slot: int, k: int) -> None:
        allocate_pages(self.state, slot, k)

    def _do_free(self, slot: int) -> None:
        free_sequence(self.state, slot)

    def _fits_grow(self, slot: int, grow: int) -> bool:
        return grow <= self._free_pages()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        # the paged state is not split over dp: every rank holds every slot
        return sample_on_mesh(logits, self.generator, self.sampling, self.mesh, gather_dp=False)

    # ---------------- admission -------------------------------------------
    def _fits_fresh(self, needs) -> bool:
        """Can fresh slots needing `needs` pages each all be allocated now?"""
        return sum(needs) <= self._free_pages() and all(
            k <= self.pcfg.pages_per_seq for k in needs)

    def submit(self, req: Request) -> None:
        # reject what can never be served: a prompt whose pages exceed the
        # per-sequence capacity would otherwise be admitted with
        # out-of-range table positions routed to the scratch page
        n = len(req.prompt)
        if self._pages_for(n + self.pcfg.Lt) > self.pcfg.pages_per_seq:
            cap = self.pcfg.pages_per_seq * self.pcfg.page_size - self.pcfg.Lt
            raise ValueError(
                f"prompt of {n} tokens exceeds per-sequence capacity "
                f"(~{cap} tokens: pages_per_seq={self.pcfg.pages_per_seq} x "
                f"page_size={self.pcfg.page_size} minus one flush window)")
        self.waiting.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.pcfg.page_size)

    def _free_pages(self) -> int:
        # HOST arithmetic, deliberately not a device readback: every
        # allocate / free decision is host-driven, so slot_pages is exact,
        # and reading state["used"] here would make the tick wait for the
        # device. stats() cross-checks host against device.
        return self.pcfg.n_pages - int(self.slot_pages.sum())

    def _saved_len(self, req: Request) -> int:
        return len(req.prompt) + len(self._preempt_saved.get(req.rid, []))

    def _admission_need(self, req: Request) -> int:
        """Pages charged at admission: the prompt (plus generated-so-far on
        re-admission after preemption) + one flush window of headroom, NOT
        the worst case; the slot grows on demand during decode."""
        return self._pages_for(self._saved_len(req) + self.pcfg.Lt)

    def _prompt_bucket(self, n: int, min_bucket: int = 64) -> int:
        """Admission bucket covering n: powers of two up to admit_chunk,
        multiples of admit_chunk above. Policy, not shape: a bucket above
        admit_chunk takes the chunked path, and long prompts of one bucket
        that wait together admit as a group."""
        if n > self.admit_chunk:
            return -(-n // self.admit_chunk) * self.admit_chunk
        b = min_bucket
        while b < n:
            b *= 2
        return b

    def _take(self, req: Request, slot: int):
        """Fold a preempted request's stash into its prompt and allocate."""
        saved = self._preempt_saved.pop(req.rid, [])
        prompt = np.concatenate([np.asarray(req.prompt, np.int64), np.asarray(saved, np.int64)])
        need = self._pages_for(len(prompt) + self.pcfg.Lt)
        self._do_allocate(slot, need)
        self.slot_pages[slot] = need
        return prompt, saved

    def _seat(self, req: Request, slot: int, n: int, saved: List[int], tok: int) -> None:
        self.slot_req[slot] = req
        self.slot_generated[slot] = saved + [tok]
        self.slot_pos[slot] = n
        self.slot_codes[slot] = n - (n % 4)  # the aligned prefix is in pages
        self.slot_r[slot] = n % 4
        self.slot_sent[slot] = len(saved) + 1
        self.slot_order.append(slot)

    def _admit_one(self, req: Request, slot: int) -> None:
        prompt, saved = self._take(req, slot)
        n = len(prompt)
        if self._prompt_bucket(n) > self.admit_chunk:
            logits, _ = paged_admit_chunked(
                self.params, self.cfg, self.pcfg, slot, prompt, self.state, self.tables,
                chunk=self.admit_chunk, mesh=self.mesh)
        else:
            ids = torch.from_numpy(prompt[None]).to(self.device)
            logits, _ = paged_prefill_seq(
                self.params, self.cfg, self.pcfg, slot, ids, self.state, self.tables, mesh=self.mesh)
        tok = self._sample(logits)  # (1,)
        self.last_token[slot] = tok[0]
        self._seat(req, slot, n, saved, int(tok[0]))

    def _admit_group(self, reqs, slots) -> None:
        """Admit equal-bucket long prompts TOGETHER through one batched
        chunked pass: the per-chunk transformer costs amortize over the
        group."""
        entries = [(req, slot, *self._take(req, slot)) for req, slot in zip(reqs, slots)]
        # per-chunk activation transients scale with group size x chunk;
        # shrink the chunk so the product stays within ~2x the single-slot
        # budget
        chunk_eff = self.admit_chunk
        while len(entries) * chunk_eff > 2 * self.admit_chunk and chunk_eff > 512:
            chunk_eff //= 2
        logits, _ = paged_admit_chunked_batch(
            self.params, self.cfg, self.pcfg, [slot for _, slot, _, _ in entries],
            [p for _, _, p, _ in entries], self.state, self.tables, chunk=chunk_eff, mesh=self.mesh)
        toks = self._sample(logits)  # (S,)
        self.last_token[torch.tensor(slots, device=self.device)] = toks
        toks_host = toks.tolist()
        for i, (req, slot, prompt, saved) in enumerate(entries):
            self._seat(req, slot, len(prompt), saved, int(toks_host[i]))

    def _try_admit(self) -> None:
        while self.waiting:
            slot = self._free_slot()
            if slot is None:
                return
            # head first; if blocked, skip ahead within a bounded window so
            # a small request can use the gap (head is retried every tick,
            # so it cannot be starved by the skips)
            pick = None
            for j, req in enumerate(self.waiting[: self.admit_skip_window]):
                if self._fits_fresh([self._admission_need(req)]):
                    pick = j
                    break
            if pick is None:
                return
            req = self.waiting.pop(pick)
            n_req = self._saved_len(req)
            bucket = self._prompt_bucket(n_req)
            if bucket > self.admit_chunk and self.admit_batch > 1:
                # pull same-bucket waiters while free slots and pages allow.
                # Group members must pad to the SAME length at the FINEST
                # auto-scaled chunk (512): a slot whose real end falls before
                # the group's last chunk would get garbage tail rows and
                # last-position logits
                g = min(self.admit_chunk, 512)
                bg = -(-n_req // g)
                group, slots = [req], [slot]
                needs = [self._admission_need(req)]
                free_slots = [i for i, r in enumerate(self.slot_req) if r is None and i != slot]
                k = 0
                while free_slots and k < len(self.waiting) and len(group) < self.admit_batch:
                    cand = self.waiting[k]
                    n_c = self._saved_len(cand)
                    need_c = self._admission_need(cand)
                    if (self._prompt_bucket(n_c) == bucket and -(-n_c // g) == bg
                            and self._fits_fresh(needs + [need_c])):
                        needs.append(need_c)
                        group.append(self.waiting.pop(k))
                        slots.append(free_slots.pop(0))
                    else:
                        k += 1
                self._admit_group(group, slots)
            else:
                self._admit_one(req, slot)

    # ---------------- pipelined token processing ---------------------------
    def drain(self) -> None:
        """Process every in-flight tick's tokens so slot_generated and the
        retirement state are current. Callers that stop stepping
        must call this; run_to_completion, preemption and idle steps drain
        automatically."""
        self._process_pending()

    def _process_pending(self, limit: Optional[int] = None) -> None:
        """Read queued ticks' sampled tokens (oldest first) and run the
        token-dependent bookkeeping (generated lists, EOS / length
        retirement). Called after newer ticks are dispatched, so the wait
        for the copy overlaps device compute. limit=None drains everything;
        an int keeps at most that many ticks in flight."""
        while self._pending and (limit is None or len(self._pending) > limit):
            tick = self._pending.pop(0)
            if tick.ready is not None:
                tick.ready.synchronize()
            for row in tick.tokens.numpy():  # (k, S): k chained sub-ticks
                for slot, rid in tick.entries:
                    req = self.slot_req[slot]
                    if req is None or req.rid != rid:
                        # retired (possibly by an earlier sub-tick of this
                        # chain), preempted or re-admitted since dispatch
                        continue
                    tok = int(row[slot])
                    self.slot_generated[slot].append(tok)
                    if (len(self.slot_generated[slot]) >= req.max_new_tokens
                            or (req.eos_id is not None and tok == req.eos_id)):
                        self._retire(slot)

    # ---------------- preemption & on-demand growth ------------------------
    def _clear_slot(self, slot: int) -> None:
        self._do_free(slot)
        self.slot_req[slot] = None
        self.slot_generated[slot] = []
        self.slot_pos[slot] = 0
        self.slot_pages[slot] = 0
        self.slot_codes[slot] = 0
        self.slot_r[slot] = 0
        self.slot_sent[slot] = 0
        self.slot_order.remove(slot)

    def _preempt(self, slot: int) -> None:
        """Recompute-preempt `slot`: free its pages, stash its generated
        tokens, and re-queue the request at the FRONT of the waiting list.
        On re-admission the stash is folded into the prefill, so emitted
        tokens survive the preemption."""
        self._process_pending()  # in-flight tokens must reach the stash
        req = self.slot_req[slot]
        if req is None:
            return  # draining the pipeline already retired it
        self._preempt_saved[req.rid] = list(self.slot_generated[slot])
        self._clear_slot(slot)
        self.waiting.insert(0, req)
        self.preemptions += 1

    def _grow_for_flush(self) -> None:
        """Allocate pages ahead of any slot whose window flush fires THIS
        tick (slot_r == Lt: flush_paged_slots will write Lt more codes; an
        unallocated table entry would leak them to the scratch page, so
        growth must land first). Preempts the youngest slot when the pool is
        dry."""
        for i in list(self.slot_order):
            if self.slot_req[i] is None:
                continue
            pending = self.pcfg.Lt if self.slot_r[i] >= self.pcfg.Lt else 0
            need = self._pages_for(int(self.slot_codes[i]) + pending)
            grow = need - int(self.slot_pages[i])
            if grow <= 0:
                continue
            if need > self.pcfg.pages_per_seq:
                raise RuntimeError(
                    f"slot {i} needs {need} pages > pages_per_seq "
                    f"({self.pcfg.pages_per_seq}); raise pages_per_seq")
            while not self._fits_grow(i, grow):
                if len(self.slot_order) == 1:
                    raise RuntimeError(
                        "pool exhausted with a single active sequence; "
                        "n_pages is too small for this request")
                # the YOUNGEST active slot pays, possibly the requester
                # itself, preserving oldest-first service
                youngest = self.slot_order[-1]
                self._preempt(youngest)
                if youngest == i:
                    break
            if self.slot_req[i] is None:
                continue  # preempted itself; re-queued for later
            self._do_allocate(i, grow)
            self.slot_pages[i] += grow

    # ---------------- one decode tick --------------------------------------
    @torch.no_grad()
    def _chained_ticks(self, k: int, n_bound: int) -> torch.Tensor:
        """k decode steps back to back, none of which waits for the device:
        positions come from the device counters (seq_n_codes + seq_r, which
        the step itself advances), tokens are sampled on the device and fed
        to the next step. Returns the (k, S) tokens, still on the device."""
        toks = []
        tok = self.last_token
        for _ in range(k):
            logits = paged_decode_step(self.params, self.cfg, self.pcfg, tok, None, self.state,
                                       self.tables, n_bound=n_bound, mesh=self.mesh)
            tok = self._sample(logits)
            toks.append(tok)
        self.ticks_dispatched += k
        return torch.stack(toks)

    def step(self) -> int:
        """Admit what fits, flush any full residual windows (grow pages
        first), then decode k chained tokens for every active slot (k=1
        when requests are waiting to admit; up to tick_chain otherwise).
        Returns the number of tokens dispatched (active slots x k). With
        `pipeline` (default), the sampled tokens of tick t are read after
        tick t+pipeline_depth is dispatched."""
        self._try_admit()
        self._grow_for_flush()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            self._process_pending()  # drain when going idle
            return 0

        # window-flush batching: encode and write full windows ONCE per Lt
        # tokens per slot; the decode step itself never encodes
        flushing = [i for i in active if self.slot_r[i] >= self.pcfg.Lt]
        if flushing:
            mask = torch.zeros(self.pcfg.max_seqs, dtype=torch.bool)
            mask[flushing] = True
            if self.device.type == "cuda":  # a pageable copy would wait for the queued ticks
                mask = mask.pin_memory().to(self.device, non_blocking=True)
            flush_paged_slots(self.pcfg, self.state, self.tables, mask, mesh=self.mesh)
            for i in flushing:
                self.slot_codes[i] += self.pcfg.Lt
                self.slot_r[i] = 0

        # the launch bound of the paged kernel, from the host page mirrors:
        # short sequences do not pay for pages_per_seq pages of grid
        n_bound = max(int(self.slot_pages[i]) for i in active) * self.pcfg.page_size
        # chain length: > 1 only when nothing is waiting (admission latency
        # stays one tick); bounded so (a) no residual window fills mid-chain
        # (flush and page growth are host-side) and (b) the chain stops once
        # EVERY active slot has reached its token budget (per-slot overshoot
        # within the chain is discarded by the rid-guarded pending queue)
        k = 1
        if self.tick_chain > 1 and not self.waiting:
            max_r = max(int(self.slot_r[i]) for i in active)
            rem = max(int(self.slot_req[i].max_new_tokens - self.slot_sent[i]) for i in active)
            k = max(1, min(self.tick_chain, self.pcfg.Lt - max_r, rem))
        toks = self._chained_ticks(k, n_bound)
        for i in active:
            self.slot_pos[i] += k
            self.slot_r[i] += k  # a full window flushes at the NEXT tick
            self.slot_sent[i] += k
        self.last_token = toks[k - 1].clone()  # admissions write into it
        if self.device.type == "cuda":
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = toks.clone(), None
        self._pending.append(_PendingTick(host, ready, [(i, self.slot_req[i].rid) for i in active]))
        # this tick is dispatched; reading older ticks' tokens now overlaps
        # their copy with device compute (pipeline=False processes everything
        # at once, the synchronous behaviour)
        self._process_pending(limit=self.pipeline_depth if self.pipeline else 0)
        return len(active) * k

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.finished.append(FinishedRequest(
            rid=req.rid, tokens=np.asarray(self.slot_generated[slot], np.int32),
            prompt_len=len(req.prompt)))
        self._clear_slot(slot)

    def stats(self) -> Dict:
        """Serving observability: pool and slot state plus queue depths.
        Reads the bookkeeping arrays back (waits for the device)."""
        s = paged_cache_stats(self.state, self.pcfg)
        if s["page_table_errors"]:
            # the -1 exhaustion sentinel reached the device table: host
            # mirrors diverged from device state and codes are being routed
            # to the scratch page. Fail loud: this is data loss.
            raise RuntimeError(
                f"page-table corruption: {s['page_table_errors']} unallocated (-1) entries "
                "inside active sequences' ranges: allocate_pages exhausted the pool behind "
                "the scheduler's host accounting")
        s["waiting_requests"] = len(self.waiting)
        s["finished_requests"] = len(self.finished)
        s["in_flight"] = sum(r is not None for r in self.slot_req)
        s["preemptions"] = self.preemptions
        return s

    def run_to_completion(self, max_ticks: int = 100000) -> List[FinishedRequest]:
        ticks = 0
        while (self.waiting or any(r is not None for r in self.slot_req)) and ticks < max_ticks:
            advanced = self.step()
            ticks += 1
            if advanced == 0 and self.waiting:
                raise RuntimeError(
                    "scheduler stalled: waiting requests but nothing admissible "
                    "(pool too small for the smallest request?)")
        # a max_ticks exit can leave the final tick's tokens in the
        # pipeline: drain so callers see every emitted token
        self.drain()
        return self.finished


class ShardedScheduler(Scheduler):
    """Continuous batching over the mesh-sharded page pool
    (parallel/paged_sharded.py): every slot's codes are sequence-sharded over
    the mesh's ("dcn", "sp") axes in contiguous token ranges and head-sharded
    over tp; decode ticks, window flushes and chunked admission run the
    kernels per shard with the two-collective LSE merge.

    What changes against Scheduler is the allocator: pages live in per-shard
    slabs, so placement is host-side, on per-shard free maps (`h_used`
    (n_sp, P_l)) and a host page table of LOCAL ids (`h_table`); the shard
    that owns table position j is j // pps_l. Each rank uploads its own
    columns of the table on the (rare) allocation events. Admission policy,
    skip-ahead, preemption, the pipelined multi-tick loop and checkpoints are
    inherited. Every rank constructs it with the same arguments and submits
    the same requests."""

    def __init__(self, params, cfg, pcfg, tables, *args, mesh=None, **kw):
        from million_tpu_torch.parallel.paged_sharded import paged_shard_info

        if mesh is None:
            raise ValueError("ShardedScheduler requires a mesh")
        n_sp, P_l, pps_l, _ = paged_shard_info(pcfg, mesh)
        self._n_sp, self._P_l, self._pps_l = n_sp, P_l, pps_l
        self.h_used = np.zeros((n_sp, P_l), bool)
        self.h_table = np.full((pcfg.max_seqs, pcfg.pages_per_seq), -1, np.int32)
        self.h_alloc = np.zeros(pcfg.max_seqs, np.int64)
        kw.setdefault("device", mesh.device)
        super().__init__(params, cfg, pcfg, tables, *args, mesh=mesh, **kw)

    def _init_state(self):
        from million_tpu_torch.parallel.paged_sharded import init_sharded_paged_state

        return init_sharded_paged_state(self.pcfg, self.mesh)

    # ---- host page placement -------------------------------------------
    def _upload_tables(self) -> None:
        s = self.mesh.seq_index
        cols = self.h_table[:, s * self._pps_l:(s + 1) * self._pps_l]
        self.state["page_table"].copy_(torch.from_numpy(np.ascontiguousarray(cols)))
        self.state["used"].copy_(torch.from_numpy(self.h_used[s].astype(np.int32)))
        self.state["seq_n_pages"].copy_(torch.from_numpy(self.h_alloc.astype(np.int32)))

    def _do_allocate(self, slot: int, k: int) -> None:
        start = int(self.h_alloc[slot])
        for j in range(start, start + k):
            s = j // self._pps_l
            free = np.flatnonzero(~self.h_used[s])
            if len(free) == 0:
                raise RuntimeError(
                    f"shard {s} pool exhausted allocating table position {j} of slot {slot} "
                    "(guarded by _fits_*; host / scheduler accounting diverged)")
            self.h_used[s, free[0]] = True
            self.h_table[slot, j] = free[0]
        self.h_alloc[slot] += k
        self._upload_tables()

    def _do_free(self, slot: int) -> None:
        for j in range(int(self.h_alloc[slot])):
            pid = self.h_table[slot, j]
            if pid >= 0:
                self.h_used[j // self._pps_l, pid] = False
        self.h_table[slot] = -1
        self.h_alloc[slot] = 0
        self._upload_tables()
        for k in ("seq_n_codes", "seq_r", "seq_active"):
            self.state[k][slot].fill_(0)

    # ---- per-shard capacity arithmetic ---------------------------------
    def _shard_demand(self, start: int, k: int) -> np.ndarray:
        """Pages demanded per shard by table positions [start, start + k)."""
        d = np.zeros(self._n_sp, np.int64)
        for j in range(start, start + k):
            d[j // self._pps_l] += 1
        return d

    def _fits_fresh(self, needs) -> bool:
        if any(k > self.pcfg.pages_per_seq for k in needs):
            return False
        free_s = self._P_l - self.h_used.sum(axis=1)
        demand = np.zeros(self._n_sp, np.int64)
        for k in needs:
            demand += self._shard_demand(0, k)
        return bool((demand <= free_s).all())

    def _fits_grow(self, slot: int, grow: int) -> bool:
        free_s = self._P_l - self.h_used.sum(axis=1)
        return bool((self._shard_demand(int(self.h_alloc[slot]), grow) <= free_s).all())

    def _free_pages(self) -> int:
        return self.pcfg.n_pages - int(self.h_used.sum())

    def stats(self) -> Dict:
        """Pool and slot state from the host allocator (no device read: a
        slab's table columns alone cannot tell a shard's unallocated tail
        from corruption)."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        errors = sum(int((self.h_table[i, :self.h_alloc[i]] < 0).sum()) for i in active)
        if errors:
            raise RuntimeError(f"page-table corruption: {errors} unallocated entries inside "
                               "active sequences' ranges")
        used = int(self.h_used.sum())
        return {"pages_total": self.pcfg.n_pages, "pages_used": used,
                "pages_free": self.pcfg.n_pages - used,
                "pages_used_per_shard": self.h_used.sum(axis=1).tolist(),
                "active_seqs": len(active), "page_table_errors": 0,
                "waiting_requests": len(self.waiting), "finished_requests": len(self.finished),
                "in_flight": len(active), "preemptions": self.preemptions}

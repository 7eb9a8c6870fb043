"""One run of one cell: set-up, the measured window, the traced segment,
the follow-up of the window's requests, and the check against the plain
reference. Whatever differs between cells comes from the cell's files: the
weights, the reference and the port's configuration from its
architecture's (manifest.load_architecture).

Phases, each a list of scheduler steps (system.Probe.step):
  setup   closed mix: every request submitted and admitted, then
          `warm_steps` steps; open mix: the mix's `warmup` requests served
          to their end on the same scheduler.
  window  `seconds` of serving, timed on the host clock; an open mix
          submits each request when it is due (between steps) and sleeps
          when nothing is active or waiting.
  trace   (--trace 1) `trace_seconds` more under torch.profiler.
  follow  an open mix serves on until every request due in the window has
          finished (at most `follow_seconds`).
Then every dispatched token is read back, the peak memory read, the
program's state freed, and a sample of the requests compared with the
reference.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import inputs, system, traffic
from perfbench.manifest import Cell


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc), or
    since the harness module was first imported where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclasses.dataclass
class Step:
    phase: str
    t0: float
    t1: float
    dispatched: int
    calls: object  # system.StepCalls


@dataclasses.dataclass
class Req:
    rid: int
    prompt: np.ndarray
    max_new: int
    due: Optional[float]  # host clock; None: submitted in set-up
    submitted: Optional[float] = None
    first: Optional[float] = None
    finish: Optional[float] = None
    tokens: Optional[np.ndarray] = None


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (metrics/<name>.py: read(run))."""
    config: dict  # the configuration file: the published keys at its top, "pq", "paging"
    plain: ModuleType  # the architecture's reference/<architecture>.py: pq_layers, token_flops, prompt_flops
    setup_s: float
    t0: float  # window start (host clock)
    t1: float  # window end: the end of its last step
    steps: List[Step]
    requests: Dict[int, Req]
    tokens_in_window: int
    memory_peak_bytes: int
    trace: Optional[object] = None  # trace.TraceSummary of the traced segment

    def phase_steps(self, phase: str) -> List[Step]:
        return [s for s in self.steps if s.phase == phase]

    def window_requests(self) -> List[Req]:
        return [r for r in self.requests.values() if r.due is not None and self.t0 <= r.due < self.t1]


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
                 rate: Optional[float] = None):
        self.cell, self.seconds, self.trace, self.device = cell, seconds, trace, torch.device(device)
        self.mix, self.config = cell.traffic, cell.config
        ss = np.random.SeedSequence(seed)
        s_w, s_t, s_r, s_sched, s_sample = ss.spawn(5)
        self.sample_rng = np.random.default_rng(s_sample)
        if self.device.type == "cuda":
            system.build_kernels()
            torch.cuda.reset_peak_memory_stats()
        self.weights = cell.plain.make_weights(self.config, s_w, self.device)
        self.tables = inputs.make_codebooks(self.config, cell.plain.pq_layers(self.config), s_t, self.device)
        horizon = seconds + float(self.mix.get("trace_seconds", 0)) + float(self.mix.get("follow_seconds", 0))
        self.specs = traffic.generate(self.mix, s_r, self.config["vocab_size"], horizon, rate=rate)
        self.sched = system.make_scheduler(cell.program, self.config, self.mix, self.weights, self.tables,
                                           self.device, inputs.torch_seed(s_sched))
        self.probe = system.Probe(self.sched)
        self.steps: List[Step] = []
        self.reqs: Dict[int, Req] = {}
        self.queued: set = set()  # submitted, first token not yet out
        self.n_finished_seen = 0
        self.pending = []  # open mix: specs not yet submitted, by due time

    # ---- serving -----------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _submit(self, spec, due: Optional[float]) -> None:
        now = time.perf_counter()
        self.sched.submit(system.Request(spec.rid, spec.prompt, spec.max_new))
        self.reqs[spec.rid] = Req(spec.rid, spec.prompt, spec.max_new, due, submitted=now)
        self.queued.add(spec.rid)

    def _step(self, phase: str) -> Step:
        t0, t1, n, calls = self.probe.step()
        st = Step(phase, t0, t1, n, calls)
        self.steps.append(st)
        if self.queued:
            waiting = {r.rid for r in self.sched.waiting}
            for rid in [r for r in self.queued if r not in waiting]:
                self.reqs[rid].first = t1
                self.queued.discard(rid)
        for f in self.sched.finished[self.n_finished_seen:]:
            if f.rid in self.reqs:
                self.reqs[f.rid].finish, self.reqs[f.rid].tokens = t1, f.tokens
        self.n_finished_seen = len(self.sched.finished)
        return st

    def _active(self) -> bool:
        return bool(self.sched.waiting) or any(r is not None for r in self.sched.slot_req)

    def _serve(self, phase: str, until: float, done=None) -> None:
        """Serve until the host clock passes `until` (or done() holds)."""
        while True:
            now = time.perf_counter()
            if now >= until or (done is not None and done()):
                return
            while self.pending and self.pending[0][0] <= now:
                due, spec = self.pending.pop(0)
                self._submit(spec, due)
            if self._active():
                self._step(phase)
                continue
            nxt = self.pending[0][0] if self.pending else until
            with self.probe.span("harness.sleep"):
                time.sleep(max(0.0, min(nxt, until) - now))

    def tokens_read(self) -> int:
        s = self.sched
        return sum(len(g) for g in s.slot_generated) + sum(len(f.tokens) for f in s.finished)

    def setup(self) -> None:
        if self.mix["kind"] == "closed":
            for spec in self.specs:
                self._submit(spec, None)
            while self.sched.waiting:
                self._step("setup")
            for _ in range(int(self.mix.get("warm_steps", 2))):
                self._step("setup")
        else:
            for i, w in enumerate(self.mix.get("warmup", [])):
                self.sched.submit(system.Request(-1 - i, np.zeros(int(w["prompt"]), np.int64),
                                                 int(w["output"])))
                while self._active():
                    self._step("setup")
            self.sched.drain()
        self._sync()

    def serve(self) -> dict:
        self.setup()
        t0 = time.perf_counter()
        setup_s = process_age_s()
        if self.mix["kind"] == "open":
            self.pending = [(t0 + s.due, s) for s in self.specs]
        tok0 = self.tokens_read()
        log(f"set-up {setup_s:.3f} s ({len(self.steps)} steps)")
        self._serve("window", t0 + self.seconds)
        t1 = self.steps[-1].t1 if self.steps and self.steps[-1].phase == "window" else time.perf_counter()
        tokens = self.tokens_read() - tok0
        w = [s for s in self.steps if s.phase == "window"]
        log(f"window {t1 - t0:.3f} s: {len(w)} steps, {sum(len(s.calls.ticks) for s in w)} ticks, "
            f"{sum(len(a.lens) for s in w for a in s.calls.admissions)} admitted, {tokens} tokens read")
        summary = None
        if self.trace:
            summary = self._traced(float(self.mix["trace_seconds"]))
        if self.mix["kind"] == "open":
            def done():  # every request due in the window submitted and finished
                return ((not self.pending or self.pending[0][0] >= t1)
                        and all(r.finish is not None for r in self.reqs.values() if r.due < t1))
            self._serve("follow", time.perf_counter() + float(self.mix["follow_seconds"]), done=done)
        self.sched.drain()
        self._sync()
        t_end = time.perf_counter()
        for f in self.sched.finished[self.n_finished_seen:]:  # retired by the drain
            if f.rid in self.reqs:
                self.reqs[f.rid].finish, self.reqs[f.rid].tokens = t_end, f.tokens
        self._collect_unfinished()
        errors = self._page_table_errors()
        return dict(t0=t0, t1=t1, setup_s=setup_s, tokens=tokens, trace=summary,
                    page_table_errors=errors, preemptions=self.sched.preemptions)

    def _traced(self, seconds: float):
        from perfbench import trace as trace_mod

        # device activity only: recording every host operation as well slows
        # the host enough to idle the card; the probe's spans label the gaps
        acts = [torch.profiler.ProfilerActivity.CUDA if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        self.probe.tracing = True
        with torch.profiler.profile(activities=acts) as prof:
            a, a_us = time.perf_counter(), time.time_ns() / 1e3
            self._serve("trace", a + seconds)
            self._sync()
            b, b_us = time.perf_counter(), time.time_ns() / 1e3
        self.probe.tracing = False
        c = time.perf_counter()
        out = trace_mod.summarize(prof, b - a, self.probe.spans)
        log(f"traced {b - a:.3f} s: {out.n_ops} device operations, busy {out.busy_s:.3f} s, "
            f"read in {time.perf_counter() - c:.1f} s; device ops from {out.span_us[0] - a_us:.0f} us "
            f"after the segment's start to {b_us - out.span_us[1]:.0f} us before its end")
        return out

    def _collect_unfinished(self) -> None:
        """The served tokens so far of requests still in a slot."""
        for i, r in enumerate(self.sched.slot_req):
            if r is not None and r.rid in self.reqs:
                self.reqs[r.rid].tokens = np.asarray(self.sched.slot_generated[i], np.int64)

    def _page_table_errors(self) -> int:
        try:
            return int(self.sched.stats()["page_table_errors"])
        except RuntimeError as e:  # stats() refuses a corrupt table
            log(f"page table: {e}")
            return 1

    def chunks_by_rid(self) -> Dict[int, Optional[int]]:
        """The admission chunk each request was admitted with; a request
        admitted twice (preempted) maps to -1 and is not compared."""
        out: Dict[int, Optional[int]] = {}
        for st in self.steps:
            for adm in st.calls.admissions:
                for rid in adm.rids:
                    out[rid] = -1 if rid in out else adm.chunk
        return out

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.probe.close()
        del self.sched
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def choose_sample(reqs: List[Req], k: int, rng: np.random.Generator) -> List[Req]:
    """k requests: the requests in rid order cut into k strata, one drawn
    from each by the seed, and the longest (prompt + served tokens) in the
    stratum that holds it."""
    reqs = sorted(reqs, key=lambda r: r.rid)
    if not reqs:
        return []
    longest = max(reqs, key=lambda r: (len(r.prompt) + len(r.tokens), -r.rid))
    out = []
    for part in np.array_split(np.arange(len(reqs)), min(k, len(reqs))):
        group = [reqs[i] for i in part]
        out.append(longest if longest in group else group[int(rng.integers(len(group)))])
    return out


class _Tally:
    """One side's numbers over the sample: the served token (or, for the
    fp8 reference, its own argmax) and that side's logit of it, against the
    f32 reference's logits at each position."""

    def __init__(self):
        self.gap = self.err = self.sq = 0.0
        self.n = self.agree = 0

    def add(self, lg: torch.Tensor, tok: torch.Tensor, mine: torch.Tensor) -> None:
        got = lg.gather(1, tok[:, None])[:, 0]
        self.gap = max(self.gap, float((lg.max(dim=-1).values - got).max()))
        self.err = max(self.err, float((mine - got).abs().max()))
        self.sq += float((mine - got).double().square().sum())
        self.agree += int((lg.argmax(-1) == tok).sum())
        self.n += len(tok)

    def numbers(self, fp8: Optional["_Tally"]) -> dict:
        n = max(self.n, 1)
        out = {"logit_gap_max": self.gap, "logit_err_max": self.err, "logit_err_rms": (self.sq / n) ** 0.5,
               "tokens_compared": self.n, "argmax_agree": self.agree / n}
        if fp8 is not None:
            out["logit_err_vs_fp8"] = self.err / max(fp8.err, 1e-30)
        return out


def check(run: Run, sample: List[Req], chunks: Dict, logits: Dict, fp8: bool, control: bool) -> dict:
    """Over the sample's served tokens, against the f32 reference: the
    widest gap by which a served token's reference logit lies below the
    reference's best, and the widest and the root-mean-square difference
    between the program's logit of a served token and the reference's.

    With `fp8` the reference also runs with fp8 products over the same
    prompts and served tokens, and `logit_err_vs_fp8` is the program's widest
    difference over that of the fp8 reference (its own argmax and logit at
    each position): how far the program lies from the reference, in units of
    how far fp8 products lie on the same weights and tokens, which cancels
    the scale each seed's weights give the logits.

    With `control` the fp8 reference is put in the program's place: its
    argmax and logit stand for the served token and the program's logit (so
    `logit_err_vs_fp8` reads 1), and the program's own numbers are returned
    under "program"."""
    Lt = run.config["paging"]["Lt"]
    Reference = run.cell.plain.Reference
    ref = Reference(run.weights, run.config, run.tables)
    low = Reference(run.weights, run.config, run.tables, precision="fp8") if fp8 or control else None
    prog, ctl = _Tally(), _Tally()
    for r in sample:
        t = time.perf_counter()
        served = np.asarray(r.tokens, np.int64)
        lg = ref.logits(r.prompt, served, chunks[r.rid], Lt)
        prog.add(lg, torch.as_tensor(served, device=lg.device),
                 torch.as_tensor(logits[r.rid][:len(served)], device=lg.device))
        if low is not None:
            top = low.logits(r.prompt, served, chunks[r.rid], Lt).max(dim=-1)
            ctl.add(lg, top.indices, top.values)
            del top
        del lg
        log(f"reference: request {r.rid} ({len(r.prompt)} + {len(served)} tokens) in "
            f"{time.perf_counter() - t:.1f} s")
    fp8_side = ctl if low is not None else None
    if control:
        return {**ctl.numbers(fp8_side), "program": prog.numbers(fp8_side)}
    return prog.numbers(fp8_side)

"""The system under test: million_tpu_torch's serving path, built from a
configuration (through its architecture's programs/<architecture>.py) and a
mix, and a probe on the scheduler's calls.

Beside programs/*.py this is the one file of the benchmark that imports the
port, and it names no model. The probe
replaces, while a run lasts, the names the scheduler module calls
(paged_decode_step, flush_paged_slots, paged_admit_chunked[_batch],
paged_prefill_seq) by wrappers that call them unchanged and record what
they were asked to do, from the arguments and the scheduler's host mirrors
(no device read): per decode tick the live slots' code counts, residual
rows and positions; per admission its slots, prompt lengths and chunk. The
reference takes the admission chunk from there (the program's own choice of
which tokens it attends quantized); the roofline and FLOP readers take the
shapes. The sampling call (sample_on_mesh) is wrapped too: the logit of each
sampled token is gathered on the device (one small gather a call) and kept
by request, for the check against the reference's logit of that token. While a segment is traced each wrapped call is also a named span on
the host's wall clock (time.time_ns, the clock of the profiler's device
events), which labels the device's idle gaps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
from typing import List, Optional

import torch

from million_tpu_torch.runtime import scheduler as sched_mod
from million_tpu_torch.runtime.sampling import SamplingConfig
from million_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: F401 (Request: the driver's)

LIBRARIES = ("pq_paged_attention", "pq_chunk_attention", "pq_encode", "causal_attention")


def build_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA libraries, in
    parallel, so that no measured step pays for nvcc."""
    from concurrent.futures import ThreadPoolExecutor

    from million_tpu_torch.ops.cuda_build import build

    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        list(pool.map(build, LIBRARIES))


def make_scheduler(program, config: dict, mix: dict, params, tables, device, seed: int) -> Scheduler:
    """The port's Scheduler of this configuration and mix; `program` is the
    architecture's programs/<architecture>.py (model_config, cache_config)."""
    paging = config["paging"]
    return Scheduler(params, program.model_config(config), program.cache_config(config, mix), tables,
                     SamplingConfig(), seed=seed, admit_chunk=paging["admit_chunk"],
                     admit_batch=paging["admit_batch"], tick_chain=paging["tick_chain"],
                     device=device)


@dataclasses.dataclass
class Tick:
    codes: List[int]  # quantized tokens of each live slot
    rows: List[int]  # exact residual rows each live slot attends
    positions: List[int]  # the position of each live slot's token


@dataclasses.dataclass
class Admission:
    slots: List[int]
    lens: List[int]
    chunk: Optional[int]  # None: one-shot exact prefill
    rids: List[Optional[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StepCalls:
    ticks: List[Tick] = dataclasses.field(default_factory=list)
    admissions: List[Admission] = dataclasses.field(default_factory=list)
    flushes: int = 0
    sampled: List[tuple] = dataclasses.field(default_factory=list)  # (offset, slots), rows in slot order


class Probe:
    """Wraps the scheduler module's calls for the life of a run (close()
    puts the originals back)."""

    NAMES = ("paged_decode_step", "flush_paged_slots", "paged_admit_chunked",
             "paged_admit_chunked_batch", "paged_prefill_seq")

    def __init__(self, sched: Scheduler):
        self.sched = sched
        self.tracing = False
        self.spans: List[tuple] = []  # (start us, end us, name) while tracing
        self.cur = StepCalls()
        self._rows_of_next_sample: List[int] = []  # slots the next sampled rows belong to
        self._logits: List[torch.Tensor] = []  # per sampling call: the sampled tokens' logits
        self._n_logits = 0
        self._index: dict = {}  # rid -> positions in the concatenated logits, in order
        self._orig = {n: getattr(sched_mod, n) for n in (*self.NAMES, "sample_on_mesh")}
        for n in self.NAMES:
            setattr(sched_mod, n, self._wrap(n, self._orig[n]))
        sched_mod.sample_on_mesh = self._wrap_sample(self._orig["sample_on_mesh"])

    def close(self) -> None:
        for n, f in self._orig.items():
            setattr(sched_mod, n, f)

    def span(self, name: str):
        return self._record(name) if self.tracing else contextlib.nullcontext()

    @contextlib.contextmanager
    def _record(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t / 1e3, time.time_ns() / 1e3, name))

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)
        note = getattr(self, "_note_" + name)

        def wrapped(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            note(bound.arguments)
            with self.span(name):
                return fn(*args, **kwargs)

        return wrapped

    def _wrap_sample(self, fn):
        def wrapped(logits, *args, **kwargs):
            tok = fn(logits, *args, **kwargs)
            self._logits.append(logits.gather(-1, tok.view(-1, 1).to(logits.device))[:, 0].float())
            self.cur.sampled.append((self._n_logits, self._rows_of_next_sample))
            self._n_logits += tok.numel()
            return tok

        return wrapped

    def _note_paged_decode_step(self, a) -> None:
        s, j = self.sched, len(self.cur.ticks)
        live = [i for i, r in enumerate(s.slot_req) if r is not None]
        self.cur.ticks.append(Tick([int(s.slot_codes[i]) for i in live],
                                   [int(s.slot_r[i]) + j + 1 for i in live],
                                   [int(s.slot_pos[i]) + j for i in live]))
        self._rows_of_next_sample = list(range(len(s.slot_req)))

    def _note_flush_paged_slots(self, a) -> None:
        self.cur.flushes += 1

    def _note_paged_admit_chunked(self, a) -> None:
        self._admitted(Admission([int(a["seq_id"])], [len(a["prompt"])], int(a["chunk"])))

    def _note_paged_admit_chunked_batch(self, a) -> None:
        self._admitted(Admission([int(s) for s in a["seq_ids"]], [len(p) for p in a["prompts"]],
                                 int(a["chunk"])))

    def _note_paged_prefill_seq(self, a) -> None:
        self._admitted(Admission([int(a["seq_id"])], [int(a["input_ids"].shape[1])], None))

    def _admitted(self, adm: Admission) -> None:
        self.cur.admissions.append(adm)
        self._rows_of_next_sample = adm.slots

    def step(self) -> tuple:
        """One Scheduler.step() with its calls: (t0, t1, tokens dispatched,
        StepCalls). Admissions learn their request ids from the seated slots."""
        self.cur = StepCalls()
        t0 = time.perf_counter()
        with self.span("Scheduler.step"):
            n = self.sched.step()
        t1 = time.perf_counter()
        calls = self.cur
        for adm in calls.admissions:
            adm.rids = [None if self.sched.slot_req[s] is None else self.sched.slot_req[s].rid
                        for s in adm.slots]
        # the requests seated at the end of the step own its sampled rows (a
        # slot retired within the step had been sampled for its own request
        # before; its rows past its last token are discarded by position)
        for off, slots in calls.sampled:
            for row, slot in enumerate(slots):
                req = self.sched.slot_req[slot]
                if req is not None:
                    self._index.setdefault(req.rid, []).append(off + row)
        return t0, t1, n, calls

    def sampled_logits(self) -> dict:
        """{rid: the program's logits of its sampled tokens, in order} (host)."""
        flat = torch.cat(self._logits).cpu().numpy() if self._logits else None
        return {rid: flat[idx] for rid, idx in self._index.items()}

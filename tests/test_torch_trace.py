"""The port's tracer (utils/profiling.py: Tracer, TRACER) and the spans and
counters runtime/scheduler.py writes into it, on the CPU at test-tiny width:
spans nest and carry their request ids, the list is bounded, nothing is
recorded unless enabled or under torch.profiler, spans and request events
show in the profiler's Chrome trace, one scheduler run covers
every span and request event with counters that agree with the scheduler's
own, and the tokens do not depend on recording. The `cuda` case runs the
same scheduler on the card (B7 launches per flush, device time per step,
every B4 score pass in the lane build).
This file imports no JAX: on the card it runs as
`python3 -m pytest tests/test_torch_trace.py -m cuda`."""

import json
import time

import numpy as np
import pytest
import torch

from million_tpu_torch.cache.paged_pq_cache import PagedPQCacheConfig
from million_tpu_torch.convert import cents_from_numpy
from million_tpu_torch.models.llama import PRESETS, init_params
from million_tpu_torch.runtime.scheduler import Request, Scheduler
from million_tpu_torch.utils.profiling import TRACER, Tracer, device_memory_report, trace

CFG = PRESETS["test-tiny"]
# two slots and a pool of three 256-token pages: the 200- and 180-token
# prompts admit as a chunked group, the 30-token one in one shot, and the
# growth of the first two preempts the youngest
PCFG = PagedPQCacheConfig(num_layers=2, nh_k=2, d=16, M=4, C=64, Lt=8, page_size=256, n_pages=3,
                          max_seqs=2, pages_per_seq=3, dtype=torch.float32, OK=4, OV=4)
LENS, NEW = (200, 180, 30, 300), (100, 100, 20, 20)


@pytest.fixture
def tracer():
    TRACER.reset()
    yield TRACER
    TRACER.disable()
    TRACER.reset()


def tables(device):
    rng = np.random.default_rng(11)
    c = {"key": rng.standard_normal((2, 4, 64, 4)).astype(np.float32),
         "value": rng.standard_normal((2, 4, 64, 4)).astype(np.float32),
         "k_outlier_idx": np.array([[1, 5, 9, 12]] * 2, np.int32),
         "v_outlier_idx": np.array([[0, 3, 7, 14]] * 2, np.int32)}
    for side, idx in (("key", c["k_outlier_idx"][0]), ("value", c["v_outlier_idx"][0])):
        for ch in idx:
            c[side][:, ch % 4, :, ch // 4] = 0.0
    return cents_from_numpy(c, device=device)


def submitted(device="cpu"):
    """A Scheduler with the four requests waiting."""
    params = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")  # the same weights on any device
    params = {k: {a: b.to(device) for a, b in v.items()} if k == "layers" else v.to(device)
              for k, v in params.items()}
    sched = Scheduler(params, CFG, PCFG, tables(device), admit_chunk=128, device=device)
    rng = np.random.default_rng(7)
    for rid, (n, new) in enumerate(zip(LENS, NEW)):
        sched.submit(Request(rid, rng.integers(0, CFG.vocab_size, n), new))
    return sched


def serve(device="cpu"):
    """The four requests through one Scheduler to their end."""
    sched = submitted(device)
    done = sched.run_to_completion(max_ticks=2000)
    return sched, {f.rid: f.tokens for f in done}


def test_spans_nest_with_parents_and_request_ids():
    tr = Tracer()
    tr.enable()
    t0 = time.time_ns()
    with tr.span("outer", "outer_ns", slots=2) as outer:
        t1 = time.time_ns()
        with tr.span("inner", rid=7) as inner:
            tr.event("request.seated", 7, slot=1)
        t2 = time.time_ns()
    t3 = time.time_ns()
    tr.event("request.finished", 7)
    by = {s.name: s for s in tr.spans}
    assert [s.name for s in tr.spans] == ["request.seated", "inner", "outer", "request.finished"]
    assert by["outer"] is outer and by["inner"] is inner
    assert outer.parent is None and inner.parent == outer.id and by["request.seated"].parent == inner.id
    assert by["request.finished"].parent is None
    assert inner.rid == by["request.seated"].rid == by["request.finished"].rid == 7 and outer.rid is None
    assert outer.attrs == {"slots": 2} and by["request.seated"].attrs == {"slot": 1}
    assert t0 <= outer.start_ns <= t1 <= inner.start_ns <= inner.end_ns <= t2 <= outer.end_ns <= t3
    assert by["request.seated"].ns == 0 and inner.start_ns <= by["request.seated"].start_ns <= inner.end_ns
    assert tr.counters["outer_ns"] == outer.ns
    assert len({s.id for s in tr.spans}) == 4


def test_span_list_is_bounded_and_counts_what_it_drops():
    tr = Tracer(max_spans=3)
    tr.enable()
    for i in range(5):
        with tr.span("s", "s_ns", i=i):
            pass
    tr.event("e")
    assert [s.attrs["i"] for s in tr.spans] == [0, 1, 2] and tr.dropped == 3
    assert tr.counters["s_ns"] >= sum(s.ns for s in tr.spans)  # the dropped spans' time is counted too
    tr.reset()
    assert not tr.spans and not tr.dropped and not tr.counters


def test_nothing_is_recorded_unless_enabled_or_profiled():
    tr = Tracer()
    with tr.span("off", "off_ns") as sp:
        tr.event("off.event")
    assert sp is None and not tr.spans and tr.counters["off_ns"] > 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("scheduler.dispatch", ticks=1):
            torch.ones(4) + 1
    assert [s.name for s in tr.spans] == ["scheduler.dispatch"] and tr.spans[0].attrs == {"ticks": 1}
    assert "scheduler.dispatch" in {e.name for e in prof.events()}
    with tr.span("after"):
        pass
    assert len(tr.spans) == 1  # the profiler has stopped
    tr.enable()
    tr.disable()
    with tr.span("disabled"):
        pass
    assert len(tr.spans) == 1


def test_events_show_in_the_chrome_trace(tmp_path):
    """Under torch.profiler an event is also an empty record_function range,
    so utils/profiling.trace(path)'s Chrome trace holds it beside the spans."""
    tr = Tracer()
    path = tmp_path / "t.json"
    with trace(str(path)):
        with tr.span("scheduler.admit", rid=3):
            tr.event("request.seated", 3, slot=0)
        tr.event("request.finished", 3)
    assert [s.name for s in tr.spans] == ["request.seated", "scheduler.admit", "request.finished"]
    names = [e.get("name") for e in json.loads(path.read_text())["traceEvents"]]
    assert {"scheduler.admit", "request.seated", "request.finished"} <= set(names)
    tr.event("request.submit", 4)  # the profiler has stopped: nothing recorded
    assert len(tr.spans) == 3


def test_scheduler_run_covers_every_span_and_counter(tracer):
    tracer.enable()
    sched, tokens = serve()
    c, names = tracer.counters, {s.name for s in tracer.spans}
    assert {"scheduler.step", "scheduler.admit", "scheduler.grow", "scheduler.flush", "scheduler.dispatch",
            "request.submit", "request.seated", "request.preempted", "request.finished"} <= names
    assert "scheduler.readback_wait" not in names and tracer.dropped == 0  # no event to wait on here
    # counters against the scheduler's own
    assert sched.preemptions >= 1 and len(tracer.named("request.preempted")) == sched.preemptions
    assert c["ticks"] == sched.ticks_dispatched == sum(s.attrs["ticks"] for s in tracer.named("scheduler.dispatch"))
    assert c["steps"] == len(tracer.named("scheduler.step"))
    flushes = tracer.named("scheduler.flush")
    assert c["flushes"] == len(flushes) > 0 and c["flushed_windows"] == sum(len(s.attrs["slots"]) for s in flushes)
    assert c["b7_launches"] == 0  # the plain encode on the CPU
    admits = tracer.named("scheduler.admit")
    assert c["admissions"] == len(LENS) + sched.preemptions == len(tracer.named("request.seated"))
    assert c["admitted_tokens"] == sum(s.attrs["tokens"] for s in admits) >= sum(LENS)
    assert c["admission_ns"] == sum(s.ns for s in admits)
    assert c["dispatch_ns"] == sum(s.ns for s in tracer.named("scheduler.dispatch"))
    assert c["wait_ns"] == c["device_ns"] == c["device_ticks"] == 0
    # one-shot and chunked admission, a group among them
    assert {s.attrs["chunk"] for s in admits} == {None, 128}
    groups = [s for s in admits if "rids" in s.attrs]
    assert any(len(s.attrs["rids"]) == 2 for s in groups)
    assert all(s.rid is None and len(s.attrs["rids"]) == len(s.attrs["slots"]) for s in groups)
    assert all(s.rid is not None and len(s.attrs["slots"]) == 1 for s in admits if s not in groups)
    assert any(s.attrs["preempted"] for s in tracer.named("scheduler.grow"))
    # the spans nest inside the steps
    ids = {s.id: s for s in tracer.spans}
    for s in tracer.spans:
        if s.name.startswith("scheduler.") and s.name != "scheduler.step":
            top = s
            while top.parent is not None:
                top = ids[top.parent]
            assert top.name == "scheduler.step", s
            assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
    for s in tracer.named("request.seated"):
        assert ids[s.parent].name == "scheduler.admit"
        assert s.rid == ids[s.parent].rid or s.rid in ids[s.parent].attrs["rids"]
    # every request: submit <= seated <= finished; the preempted come back
    for rid in range(len(LENS)):
        ev = {n: [s.start_ns for s in tracer.named("request." + n) if s.rid == rid]
              for n in ("submit", "seated", "preempted", "finished")}
        assert len(ev["submit"]) == len(ev["finished"]) == 1 and len(tokens[rid]) == NEW[rid]
        assert len(ev["seated"]) == 1 + len(ev["preempted"])
        assert ev["submit"][0] <= min(ev["seated"]) and max(ev["seated"]) <= ev["finished"][0]
        for t in ev["preempted"]:
            assert any(a <= t for a in ev["seated"]) and any(a >= t for a in ev["seated"])


def test_tokens_do_not_depend_on_recording(tracer):
    off_sched, off = serve()
    assert not tracer.spans  # no profiler, no enable(): nothing recorded
    counted = dict(tracer.counters)
    assert counted["ticks"] == off_sched.ticks_dispatched and counted["steps"] > 0
    tracer.reset()
    tracer.enable()
    _, on = serve()
    assert tracer.spans
    assert set(on) == set(off) == set(range(len(LENS)))
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid])
    assert {k: v for k, v in tracer.counters.items() if not k.endswith("_ns")} == \
        {k: v for k, v in counted.items() if not k.endswith("_ns")}


def test_stats_report_the_counters_and_the_cards_memory(tracer):
    sched, _ = serve()
    s = sched.stats()
    assert s["counters"]["ticks"] == sched.ticks_dispatched and s["counters"]["admissions"] >= len(LENS)
    assert s["preemptions"] == sched.preemptions and s["finished_requests"] == len(LENS)
    assert s["device_memory"] is None  # a CPU scheduler
    if not torch.cuda.is_available():
        assert device_memory_report() is None


def test_stats_report_no_lane_share_without_a_b4_launch(tracer):
    """A scheduler on the CPU launches no kernel, so the share of B4's score
    passes that took the lane build reads None (not 0)."""
    sched = submitted()
    for _ in range(3):
        sched.step()
    assert sched.stats()["b4_lane_share"] is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scheduler_trace_on_the_card(tracer, cuda_device):
    """Two B7 launches (key and value) per flush; every step that decoded has
    a device time above 0, which leaves out the host's pauses between steps;
    the card's tokens are the CPU's."""
    tracer.enable()
    sched, tokens = serve(cuda_device)
    c = tracer.counters
    flushes = tracer.named("scheduler.flush")
    assert flushes and all(s.attrs["b7_launches"] == 2 for s in flushes) and c["b7_launches"] == 2 * c["flushes"]
    timed = [s for s in tracer.named("scheduler.step") if "device_ns" in s.attrs]
    assert timed and all(s.attrs["device_ns"] > 0 for s in timed)
    assert c["device_ns"] == sum(s.attrs["device_ns"] for s in timed) > 0
    assert c["device_ticks"] == sum(s.attrs["device_ticks"] for s in timed)
    waits = tracer.named("scheduler.readback_wait")
    assert waits and c["wait_ns"] == sum(s.ns for s in waits)
    assert all(s.attrs["b4_launches"] == CFG.num_layers * s.attrs["ticks"]
               for s in tracer.named("scheduler.dispatch"))
    assert len(timed) == len(tracer.named("scheduler.dispatch"))
    assert sched.stats()["device_memory"]["peak_bytes_in_use"] > 0
    assert sched.stats()["b4_lane_share"] == 1.0  # d_m 4, M 4: the lane build
    tracer.reset()
    paused = submitted(cuda_device)
    for _ in range(6):
        paused.step()
        time.sleep(0.2)
    paused.drain()
    steps = [s for s in tracer.named("scheduler.step") if "device_ns" in s.attrs]
    assert len(steps) == 6 and all(0 < s.attrs["device_ns"] < 0.1e9 for s in steps)
    tracer.disable()
    _, cpu = serve()
    for rid in cpu:
        np.testing.assert_array_equal(tokens[rid], cpu[rid])

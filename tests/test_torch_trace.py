"""The port's tracer (``repro_torch/core/trace.py``): spans, self time,
frames as differences of process totals (worker threads included), the
profiler's clock shared with program spans, recordings (the counts a CUDA
graph's capture holds and each replay counts again), and the counters a
design-point query leaves in its ``offload.plan_grid`` frame, result
assembly's rows among them.

Every test reads its own frames or names, so tests that ran before in the
same process (and their spans) change nothing here."""
from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time

import pytest
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import engine, trace
from repro_torch.core.timing import DEFAULT_SYSTEM
from repro_torch.kernels import lane_scan
from repro_torch.pimkernel.executor import PimExecutor
from repro_torch.serving.offload import OffloadPlanner, decode_gemv_sites
import torch_card


def _last(root: str) -> trace.Frame:
    return trace.frames(root)[-1]


def test_nesting_and_self_time():
    with trace.frame("t.root"):
        with trace.span("t.outer"):
            time.sleep(0.01)
            with trace.span("t.inner"):
                time.sleep(0.02)
        with trace.span("t.inner"):
            pass
    f = _last("t.root")
    outer, inner = f.spans["t.outer"], f.spans["t.inner"]
    assert outer[0] == 1 and inner[0] == 2
    assert inner[2] == 0
    # the outer span's children: its one inner span, to the nanosecond
    assert 20e6 <= outer[2] <= inner[1]
    assert f.self_ns("t.outer") == outer[1] - outer[2] >= 10e6
    root = f.spans["t.root"]
    assert root[0] == 1 and root[2] == outer[1] + (inner[1] - outer[2])
    assert f.start_ns <= f.end_ns and f.end_ns - f.start_ns >= root[1]


def test_frames_hold_spans_of_worker_threads():
    def work():
        for _ in range(50):
            with trace.span("t.worker"):
                trace.count("t.items", 3)

    with trace.frame("t.threads"):
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    f = _last("t.threads")
    assert f.spans["t.worker"][0] == 200 and f.counter("t.items") == 600
    # a worker's spans have no parent on the calling thread's stack
    assert f.spans["t.threads"][2] == 0


def test_counters_lose_no_update_under_thread_switches():
    n_threads, n_adds = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_adds):
                trace.count("t.stress")
                with trace.span("t.stress_span"):
                    pass

        before = trace.totals()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        after = trace.totals()
    finally:
        sys.setswitchinterval(old)
    assert (after.counter("t.stress") - before.counter("t.stress")
            == n_threads * n_adds)
    assert (after.spans["t.stress_span"][0]
            - before.spans.get("t.stress_span", (0, 0, 0))[0]
            == n_threads * n_adds)


def test_a_nested_frame_is_a_span():
    with trace.frame("t.outer_frame"):
        with trace.frame("t.nested_frame"):
            trace.count("t.nested_items", 2)
    assert trace.frames()[-1].root == "t.outer_frame"
    f = _last("t.outer_frame")
    assert f.spans["t.nested_frame"][0] == 1
    assert f.spans["t.outer_frame"][2] == f.spans["t.nested_frame"][1]
    assert f.counter("t.nested_items") == 2
    # and the next outermost frame records again
    with trace.frame("t.nested_frame"):
        pass
    assert trace.frames()[-1].root == "t.nested_frame"


def test_counts_inside_a_recording_reach_no_total_and_no_frame():
    before = trace.totals()
    with trace.frame("t.rec_frame"):
        trace.count("t.rec_outside", 2)
        with trace.recording() as rec:
            trace.count("t.rec_int", 3)
            trace.count("t.rec_int", 4)
            trace.count("t.rec_held", torch.tensor(5))
            trace.count("t.rec_held", torch.tensor(6))
        trace.count("t.rec_outside", 1)
    f = _last("t.rec_frame")
    assert f.counts == {"t.rec_outside": 3}
    after = trace.totals()
    for name in ("t.rec_int", "t.rec_held"):
        assert after.counter(name) == before.counter(name) == 0
    assert rec.ints == {"t.rec_int": 7}
    assert set(rec.tensors) == {"t.rec_held"}
    assert int(rec.tensors["t.rec_held"]) == 11


def test_a_recount_adds_each_int_and_each_tensor_as_it_holds_then():
    held = torch.tensor(4)
    with trace.recording() as rec:
        trace.count("t.recount_int", 3)
        trace.count("t.recount_held", held)
    before = trace.totals()
    held.fill_(7)                   # a replay writing the held tensor
    rec.recount()
    held.fill_(100)                 # the next replay: the count stays
    after = trace.totals()
    assert after.counter("t.recount_int") - before.counter(
        "t.recount_int") == 3
    assert after.counter("t.recount_held") - before.counter(
        "t.recount_held") == 7


def test_two_recounts_in_one_frame_sum():
    held = torch.tensor(0)
    with trace.recording() as rec:
        trace.count("t.twice_int", 5)
        trace.count("t.twice_held", held)
    with trace.frame("t.twice"):
        held.fill_(2)
        rec.recount()
        held.fill_(9)
        rec.recount()
    f = _last("t.twice")
    assert f.counter("t.twice_int") == 10
    assert f.counter("t.twice_held") == 11


def test_spans_inside_a_recording_are_not_added():
    with trace.frame("t.rec_spans"):
        with trace.span("t.rec_parent"):
            with trace.recording():
                with trace.span("t.rec_child"):
                    with trace.span("t.rec_grandchild"):
                        time.sleep(0.002)
        with trace.span("t.rec_after"):
            pass
    f = _last("t.rec_spans")
    assert "t.rec_child" not in f.spans
    assert "t.rec_grandchild" not in f.spans
    # the parent outside the recording counts, and the recorded time is
    # its own
    parent = f.spans["t.rec_parent"]
    assert parent[0] == 1 and parent[2] == 0 and parent[1] >= 2e6
    assert f.spans["t.rec_after"][0] == 1
    assert "t.rec_child" not in trace.totals().spans


def test_no_profiler_calls_without_a_profiler(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with trace.frame("t.quiet"):
        with trace.span("t.quiet_inner"):
            pass
    f = _last("t.quiet")
    assert not f.profiled and f.spans["t.quiet_inner"][0] == 1


def test_spans_are_ranges_on_the_profiler_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.frame("t.profiled"):
            with trace.span("t.profiled_sleep"):
                time.sleep(0.02)
            with trace.span("t.profiled_mm"):
                torch.ones(256, 256) @ torch.ones(256, 256)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    f = _last("t.profiled")
    assert f.profiled
    for name in ("t.profiled", "t.profiled_sleep", "t.profiled_mm"):
        ranges = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == name]
        assert len(ranges) == 1, name
        ours_us = f.span_ns(name) / 1e3
        assert abs(ranges[0]["dur"] - ours_us) <= max(0.1 * ours_us, 200.0)


def test_plan_grid_frame_counts_the_sweep_layers(monkeypatch):
    cfg = smoke_config(ARCHS["granite-8b"])
    specs = [dataclasses.replace(DEFAULT_SYSTEM, num_channels=c)
             for c in (2, 4)]
    packed: list = []
    real_pack = engine.pack_lanes

    def pack_lanes(lanes):
        packed.extend(s.shape[0] for _c, s in lanes)
        return real_pack(lanes)

    monkeypatch.setattr(engine, "pack_lanes", pack_lanes)
    engine.lane_cache_reset()
    OffloadPlanner(cfg, device="cpu").plan_grid(specs, fence=True)
    f = _last("offload.plan_grid")
    for name in ("engine.resolve_lanes", "engine.dedupe", "engine.pack",
                 "engine.h2d", "lane_scan.launch", "engine.readback",
                 "engine.store", "executor.plan_many", "executor.layout",
                 "executor.streams", "executor.assemble"):
        assert f.spans[name][0] >= 1, name
    assert f.counter("engine.stream_bytes") == 16 * sum(packed) > 0
    # lanes of unequal lengths, and a slab of their true commands alone
    assert len(set(packed)) > 1
    assert f.counter("engine.slab_bytes") == f.counter("engine.stream_bytes")
    assert f.counter("engine.h2d_bytes") > f.counter("engine.slab_bytes")
    # a cold LRU: every lane launched missed it first
    assert f.counter("engine.lane_misses") >= len(packed) > 0
    assert engine.lane_cache_info()["misses"] == f.counter(
        "engine.lane_misses")
    # the copies' device time is kept only on a card
    assert "engine.h2d_device_ns" not in f.counts
    # children of the resolve: its self time is what no child covers
    resolve = f.spans["engine.resolve_lanes"]
    assert resolve[2] >= f.span_ns("engine.dedupe")


def test_plan_grid_frame_counts_assembled_and_counted_rows(monkeypatch):
    cfg = smoke_config(ARCHS["granite-8b"])
    specs = [dataclasses.replace(DEFAULT_SYSTEM, num_channels=c)
             for c in (2, 4)]
    planned: list = []
    real_plan = PimExecutor.plan_many

    def plan_many(self, reqs):
        out = real_plan(self, reqs)
        planned.extend(out)
        return out

    monkeypatch.setattr(PimExecutor, "plan_many", plan_many)
    engine.lane_cache_reset()
    OffloadPlanner(cfg, device="cpu").plan_grid(specs, fence=True)
    f = _last("offload.plan_grid")
    streams = [s for p in planned for s in p.streams]
    distinct = {id(s): s.shape[0] for s in streams}
    assert f.counter("executor.assembled_rows") == sum(
        s.shape[0] for s in streams) > 0
    assert f.counter("executor.counted_rows") == sum(distinct.values())
    # every spec has more than one channel: baselines repeat their array
    assert (f.counter("executor.counted_rows")
            < f.counter("executor.assembled_rows"))


@pytest.mark.gpu
def test_plan_grid_frame_times_the_copies_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copies' CUDA-event time")
    cfg = smoke_config(ARCHS["granite-8b"])
    specs = [dataclasses.replace(DEFAULT_SYSTEM, num_channels=c)
             for c in (2, 4)]
    engine.lane_cache_reset()
    OffloadPlanner(cfg, device="cuda").plan_grid(specs, fence=True)
    f = _last("offload.plan_grid")
    launches = f.spans["lane_scan.launch"][0]
    assert launches >= 1 and f.counter("engine.h2d_bytes") > 0
    # one event interval a launch, each at least a copy's few microseconds
    assert f.counter("engine.h2d_device_ns") >= 1000 * launches


def test_lane_counters_live_in_the_tracer():
    engine.lane_cache_reset()
    assert engine.lane_cache_info()["hits"] == 0
    before = trace.totals().counter("engine.lane_misses")
    cyc = DEFAULT_SYSTEM.derive_cycles()
    stream = torch.zeros((3, 4), dtype=torch.int32).numpy()
    engine.resolve_lanes([(cyc, stream)], keys=["t.lane"], device="cpu")
    engine.resolve_lanes([(cyc, stream)], keys=["t.lane"], device="cpu")
    info = engine.lane_cache_info()
    assert info["misses"] == 1 and info["hits"] == 1
    assert trace.totals().counter("engine.lane_misses") == before + 1
    engine.lane_cache_reset()
    assert engine.lane_cache_info()["misses"] == 0


@pytest.mark.parametrize("rung", ["mesh", "threaded"])
def test_the_plain_version_counts_no_launch_on_any_rung(rung):
    """Kernel launches are counted where the kernel runs: a resolve over
    two CPU lane devices, on the mesh rung or the threaded one, runs the
    plain version, and no ``*.launches`` or ``engine.mesh_launches.*``
    counter moves."""
    engine.lane_cache_reset()
    cyc = DEFAULT_SYSTEM.derive_cycles()
    probe = lane_scan.probe_stream(cyc.num_banks).numpy()
    lanes = [(cyc, probe[:n]) for n in range(4, 12)]
    before = torch_card.launch_counts()
    scans = trace.totals().spans.get("lane_scan.launch", (0, 0, 0))[0]
    if rung == "mesh":
        with engine.lane_mesh_scope(["cpu"] * 2):
            assert engine.ladder_rungs() == ["mesh", "scan"]
            engine.resolve_lanes(lanes, device="cpu")
        launched = 2                    # one a shard
    else:
        engine.configure_lane_devices(["cpu"] * 2)
        try:
            assert engine.ladder_rungs() == ["threaded", "scan"]
            engine.resolve_lanes(lanes, device="cpu")
        finally:
            engine.configure_lane_devices(None)
        launched = 1                    # eight lanes: one slab
    assert trace.totals().spans["lane_scan.launch"][0] == scans + launched
    assert torch_card.launch_counts() == before
    engine.lane_cache_reset()


def test_the_launchers_spans_row():
    from repro_torch.launch import serve

    totals = trace.Totals(spans={"serving.step": (3, 4_500_000, 1_000_000),
                                 "decode_step": (3, 1_250_000, 0)},
                          counts={"engine.lane_hits": 7, "t.other": 1})
    assert serve.spans_row(totals) == (
        "serve/spans,decode_step=3:1.250,serving.step=3:4.500,"
        "lane_hits=7,lane_misses=0")

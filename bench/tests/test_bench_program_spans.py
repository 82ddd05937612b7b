"""The readers of the program's own spans and counters: present and finite
in whole traced runs of the small cells, nothing without a tracer, and
the serve step's forward labelled ``decode_step`` in a profiled trace."""
from __future__ import annotations

import json
import math
import sys

import numpy as np
import pytest
import torch

import tinyroot

from bench import harness, program, program_spans, tracing

SWEEP = ["assemble.ms_per_query.sweep", "resolve_dedupe.ms_per_query.sweep",
         "resolve_pack.ms_per_query.sweep", "resolve_h2d.gb_per_s.sweep",
         "lane_slab.pad_ratio.sweep"]
SERVE = ["decode_dispatch.ms_per_step.serve",
         "decode_sync.ms_per_step.serve", "prefill.share.serve"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinyroot.make(tmp_path_factory.mktemp("spans"))


def _reader(name):
    return harness.load_module(tinyroot.ROOT / "bench" / "metrics"
                               / f"{name}.py")


@pytest.mark.parametrize("cell,names", [("tiny.sweep", SWEEP),
                                        ("tiny.serve", SERVE)])
def test_program_span_metrics_in_traced_runs(root, cell, names):
    run = tinyroot.run(root, cell, trace=True)
    line = json.loads(json.dumps(harness.result_line(root, run)))
    assert line["correct"] is True
    for name in names:
        if name == "resolve_h2d.gb_per_s.sweep":
            # the copies' time comes from CUDA events: none on the CPU
            assert name not in line["metrics"]
            continue
        assert name in line["metrics"], name
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    if cell == "tiny.sweep":
        assert line["metrics"]["lane_slab.pad_ratio.sweep"]["value"] >= 1.0
    else:
        assert line["metrics"]["prefill.share.serve"]["value"] < 1.0


def test_readers_find_nothing_without_the_tracer(monkeypatch):
    import repro_torch.core

    monkeypatch.delattr(repro_torch.core, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    obs = dict(queries=3, steps=3, points=1, tokens=1)
    assert program_spans.sweep_frames(obs) == []
    for name in SWEEP + SERVE:
        assert _reader(name).read(obs) is None, name


def test_copy_rate_reads_bytes_over_device_time(monkeypatch):
    from repro_torch.core import trace

    frames = [trace.Frame(spans={}, root=program_spans.SWEEP_ROOT,
                          counts={"engine.h2d_bytes": 3_000_000_000,
                                  "engine.h2d_device_ns": 1_000_000_000}),
              trace.Frame(spans={}, root=program_spans.SWEEP_ROOT,
                          counts={"engine.h2d_bytes": 1_000_000_000,
                                  "engine.h2d_device_ns": 1_000_000_000}),
              trace.Frame(spans={}, root=program_spans.SWEEP_ROOT,
                          profiled=True,
                          counts={"engine.h2d_bytes": 1,
                                  "engine.h2d_device_ns": 1_000_000_000})]
    monkeypatch.setattr(trace, "frames", lambda root=None: frames)
    reader = _reader("resolve_h2d.gb_per_s.sweep")
    # the profiled frame is left out: 4e9 B in 2 s
    assert reader.read(dict(queries=3)) == pytest.approx(2.0)
    assert reader.read(dict(queries=1)) is None


def test_forward_launches_are_labelled_decode_step(tmp_path):
    """A profiled engine step on the CPU, its operator calls standing for
    the launches each would make on the card: every call of the forward
    falls under the ``decode_step`` range, none under the read-back's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request, ServingEngine

    serve = harness.load_module(tinyroot.ROOT / "bench" / "drivers"
                                / "serve.py")
    cfg = program.arch(tinyroot.TINY)
    dev = torch.device("cpu")
    params = serve.make_weights(tinyroot.TINY, 7, dev)
    engine = ServingEngine(cfg, params, slots=2, max_seq=32, device=dev)
    for rid in range(2):
        engine.submit(Request(rid=rid, prompt=np.arange(5, dtype=np.int32),
                              max_new=8))
    engine.step()                        # admits and prefills both
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            engine.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    forward = [e for e in ranges if e["name"] == "decode_step"]
    assert len(forward) == 1
    lo, hi = forward[0]["ts"], forward[0]["ts"] + forward[0]["dur"]
    # no program span opens inside the forward
    assert not [e for e in ranges if e is not forward[0]
                and lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                and e["name"] != tracing.WINDOW]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and lo <= e["ts"] < hi]
    stand_ins = [dict(e, cat="cuda_runtime", name="cudaLaunchKernel")
                 for e in ops]
    reduced = tracing.reduce_trace(events + stand_ins)
    assert reduced["launches_by_span"].get("decode_step") == len(ops) > 0
    assert "serving.decode_sync" not in reduced["launches_by_span"]

"""The reader of result assembly's row counters: in a whole traced run of
the small sweep cell it reads a share below 1 (its specs have 2 and 4
channels, whose baselines repeat one stream array), and it finds nothing
on frames without the counters or without a tracer."""
from __future__ import annotations

import json
import sys

import pytest

import tinyroot

from bench import harness, program_spans

NAME = "assemble.count_share.sweep"


def _reader():
    return harness.load_module(tinyroot.ROOT / "bench" / "metrics"
                               / f"{NAME}.py")


def test_count_share_in_a_traced_sweep(tmp_path):
    root = tinyroot.make(tmp_path)
    run = tinyroot.run(root, "tiny.sweep", trace=True)
    line = json.loads(json.dumps(harness.result_line(root, run)))
    assert line["correct"] is True
    value = line["metrics"][NAME]["value"]
    assert 0 < value < 1


def test_count_share_reads_counted_over_assembled(monkeypatch):
    from repro_torch.core import trace

    def frame(counted, assembled, profiled=False):
        return trace.Frame(spans={}, root=program_spans.SWEEP_ROOT,
                           profiled=profiled,
                           counts={"executor.counted_rows": counted,
                                   "executor.assembled_rows": assembled})

    frames = [frame(30, 100), frame(10, 60), frame(1, 1, profiled=True)]
    monkeypatch.setattr(trace, "frames", lambda root=None: frames)
    # the profiled frame is left out: 40 of 160 rows
    assert _reader().read(dict(queries=3)) == pytest.approx(0.25)


def test_count_share_finds_nothing_without_the_counters(monkeypatch):
    from repro_torch.core import trace

    frames = [trace.Frame(spans={}, root=program_spans.SWEEP_ROOT,
                          counts={"engine.stream_bytes": 16})]
    monkeypatch.setattr(trace, "frames", lambda root=None: frames)
    assert _reader().read(dict(queries=1)) is None
    assert _reader().read(dict(queries=0)) is None


def test_count_share_finds_nothing_without_the_tracer(monkeypatch):
    import repro_torch.core

    monkeypatch.delattr(repro_torch.core, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    assert _reader().read(dict(queries=3)) is None

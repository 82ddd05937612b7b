"""The reader of the decode graph's replay share: replays over the
window's unprofiled decode steps, and nothing on a program without the
graph."""
from __future__ import annotations

import importlib.util

import pytest

import tinyroot

from bench import harness, program_spans


def _reader(name):
    return harness.load_module(tinyroot.ROOT / "bench" / "metrics"
                               / f"{name}.py")


def test_replay_share_reads_replays_over_decode_steps(monkeypatch):
    from repro_torch.core import trace

    def frame(decodes, replays, profiled=False):
        spans = {"decode_step": (decodes, 1, 0)} if decodes else {}
        return trace.Frame(spans=spans, root=program_spans.SERVE_ROOT,
                           counts={"decode_graph.replays": replays},
                           profiled=profiled)

    frames = [frame(1, 0), frame(3, 3), frame(0, 0), frame(1, 1),
              frame(5, 0, profiled=True)]
    monkeypatch.setattr(trace, "frames", lambda root=None: frames)
    reader = _reader("decode_graph.replay_share.serve")
    # the profiled frame and the one with no decode step are left out
    assert reader.read(dict(steps=5)) == pytest.approx(4 / 5)
    assert reader.read(dict(steps=2)) == 1.0
    assert reader.read(dict(steps=1)) is None
    # a program without the graph: nothing to read
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert reader.read(dict(steps=5)) is None

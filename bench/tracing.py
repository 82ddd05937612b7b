"""Spans from the benchmark's own files, around the calls into each layer
of the program, and the device trace of a short stretch of the window.

:class:`Spans` times named calls (host clock; each span is also a
``torch.profiler`` range, so the device trace can say what the host was
doing while the card sat idle).  :func:`patch` swaps a module or class
attribute for a wrapper and restores it.  :func:`profile` runs a stretch
of the window under ``torch.profiler`` and reduces its trace to the
device's busy seconds, the device operations with the most time, and the
idle gaps summed by the innermost span around them.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
WINDOW = "bench.profiled"


class Spans:
    """Seconds per span name.  ``on=False`` makes spans free, unless
    ``clock`` keeps their host seconds (without profiler ranges)."""

    def __init__(self, on: bool, clock: bool = False):
        self.on, self.clock = on, on or clock
        self.seconds: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.clock:
            yield
            return
        with (torch.profiler.record_function(name) if self.on
              else contextlib.nullcontext()):
            t = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] = (self.seconds.get(name, 0.0)
                                      + time.perf_counter() - t)

    def wrap(self, fn, name: str):
        def wrapped(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        return wrapped


@contextlib.contextmanager
def patch(target, attr: str, replacement):
    """``target.attr = replacement`` for the block, restored after."""
    real = getattr(target, attr)
    setattr(target, attr, replacement)
    try:
        yield real
    finally:
        setattr(target, attr, real)


def _union(intervals: list) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _segments(spans: list, w0: float, w1: float) -> list:
    """``[w0, w1]`` cut into ``(lo, hi, label)`` pieces, each labelled by
    the innermost span open over it (the one that started last), or
    "outside spans"."""
    edges = sorted({w0, w1, *(t for lo, hi, _n in spans
                              for t in (lo, hi) if w0 < t < w1)})
    spans = sorted(spans)
    out, open_spans, k = [], [], 0
    for lo, hi in zip(edges, edges[1:]):
        while k < len(spans) and spans[k][0] <= lo:
            open_spans.append(spans[k])
            k += 1
        open_spans = [sp for sp in open_spans if sp[1] > lo]
        out.append((lo, hi, open_spans[-1][2] if open_spans
                    else "outside spans"))
    return out


def reduce_trace(events: list, top: int = 10) -> dict:
    """A chrome trace's events -> busy and window seconds, the device
    operations with most time, idle gaps summed by the span the host was
    in, and kernel launch calls by span (all inside the :data:`WINDOW`
    range)."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("profiled range missing from the trace")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev, by_op, launches, spans = [], {}, [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        lo, hi = e["ts"], e["ts"] + e.get("dur", 0)
        if hi <= w0 or lo >= w1:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            lo, hi = max(lo, w0), min(hi, w1)
            dev.append((lo, hi))
            name = e.get("name", "?")[:80]
            by_op[name] = by_op.get(name, 0.0) + (hi - lo) / 1e6
        elif cat == "cuda_runtime" and e.get("name") in LAUNCH_CALLS:
            launches.append(lo)
        elif cat == "user_annotation" and e["name"] != WINDOW:
            spans.append((lo, hi, e["name"][:60]))
    busy = _union(dev)
    gaps, t = [], w0
    for lo, hi in busy:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    if t < w1:
        gaps.append((t, w1))
    segs = _segments(spans, w0, w1)
    idle: dict = {}
    j = 0
    for lo, hi in gaps:                 # both in time order
        while j < len(segs) and segs[j][1] <= lo:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < hi:
            part = min(hi, segs[k][1]) - max(lo, segs[k][0])
            idle[segs[k][2]] = idle.get(segs[k][2], 0.0) + part / 1e6
            k += 1
    starts = [lo for lo, _hi, _n in segs]
    by_span: dict = {}
    for t in launches:
        label = segs[max(0, bisect.bisect_right(starts, t) - 1)][2]
        by_span[label] = by_span.get(label, 0) + 1
    return dict(
        busy_s=sum(hi - lo for lo, hi in busy) / 1e6,
        window_s=(w1 - w0) / 1e6,
        launches=len(launches), launches_by_span=by_span,
        device_ops=sorted(([k, v] for k, v in by_op.items()),
                          key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(([k, v] for k, v in idle.items()),
                         key=lambda kv: -kv[1])[:top])


def profile(fn) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (host and device), ending in
    a synchronize, and reduce its trace (:func:`reduce_trace`).  The
    trace file lives in ``$TMPDIR`` and is deleted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_trace(events)

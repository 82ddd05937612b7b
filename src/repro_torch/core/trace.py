"""Spans and counters at the port's layer boundaries.

``span(name)`` times a block on the host clock (``time.perf_counter_ns``)
and adds its count, its total and the part of it that its child spans
took to process-wide totals; a span's self time is its total less its
children's.  Each thread keeps its own stack, so a span knows its parent.
``count(name, n)`` adds to process-wide counters.

``frame(name)`` is a span that, when no other frame is open on its
thread, also records a :class:`Frame`: the change in every span total
and counter between its entry and its exit.  Spans that worker threads
open meanwhile (the threaded rung's) count toward the frame the calling
thread holds open.  The last :data:`MAX_FRAMES` frames are kept in
memory; nothing is written to disk.

While ``torch.profiler`` runs, every span also opens a
``torch.profiler.record_function`` range of its name, so each program
span is an event on the profiler's own clock in its trace.  While none
runs, no profiler code is called: a span costs two clock reads and a few
dictionary adds under a lock.

Readers: :func:`totals`, :func:`frames` and :func:`reset`.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import torch.autograd.profiler as _autograd_profiler
import torch.profiler

MAX_FRAMES = 4096

_lock = threading.Lock()
_spans: dict[str, list[int]] = {}      # name -> [count, total_ns, child_ns]
_counts: dict[str, int] = {}
_frames: collections.deque = collections.deque(maxlen=MAX_FRAMES)
_frame_ids = itertools.count()
_local = threading.local()
_clock = time.perf_counter_ns


@dataclasses.dataclass(frozen=True)
class Totals:
    """Span totals ``name -> (count, total_ns, child_ns)`` and counters
    ``name -> n``: the process's since the last :func:`reset`, or one
    frame's change."""

    spans: dict
    counts: dict

    def span_ns(self, name: str) -> int:
        return self.spans.get(name, (0, 0, 0))[1]

    def self_ns(self, name: str) -> int:
        count, total, child = self.spans.get(name, (0, 0, 0))
        return total - child

    def counter(self, name: str) -> int:
        return self.counts.get(name, 0)


@dataclasses.dataclass(frozen=True)
class Frame(Totals):
    """One outermost frame: its root span's name, host-clock start and
    end, whether ``torch.profiler`` ran at its entry, and the change of
    every total over it."""

    id: int = 0
    root: str = ""
    start_ns: int = 0
    end_ns: int = 0
    profiled: bool = False


class span:
    """Context manager: time the block under ``name``."""

    __slots__ = ("name", "_t0", "_child", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        stack.append(self)
        self._child = 0
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        dt = _clock() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._child += dt
        with _lock:
            t = _spans.get(self.name)
            if t is None:
                t = _spans[self.name] = [0, 0, 0]
            t[0] += 1
            t[1] += dt
            t[2] += self._child
        return False


class frame(span):
    """A :class:`span` that records a :class:`Frame` when it is the
    outermost frame open on its thread (inside another, a plain span)."""

    __slots__ = ("_outer", "_start", "_before", "_profiled")

    def __enter__(self) -> "frame":
        depth = getattr(_local, "frames", 0)
        _local.frames = depth + 1
        self._outer = depth == 0
        if self._outer:
            self._profiled = _autograd_profiler._is_profiler_enabled
            with _lock:
                self._before = _snapshot()
            self._start = _clock()
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        _local.frames -= 1
        if self._outer:
            end = _clock()
            with _lock:
                after = _snapshot()
                _frames.append(Frame(
                    spans=_change(after.spans, self._before.spans,
                                  (0, 0, 0)),
                    counts=_change(after.counts, self._before.counts, 0),
                    id=next(_frame_ids), root=self.name,
                    start_ns=self._start, end_ns=end,
                    profiled=self._profiled))
        return False


def _snapshot() -> Totals:
    # callers hold _lock
    return Totals(spans={k: tuple(v) for k, v in _spans.items()},
                  counts=dict(_counts))


def _change(after: dict, before: dict, zero) -> dict:
    out = {}
    for k, v in after.items():
        b = before.get(k, zero)
        if v != b:
            out[k] = (tuple(x - y for x, y in zip(v, b))
                      if isinstance(v, tuple) else v - b)
    return out


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def totals() -> Totals:
    """Every span total and counter since the last :func:`reset`."""
    with _lock:
        return _snapshot()


def frames(root: str | None = None) -> list[Frame]:
    """The kept frames, oldest first (only those rooted at ``root``, if
    given)."""
    with _lock:
        return [f for f in _frames if root is None or f.root == root]


def reset(*names: str) -> None:
    """Zero the named spans and counters, or, with no name, every total
    and the kept frames.  A frame open across the reset of a name
    records a wrong change for it, so no caller resets inside a frame."""
    with _lock:
        if not names:
            _spans.clear()
            _counts.clear()
            _frames.clear()
            return
        for name in names:
            _spans.pop(name, None)
            _counts.pop(name, None)

"""Deterministic fault injection + the degradation-ladder primitives.

A real LP5X-PIM serving deployment survives backend faults, cache
corruption and queue pressure; this module is the harness that proves
the simulator's control layers do too.  It owns four small, shared
pieces the rest of the stack composes:

* **Clocks** — :class:`VirtualClock` / :class:`SystemClock` behind one
  protocol (callable ``now`` + ``sleep``).  The serving retry/backoff
  below runs on it, so no test ever real-sleeps: retries against a
  :class:`VirtualClock` advance simulated time only.
* **Structured events** — every injected fault and every degradation
  step is appended to a process-global, bounded event log
  (:func:`record_event` / :func:`events`), tagged with the serve tick
  (:func:`set_tick`), so chaos runs export a replayable incident
  record in their trace.
* **Seeded injection** — :class:`FaultInjector` arms site-keyed fault
  schedules (``backend.pallas``, ``backend.mesh``, ``backend.threaded``,
  ``backend.scan``, ``lane_cache``, ``warmstart``, ``handoff``,
  ``planner``, ``admission``); :func:`maybe_fail` is the zero-cost seam
  the engine and controller call at each fault site.  Injection is
  deterministic — a schedule is a list of (site, start, count) specs
  matched against per-site call counters, never wall-clock or RNG at
  fire time.
* **Absorption** — :class:`CircuitBreaker` (trips a rung open after K
  *consecutive* failures; success resets) and :func:`retry_call`
  (bounded retry with exponential backoff on the configured clock).
  The serving controller retries its planner calls through
  :func:`retry_call`; the backend degradation ladder that stacks them
  per resolver rung is not part of this package yet.

Everything here is plain stdlib and process-global with an explicit
:func:`reset` for tests.  ``FAULT_SITES`` keeps the JAX package's site
names, backend rungs included.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Iterable

# ---------------------------------------------------------------------------
# Clocks: the one shared virtual-clock helper (satellite: unify clocks)
# ---------------------------------------------------------------------------


class VirtualClock:
    """A manually-advanced clock: ``sleep`` moves time without waiting.

    Callable (``clock()`` == ``clock.now()``) so it drops into any API
    that takes a ``time.monotonic``-style callable — e.g.
    ``training.fault.HeartbeatMonitor(clock=VirtualClock())`` — while
    also providing the ``sleep`` the retry/backoff path needs.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self.sleeps: list[float] = []

    def __call__(self) -> float:
        return self._t

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t

    def sleep(self, dt: float) -> None:
        self.sleeps.append(float(dt))
        self._t += float(dt)


class SystemClock:
    """The real clock behind the same protocol (monotonic + sleep)."""

    def __call__(self) -> float:
        return time.monotonic()

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        time.sleep(dt)


SYSTEM_CLOCK = SystemClock()


# ---------------------------------------------------------------------------
# Structured fault / degradation events
# ---------------------------------------------------------------------------

FAULT_SITES = (
    "backend.pallas", "backend.mesh", "backend.threaded", "backend.scan",
    "lane_cache", "warmstart", "handoff", "planner", "admission",
)

_EVENTS: deque = deque(maxlen=4096)
_EVENTS_LOCK = threading.Lock()
_TICK: int | None = None


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One structured incident-log entry.

    ``kind`` vocabulary: ``inject`` (a scheduled fault fired), ``fault``
    (a site raised — injected or real), ``retry`` (bounded backoff
    retry), ``degrade`` (ladder step-down / planner host-only
    fallback), ``trip`` / ``skip`` (circuit breaker opened / rung
    skipped while open), ``detect`` (poisoned cache entry or corrupt
    snapshot caught), ``shed`` (admission load shedding).
    """

    site: str
    kind: str
    detail: str = ""
    tick: int | None = None

    def to_record(self) -> dict:
        rec = dict(site=self.site, kind=self.kind, detail=self.detail)
        if self.tick is not None:
            rec["tick"] = self.tick
        return rec


def set_tick(t: int | None) -> None:
    """Tag subsequent events with serve tick ``t`` (None = untagged)."""
    global _TICK
    _TICK = None if t is None else int(t)


def record_event(site: str, kind: str, detail: str = "",
                 tick: int | None = None) -> FaultEvent:
    ev = FaultEvent(site=site, kind=kind, detail=detail,
                    tick=_TICK if tick is None else int(tick))
    with _EVENTS_LOCK:
        _EVENTS.append(ev)
    return ev


def events() -> list[dict]:
    """The event log as plain records (trace-exportable)."""
    with _EVENTS_LOCK:
        return [e.to_record() for e in _EVENTS]


def reset_events() -> None:
    with _EVENTS_LOCK:
        _EVENTS.clear()


# ---------------------------------------------------------------------------
# Seeded, deterministic fault injection
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Raised by :func:`maybe_fail` when an armed schedule matches."""

    def __init__(self, site: str, message: str = ""):
        self.site = site
        super().__init__(message or f"injected fault at {site}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: calls ``start .. start+count-1`` at ``site``
    raise (``count < 0`` = every call from ``start`` on — persistent)."""

    site: str
    start: int = 0
    count: int = 1
    message: str = ""

    def matches(self, call: int) -> bool:
        if call < self.start:
            return False
        return self.count < 0 or call < self.start + self.count


class FaultInjector:
    """Site-keyed deterministic fault schedules.

    Each :func:`maybe_fail` advances that site's call counter and fires
    iff an armed :class:`FaultSpec` covers the index — same schedule,
    same run, same faults, always.  ``arm(site, count)`` is the
    timeline-friendly form: *the next* ``count`` calls at ``site`` fail.
    """

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self.specs: list[FaultSpec] = list(specs)
        self.calls: dict[str, int] = {}
        self.injected = 0

    def arm(self, site: str, count: int = 1, start: int | None = None,
            message: str = "") -> FaultSpec:
        spec = FaultSpec(site=site, count=count, message=message,
                         start=(self.calls.get(site, 0)
                                if start is None else start))
        self.specs.append(spec)
        return spec

    def should_fail(self, site: str) -> FaultSpec | None:
        call = self.calls.get(site, 0)
        self.calls[site] = call + 1
        for spec in self.specs:
            if spec.site == site and spec.matches(call):
                self.injected += 1
                return spec
        return None


_INJECTOR: FaultInjector | None = None


def install_injector(inj: FaultInjector | None) -> None:
    global _INJECTOR
    _INJECTOR = inj


def injector() -> FaultInjector | None:
    return _INJECTOR


class fault_scope:
    """Context manager: install ``inj`` for the block, then restore."""

    def __init__(self, inj: FaultInjector | None):
        self._inj = inj

    def __enter__(self) -> FaultInjector | None:
        self._prev = _INJECTOR
        install_injector(self._inj)
        return self._inj

    def __exit__(self, *exc):
        install_injector(self._prev)
        return False


def maybe_fail(site: str) -> None:
    """The injection seam: no-op unless an installed schedule matches.

    The no-injector path is one global read — cheap enough for the
    engine's hot dispatch loop.
    """
    inj = _INJECTOR
    if inj is None:
        return
    spec = inj.should_fail(site)
    if spec is not None:
        record_event(site, "inject", spec.message or "scheduled fault")
        raise InjectedFault(site, spec.message)


# ---------------------------------------------------------------------------
# Circuit breaker: trip a rung open after K consecutive failures
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Per-key consecutive-failure breaker.

    ``record_failure`` returns True exactly when the K-th consecutive
    failure trips the key open; ``record_success`` closes it and zeroes
    the streak.  Half-open probing is deliberately absent: in this
    process model a tripped rung stays skipped until :func:`reset` (the
    conservative choice — a flapping backend must not oscillate the
    serve path).

    The process breaker below is the anonymous one; ``name`` tags a
    scoped breaker's trip events (the anonymous breaker keeps the
    classic event text).
    """

    def __init__(self, threshold: int = 3, name: str = ""):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.name = str(name)
        self.failures: dict[str, int] = {}
        self.open: set[str] = set()

    def record_failure(self, key: str) -> bool:
        n = self.failures.get(key, 0) + 1
        self.failures[key] = n
        if n >= self.threshold and key not in self.open:
            self.open.add(key)
            who = f" [{self.name}]" if self.name else ""
            record_event(key, "trip",
                         f"open after {n} consecutive failures "
                         f"(threshold {self.threshold}){who}")
            return True
        return False

    def record_success(self, key: str) -> None:
        self.failures[key] = 0
        self.open.discard(key)

    def tripped(self, key: str) -> bool:
        return key in self.open

    def info(self) -> dict:
        out = dict(threshold=self.threshold, open=sorted(self.open),
                   failures={k: v for k, v in sorted(self.failures.items())
                             if v})
        if self.name:
            # Only scoped (named) breakers carry the tag, so the golden
            # chaos traces' anonymous breaker info stays byte-identical.
            out["name"] = self.name
        return out


_BREAKER = CircuitBreaker()


def backend_breaker() -> CircuitBreaker:
    """The process breaker guarding the engine's backend ladder."""
    return _BREAKER


def configure_breaker(threshold: int) -> CircuitBreaker:
    """Replace the backend breaker (fresh state) with threshold K."""
    global _BREAKER
    _BREAKER = CircuitBreaker(threshold)
    return _BREAKER


# ---------------------------------------------------------------------------
# Bounded retry with backoff (shared by engine rungs + planner calls)
# ---------------------------------------------------------------------------

_RETRY = {"retries": 1, "backoff": 0.02, "clock": SYSTEM_CLOCK}


def configure_retry(retries: int | None = None,
                    backoff: float | None = None,
                    clock=None) -> dict:
    """Set the process retry policy; None leaves a field unchanged."""
    if retries is not None:
        if retries < 0:
            raise ValueError("retries must be >= 0")
        _RETRY["retries"] = int(retries)
    if backoff is not None:
        _RETRY["backoff"] = float(backoff)
    if clock is not None:
        _RETRY["clock"] = clock
    return dict(_RETRY)


class retry_scope:
    """Context manager: temporary retry policy (e.g. a VirtualClock so
    a chaos run's backoffs never real-sleep)."""

    def __init__(self, retries: int | None = None,
                 backoff: float | None = None, clock=None):
        self._kw = dict(retries=retries, backoff=backoff, clock=clock)

    def __enter__(self) -> dict:
        self._prev = dict(_RETRY)
        return configure_retry(**self._kw)

    def __exit__(self, *exc):
        _RETRY.update(self._prev)
        return False


def retry_call(fn: Callable, site: str, retries: int | None = None,
               backoff: float | None = None, clock=None):
    """Run ``fn`` with the injection seam + bounded backoff retries.

    Each attempt first passes through :func:`maybe_fail(site)` (so armed
    transient faults are absorbed exactly like real transient raises),
    then calls ``fn``.  Every failure is recorded; the last one
    propagates once retries are exhausted.
    """
    r = _RETRY["retries"] if retries is None else int(retries)
    b = _RETRY["backoff"] if backoff is None else float(backoff)
    clk = clock if clock is not None else _RETRY["clock"]
    for attempt in range(r + 1):
        try:
            maybe_fail(site)
            return fn()
        except Exception as e:  # noqa: BLE001 - every rung fault lands here
            record_event(site, "fault", f"{type(e).__name__}: {e}")
            if attempt >= r:
                raise
            record_event(site, "retry",
                         f"attempt {attempt + 1}/{r} after "
                         f"{type(e).__name__}")
            clk.sleep(b * (2 ** attempt))


# ---------------------------------------------------------------------------
# Process hygiene
# ---------------------------------------------------------------------------


def reset() -> None:
    """Restore every process-global here to its boot state (tests)."""
    global _BREAKER
    install_injector(None)
    reset_events()
    set_tick(None)
    _BREAKER = CircuitBreaker()
    _RETRY.update(retries=1, backoff=0.02, clock=SYSTEM_CLOCK)

"""Trace-driven serving scenarios: seeded workloads + replayable traces.

A scenario is a deterministic arrival schedule — request id, arrival
tick, prompt length, decode budget — produced by a seeded generator.
Seven load shapes cover the serving regimes the offload policies must
survive:

* ``steady``        — one request every few ticks, stable occupancy.
* ``bursty``        — Poisson arrivals whose rate spikes in short burst
                      windows (the queue oscillates across the offload
                      crossover batch).
* ``diurnal``       — sinusoidal arrival rate, a slow ramp up and down.
* ``prefill-heavy`` — few requests, long prompts, short decode budgets.
* ``drain-refill``  — waves separated by idle gaps (occupancy collapses
                      to zero and refills from empty).
* ``chaos``         — heavy pressure spikes over a low background rate,
                      sized so bounded admission/handoff configs shed.
* ``spec-decode``   — small prompts with long decode budgets, the
                      draft/verify speculative regime: served with a
                      :class:`SpecDecodeConfig`, acceptance-dependent
                      multi-token advances swing completion times and
                      occupancy in ways no fixed-budget schedule does.

This module is the model-free half of serving.  ``simulate_batches``
mirrors the serving engine's admission and completion semantics
(requests finish on their decode budget, never on EOS), so a scenario's
per-tick occupancy trace is available *without* running a model — that
is what the offload policies are driven with (``run_policy_over_trace``).
``simulate_disagg`` is the same mirror for the disaggregated
prefill/decode cell pair: SLO-classed admission (``_admission_pick`` is
THE order spec), budgeted prefill, a bounded KV-handoff queue and
continuous-batching decode.  ``simulate_spec_decode`` is the mirror for
speculative serving: the seeded accept/advance round math in
:class:`SpecDecodeConfig` is THE spec, keyed per (request, round) so it
is independent of slot processing order.  ``replay_batches`` re-derives
a recorded trace's occupancy (``tests/golden/serve_trace.json``,
``spec_decode_trace.json``) from its embedded schedule alone.

``run_scenario`` / ``replay_trace`` serve a scenario with a model
through the monolithic ``ServingEngine`` or the disaggregated cells
(``serving/cells.py``), optionally autoscaled and with per-cell backend
scopes, and emit a replayable trace; the serving goldens under
``tests/golden/`` pin one trace of each engine shape.  Under a lane mesh
(``mesh=``) the planner's lanes resolve on the mesh rung, and the trace
must not change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


class ScenarioDrainError(RuntimeError):
    """A scenario failed to drain within its tick bound.

    Carries the queue state at the moment of failure so a wedged run is
    diagnosable from the exception alone: per-queue depths, the age of
    the oldest still-queued request, and the last tick's batch
    composition.
    """

    def __init__(self, name: str, tick: int, queues: dict[str, int],
                 oldest_age: int | None, last_batch):
        self.name = name
        self.tick = tick
        self.queues = dict(queues)
        self.oldest_age = oldest_age
        self.last_batch = list(last_batch)
        depths = ", ".join(f"{q}={d}" for q, d in self.queues.items())
        age = "n/a" if oldest_age is None else f"{oldest_age} ticks"
        super().__init__(
            f"scenario {name!r} did not drain within {tick} ticks: "
            f"queue depths [{depths}], oldest queued request age {age}, "
            f"last-tick batch {self.last_batch}")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of a scenario schedule (all scheduling, no tokens)."""

    rid: int
    step: int          # driver tick at which the request is submitted
    prompt_len: int
    max_new: int

    def decode_steps(self) -> int:
        # Prefill emits the first token; the engine marks a request done
        # after the decode step that reaches max_new, so a request holds
        # its slot for max(1, max_new - 1) decode steps.
        return max(1, self.max_new - 1)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    seed: int
    slots: int
    arrivals: tuple

    def to_record(self) -> dict:
        return dict(name=self.name, seed=self.seed, slots=self.slots,
                    arrivals=[dataclasses.asdict(a) for a in self.arrivals])

    @staticmethod
    def from_record(rec: dict) -> "ScenarioSpec":
        return ScenarioSpec(
            name=rec["name"], seed=rec["seed"], slots=rec["slots"],
            arrivals=tuple(Arrival(**a) for a in rec["arrivals"]))


def _pack(name: str, seed: int, slots: int, raw) -> ScenarioSpec:
    """Sort (step, order) and assign dense rids — determinism lives here."""
    arrivals = tuple(Arrival(rid=i, step=int(s), prompt_len=int(p),
                             max_new=int(m))
                     for i, (s, p, m) in enumerate(raw))
    return ScenarioSpec(name=name, seed=seed, slots=slots,
                        arrivals=arrivals)


def _steady(rng, slots: int, quick: bool):
    n = 8 if quick else 24
    gap = 2
    return [(i * gap, rng.integers(4, 12), rng.integers(4, 8))
            for i in range(n)]


def _bursty(rng, slots: int, quick: bool):
    horizon = 40 if quick else 120
    n_bursts = 2 if quick else 5
    burst_at = sorted(rng.choice(horizon - 6, size=n_bursts,
                                 replace=False))
    raw = []
    for t in range(horizon):
        lam = 0.12
        for b in burst_at:
            if b <= t < b + 3:
                lam = 1.6
        for _ in range(rng.poisson(lam)):
            raw.append((t, rng.integers(4, 12), rng.integers(3, 9)))
    return raw


def _diurnal(rng, slots: int, quick: bool):
    horizon = 48 if quick else 144
    period = horizon / 2
    raw = []
    for t in range(horizon):
        lam = 0.55 * (1.0 + math.sin(2.0 * math.pi * t / period))
        for _ in range(rng.poisson(lam)):
            raw.append((t, rng.integers(4, 12), rng.integers(3, 8)))
    return raw


def _prefill_heavy(rng, slots: int, quick: bool):
    n = 6 if quick else 16
    gap = 3
    return [(i * gap, rng.integers(24, 48), rng.integers(2, 5))
            for i in range(n)]


def _drain_refill(rng, slots: int, quick: bool):
    waves = 2 if quick else 4
    wave_size = slots + 2
    max_new_hi = 7
    # A wave of wave_size requests over `slots` drains in at most
    # ceil(wave_size / slots) * (max_new_hi - 1) decode ticks; the gap
    # guarantees an idle stretch between waves.
    wave_gap = -(-wave_size // slots) * (max_new_hi - 1) + 6
    raw = []
    for w in range(waves):
        for _ in range(wave_size):
            raw.append((w * wave_gap, rng.integers(4, 12),
                        rng.integers(3, max_new_hi)))
    return raw


def _chaos(rng, slots: int, quick: bool):
    # Short, hard pressure spikes over a trickle background: queues
    # deepen fast enough that bounded admission capacities actually
    # shed, and the idle stretches between spikes let the degradation
    # ladder's retries/replans land on a drained system.
    horizon = 30 if quick else 90
    raw = []
    for t in range(horizon):
        lam = 2.4 if t % 12 < 3 else 0.25
        for _ in range(rng.poisson(lam)):
            raw.append((t, rng.integers(4, 14), rng.integers(3, 8)))
    return raw


def _spec_decode(rng, slots: int, quick: bool):
    # The draft/verify regime: small prompts, long decode budgets (the
    # shapes speculative decoding pays for), paced so acceptance-
    # dependent completion swings push the occupancy back and forth
    # across the offload crossover batch.
    horizon = 12 if quick else 36
    raw = []
    for t in range(0, horizon, 2):
        for _ in range(int(rng.integers(1, 3))):
            raw.append((t, rng.integers(4, 10), rng.integers(8, 25)))
    return raw


SCENARIOS = {
    "steady": _steady,
    "bursty": _bursty,
    "diurnal": _diurnal,
    "prefill-heavy": _prefill_heavy,
    "drain-refill": _drain_refill,
    "chaos": _chaos,
    "spec-decode": _spec_decode,
}


def resolve_scenario(name: str) -> str:
    """Canonicalize a scenario name or raise listing every valid one.

    CLI-friendly underscore aliases map to the registry's dashed names
    (``spec_decode`` → ``spec-decode``), and unknown names fail with
    the full menu at validation time instead of surfacing later as a
    bare ``KeyError``.  The launchers validate ``--scenario`` through
    this instead of a frozen argparse ``choices`` list.
    """
    cand = str(name).replace("_", "-")
    if cand in SCENARIOS:
        return cand
    raise ValueError(f"unknown scenario {name!r}; "
                     f"choose from {sorted(SCENARIOS)}")


def make_scenario(name: str, seed: int = 0, slots: int = 8,
                  quick: bool = False) -> ScenarioSpec:
    """Build a deterministic scenario: same (name, seed, slots, quick)
    always yields the identical arrival schedule."""
    name = resolve_scenario(name)
    rng = np.random.default_rng(seed)
    return _pack(name, seed, slots, SCENARIOS[name](rng, slots, quick))


# ---------------------------------------------------------------------
# Pure occupancy simulation (ServingEngine's scheduling semantics)
# ---------------------------------------------------------------------

def simulate_batches(spec: ScenarioSpec, max_ticks: int = 100_000
                     ) -> list[int]:
    """Per-tick decode batch sizes of an engine driving this scenario.

    0 entries are idle ticks (all slots free, later arrivals pending) —
    the drain/refill gaps.  This mirrors the serving engine exactly:
    admission at the start of a tick in arrival order, one decode step
    per tick per active slot, completion after ``decode_steps`` ticks
    (EOS never fires in scenario runs).
    """
    pending = sorted(spec.arrivals, key=lambda a: (a.step, a.rid))
    i = 0
    waiting: list[Arrival] = []
    active = [0] * spec.slots
    batches: list[int] = []
    t = 0
    while i < len(pending) or waiting or any(active):
        while i < len(pending) and pending[i].step <= t:
            waiting.append(pending[i])
            i += 1
        for s in range(spec.slots):
            if active[s] == 0 and waiting:
                active[s] = waiting.pop(0).decode_steps()
        batches.append(sum(1 for rem in active if rem > 0))
        for s in range(spec.slots):
            if active[s] > 0:
                active[s] -= 1
        t += 1
        if t > max_ticks:
            raise ScenarioDrainError(
                spec.name, max_ticks,
                queues=dict(waiting=len(waiting),
                            pending=len(pending) - i),
                oldest_age=(t - min(a.step for a in waiting)
                            if waiting else None),
                last_batch=[rem for rem in active if rem > 0])
    return batches


def occupancy_trace(spec: ScenarioSpec) -> list[int]:
    """The non-idle batch sequence — what an offload policy observes."""
    return [b for b in simulate_batches(spec) if b > 0]


# ---------------------------------------------------------------------
# Speculative decoding: the seeded accept/advance round math (THE spec)
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Scheduling spec of the draft/verify speculative-decode loop.

    Per serve tick, every active request runs one *round*: it drafts
    ``drafted = min(draft_len, remaining - 1)`` tokens (never drafting
    past its decode budget), a seeded leading-prefix acceptance draw
    accepts ``k <= drafted`` of them, and the verify step contributes
    one token unconditionally — so the request advances ``k + 1``
    tokens and wastes ``drafted - k`` draft positions.  Consequences
    that hold *by construction* (the property suite pins them):

    * token conservation — a request's advances sum exactly to its
      ``decode_steps()`` budget, accepted or not;
    * ``acceptance=0`` advances 1 token per tick: the schedule
      degenerates to vanilla decode, tick-exactly equal to
      :func:`simulate_batches`;
    * ``acceptance=1`` accepts every drafted token: nothing is ever
      re-decoded (``wasted == 0``).

    The acceptance draw is keyed by ``(seed, rid, round)`` — not by any
    global counter — so the model-free mirror and the real engines
    compute identical schedules regardless of slot processing order,
    and a request's fate is independent of who shares its batch.
    """

    draft_len: int = 4
    acceptance: float = 0.7
    seed: int = 0

    def __post_init__(self):
        if self.draft_len < 1:
            raise ValueError("draft_len must be >= 1")
        if not 0.0 <= self.acceptance <= 1.0:
            raise ValueError("acceptance must be in [0, 1]")
        if self.seed < 0:
            raise ValueError("seed must be >= 0")

    def to_record(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_record(rec: dict) -> "SpecDecodeConfig":
        return SpecDecodeConfig(**rec)

    def accepted(self, rid: int, round_: int) -> int:
        """Accepted draft-token count for a request's n-th round:
        leading accepts of ``draft_len`` Bernoulli(acceptance) draws
        (speculative decoding accepts a prefix — the first rejection
        discards the rest of the draft)."""
        draws = np.random.default_rng(
            (self.seed, rid, round_)).random(self.draft_len)
        k = 0
        for d in draws:
            if d >= self.acceptance:
                break
            k += 1
        return k

    def advance(self, rid: int, round_: int, remaining: int
                ) -> tuple[int, int, int]:
        """One round for a request with ``remaining`` budget: returns
        ``(advance, drafted, accepted)``.  ``advance = accepted + 1``
        (the verify token) and never exceeds ``remaining``."""
        drafted = min(self.draft_len, remaining - 1)
        k = min(self.accepted(rid, round_), drafted)
        return k + 1, drafted, k


def simulate_spec_decode(spec: ScenarioSpec,
                         spec_decode: SpecDecodeConfig | None = None,
                         max_ticks: int = 100_000) -> dict:
    """Tick-exact model-free mirror of speculative-decode serving.

    The ``simulate_batches`` analogue for a serving engine running
    ``spec_decode=``: admission and slot fill are identical
    (arrival-order FIFO into free slots), but each active slot performs
    one :meth:`SpecDecodeConfig.advance` round per tick instead of a
    single-token decrement.  Returns per-tick batches, per-tick total
    advance, per-tick verify sub-steps (``max`` advance — the number of
    batched decode calls the real engine issues that tick), per-request
    round/draft/accept/waste counters and completion ticks.
    """
    sd = spec_decode or SpecDecodeConfig()
    pending = sorted(spec.arrivals, key=lambda a: (a.step, a.rid))
    i = 0
    waiting: list[Arrival] = []
    active = [0] * spec.slots
    slot_rid = [-1] * spec.slots
    batches: list[int] = []
    advance: list[int] = []
    substeps: list[int] = []
    rounds: dict[int, int] = {a.rid: 0 for a in spec.arrivals}
    drafted: dict[int, int] = {a.rid: 0 for a in spec.arrivals}
    accepted: dict[int, int] = {a.rid: 0 for a in spec.arrivals}
    completion_ticks: dict[int, int] = {}
    t = 0
    while i < len(pending) or waiting or any(active):
        while i < len(pending) and pending[i].step <= t:
            waiting.append(pending[i])
            i += 1
        for s in range(spec.slots):
            if active[s] == 0 and waiting:
                a = waiting.pop(0)
                active[s] = a.decode_steps()
                slot_rid[s] = a.rid
        batches.append(sum(1 for rem in active if rem > 0))
        adv_total = 0
        adv_max = 0
        for s in range(spec.slots):
            if active[s] > 0:
                rid = slot_rid[s]
                adv, drf, acc = sd.advance(rid, rounds[rid], active[s])
                rounds[rid] += 1
                drafted[rid] += drf
                accepted[rid] += acc
                adv_total += adv
                adv_max = max(adv_max, adv)
                active[s] -= adv
                if active[s] == 0:
                    completion_ticks[rid] = t
        advance.append(adv_total)
        substeps.append(adv_max)
        t += 1
        if t > max_ticks:
            raise ScenarioDrainError(
                spec.name, max_ticks,
                queues=dict(waiting=len(waiting),
                            pending=len(pending) - i),
                oldest_age=(t - min(a.step for a in waiting)
                            if waiting else None),
                last_batch=[rem for rem in active if rem > 0])
    return dict(per_tick_batch=batches, per_tick_advance=advance,
                per_tick_substeps=substeps, rounds=rounds,
                drafted=drafted, accepted=accepted,
                wasted={r: drafted[r] - accepted[r] for r in drafted},
                completion_ticks=completion_ticks)


# ---------------------------------------------------------------------
# Disaggregated prefill/decode scheduling (the cell pair's pure mirror)
# ---------------------------------------------------------------------

SLO_LATENCY = "latency"
SLO_THROUGHPUT = "throughput"
SLO_CLASSES = (SLO_LATENCY, SLO_THROUGHPUT)


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Scheduling knobs of the disaggregated prefill/decode cell pair.

    ``prefill_budget`` — prefills the prefill cell may perform per tick
    (``None`` = unbounded; the mirror-of-monolithic setting).
    ``handoff_bound`` — max prefilled requests allowed to sit in the
    KV-handoff queue awaiting a decode slot (``None`` = unbounded);
    the prefill cell stalls rather than overrun it.
    ``starvation_age`` — admission aging: a throughput-class request
    that has waited this many ticks outranks every latency-class
    request, so sustained latency bursts cannot starve the throughput
    class (the fuzzed no-starvation property).
    ``admission_capacity`` — SLO-aware load shedding: the admission
    queue never holds more than this many waiting requests (``None`` =
    unbounded).  Each arrival that pushes the queue over capacity sheds
    one request per :func:`_shed_pick` — the exact inverse of the
    admission order, so the lowest-priority request goes first and
    aging protection is preserved.  Shed requests leave the system
    (never prefilled, never decoded) and are reported per class.
    """

    prefill_budget: int | None = None
    handoff_bound: int | None = None
    starvation_age: int = 8
    admission_capacity: int | None = None

    def __post_init__(self):
        if self.prefill_budget is not None and self.prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1 or None")
        if self.handoff_bound is not None and self.handoff_bound < 1:
            raise ValueError("handoff_bound must be >= 1 or None")
        if self.starvation_age < 0:
            raise ValueError("starvation_age must be >= 0")
        if (self.admission_capacity is not None
                and self.admission_capacity < 1):
            raise ValueError("admission_capacity must be >= 1 or None")

    @staticmethod
    def mirror() -> "DisaggConfig":
        """The config under which the cell pair replays the monolithic
        engine tick-exactly: unbounded prefill and handoff, one class."""
        return DisaggConfig()

    def to_record(self) -> dict:
        # admission_capacity is omitted when unset so records written
        # before shedding existed stay byte-identical (golden fixtures).
        rec = dataclasses.asdict(self)
        if rec["admission_capacity"] is None:
            del rec["admission_capacity"]
        return rec

    @staticmethod
    def from_record(rec: dict) -> "DisaggConfig":
        return DisaggConfig(**rec)


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Cross-cell decode-slot autoscaling — THE grow/shrink rule spec.

    The decode cell's KV cache stays allocated at its ``slots``
    capacity; autoscaling moves only the *admission limit* — how many
    slots may accept new work.  Growing is therefore free (raise the
    limit) and shrinking is graceful: busy slots above the limit finish
    their requests but are never refilled (lame-duck), which is what
    makes the rule tick-exactly mirrorable without cache reallocation.

    The rule, applied once at the END of every tick (after decode):

    1. ``pressure`` = waiting admissions whose age meets their class
       target (``latency_wait`` / ``throughput_wait`` ticks) — the
       per-class SLO wait telemetry the cells report.
    2. While ``cooldown`` ticks remain since the last action, only the
       countdown advances.
    3. Grow by one slot (up to ``max_slots``) when ``pressure > 0``.
    4. Otherwise, when nothing waits anywhere (admission + handoff
       empty) and fewer than ``limit`` slots are busy, an idle streak
       advances; ``idle_ticks`` consecutive idle ticks shrink the limit
       by one (down to ``min_slots``).
    5. Anything else resets the idle streak.

    The new limit takes effect at the next tick's admissions.
    ``simulate_disagg(..., autoscale=...)`` is the model-free
    implementation.  ``max_slots`` ``None`` means the scenario's slot
    capacity.
    """

    min_slots: int = 1
    max_slots: int | None = None
    start_slots: int | None = None     # None = min_slots
    latency_wait: int = 2
    throughput_wait: int = 6
    idle_ticks: int = 3
    cooldown: int = 2

    def __post_init__(self):
        if self.min_slots < 1:
            raise ValueError("min_slots must be >= 1")
        if self.max_slots is not None and self.max_slots < self.min_slots:
            raise ValueError("max_slots must be >= min_slots or None")
        if (self.start_slots is not None
                and self.start_slots < self.min_slots):
            raise ValueError("start_slots must be >= min_slots or None")
        if self.latency_wait < 0 or self.throughput_wait < 0:
            raise ValueError("class target waits must be >= 0")
        if self.idle_ticks < 1:
            raise ValueError("idle_ticks must be >= 1")
        if self.cooldown < 0:
            raise ValueError("cooldown must be >= 0")

    def class_wait(self, slo: str) -> int:
        return (self.latency_wait if slo == SLO_LATENCY
                else self.throughput_wait)

    def to_record(self) -> dict:
        # None fields omitted (like DisaggConfig.to_record) so records
        # stay minimal and byte-stable as defaults evolve.
        rec = dataclasses.asdict(self)
        for k in ("max_slots", "start_slots"):
            if rec[k] is None:
                del rec[k]
        return rec

    @staticmethod
    def from_record(rec: dict) -> "AutoscaleConfig":
        return AutoscaleConfig(**rec)


def assign_slo(spec: ScenarioSpec, frac_latency: float = 0.5,
               seed: int | None = None) -> dict[int, str]:
    """Seeded per-tenant SLO classes for a scenario's requests.

    Deterministic in (spec.seed, seed override): the same scenario
    always gets the same latency/throughput split, so SLO runs are as
    replayable as the schedule itself.
    """
    rng = np.random.default_rng(spec.seed + 17 if seed is None else seed)
    return {a.rid: (SLO_LATENCY if rng.random() < frac_latency
                    else SLO_THROUGHPUT)
            for a in spec.arrivals}


def _admission_pick(waiting: list, t: int, starvation_age: int) -> int:
    """Index of the next request to prefill — THE admission order spec.

    ``waiting`` entries are ``(enq_tick, seq, rid, slo)``.  Starved
    throughput requests (waited >= ``starvation_age`` ticks) outrank
    everything, oldest first; then latency FIFO; then throughput FIFO.
    With a single class this is plain FIFO — the mirror-of-monolithic
    degenerate case.
    """
    starved = [i for i, (enq, _, _, slo) in enumerate(waiting)
               if slo == SLO_THROUGHPUT and t - enq >= starvation_age]
    if starved:
        return min(starved, key=lambda i: waiting[i][:2])
    latency = [i for i, w in enumerate(waiting) if w[3] == SLO_LATENCY]
    pool = latency or range(len(waiting))
    return min(pool, key=lambda i: waiting[i][:2])


def _shed_pick(waiting: list, t: int, starvation_age: int) -> int:
    """Index of the request to shed under admission pressure — THE shed
    order spec, the exact inverse of :func:`_admission_pick`.

    ``waiting`` entries are ``(enq_tick, seq, rid, slo)``.  The youngest
    non-starved throughput-class request goes first (lowest class,
    least sunk wait); then the youngest latency-class request; only
    when every waiting request is a starved throughput request does one
    of those go (youngest first) — so aging protection survives
    shedding.
    """
    fresh = [i for i, (enq, _, _, slo) in enumerate(waiting)
             if slo == SLO_THROUGHPUT and t - enq < starvation_age]
    if fresh:
        return max(fresh, key=lambda i: waiting[i][:2])
    latency = [i for i, w in enumerate(waiting) if w[3] == SLO_LATENCY]
    pool = latency or range(len(waiting))
    return max(pool, key=lambda i: waiting[i][:2])


def simulate_disagg(spec: ScenarioSpec,
                    disagg: DisaggConfig | None = None,
                    slo: dict[int, str] | None = None,
                    spec_decode: SpecDecodeConfig | None = None,
                    autoscale: AutoscaleConfig | None = None,
                    max_ticks: int = 100_000) -> dict:
    """Tick-exact model-free mirror of the disaggregated cell pair.

    The ``simulate_batches`` analogue for the cell pair: per tick, (1)
    arrivals join the prefill cell's admission queue, (2) the prefill
    cell prefills up to ``prefill_budget`` requests — admission
    order per :func:`_admission_pick` — while the KV-handoff queue has
    room, (3) the decode cell admits handed-off requests FIFO into free
    slots, (4) one decode step runs over every active slot, freeing
    slots the moment their request completes (continuous batching).

    Returns per-tick decode batches / prefill counts / end-of-tick
    handoff depth plus per-request prefill/admit/completion ticks —
    everything the property suite and the real-cell parity test diff.
    With ``admission_capacity`` set, every arrival that leaves the
    waiting queue over capacity sheds one request per
    :func:`_shed_pick` (recorded in ``shed_ticks``) before the tick's
    prefills run.  Under ``DisaggConfig.mirror()`` with a single SLO
    class the decode batch trace equals ``simulate_batches(spec)`` tick
    for tick.  With ``spec_decode`` the decode cell runs one seeded
    accept/advance round per active slot per tick instead of a
    single-token decrement — the same :meth:`SpecDecodeConfig.advance`
    spec :func:`simulate_spec_decode` pins for the monolithic engine.
    With ``autoscale`` the decode admission limit follows the
    :class:`AutoscaleConfig` grow/shrink rule (applied at the end of
    every tick; the result gains a ``limits`` key — the limit in force
    each tick).
    """
    cfg = disagg or DisaggConfig.mirror()
    slo = slo or {}
    rounds: dict[int, int] = {a.rid: 0 for a in spec.arrivals}
    pending = sorted(spec.arrivals, key=lambda a: (a.step, a.rid))
    decode_steps = {a.rid: a.decode_steps() for a in spec.arrivals}
    i = 0
    waiting: list[tuple] = []          # (enq_tick, seq, rid, slo)
    handoff: list[int] = []            # rids, FIFO
    active = [0] * spec.slots
    slot_rid = [-1] * spec.slots
    batches: list[int] = []
    prefills: list[int] = []
    depth: list[int] = []
    prefill_ticks: dict[int, int] = {}
    admit_ticks: dict[int, int] = {}
    completion_ticks: dict[int, int] = {}
    shed_ticks: dict[int, int] = {}
    max_depth = 0
    seq = 0
    t = 0
    # Autoscaling state: the admission limit in force, its per-tick
    # trace, and the rule's cooldown/idle counters (see
    # AutoscaleConfig).
    auto_max = (spec.slots if autoscale is None
                else min(autoscale.max_slots or spec.slots, spec.slots))
    limit = (spec.slots if autoscale is None
             else min(autoscale.start_slots or autoscale.min_slots,
                      auto_max))
    limits: list[int] = []
    cool = 0
    idle = 0
    while i < len(pending) or waiting or handoff or any(active):
        while i < len(pending) and pending[i].step <= t:
            a = pending[i]
            waiting.append((t, seq, a.rid, slo.get(a.rid, SLO_LATENCY)))
            seq += 1
            i += 1
            if (cfg.admission_capacity is not None
                    and len(waiting) > cfg.admission_capacity):
                _, _, rid_s, _ = waiting.pop(
                    _shed_pick(waiting, t, cfg.starvation_age))
                shed_ticks[rid_s] = t
        n = 0
        while ((cfg.prefill_budget is None or n < cfg.prefill_budget)
               and (cfg.handoff_bound is None
                    or len(handoff) < cfg.handoff_bound) and waiting):
            _, _, rid, _ = waiting.pop(
                _admission_pick(waiting, t, cfg.starvation_age))
            prefill_ticks[rid] = t
            handoff.append(rid)
            max_depth = max(max_depth, len(handoff))
            n += 1
        prefills.append(n)
        for s in range(limit):
            if active[s] == 0 and handoff:
                rid = handoff.pop(0)
                admit_ticks[rid] = t
                active[s] = decode_steps[rid]
                slot_rid[s] = rid
        batches.append(sum(1 for rem in active if rem > 0))
        for s in range(spec.slots):
            if active[s] > 0:
                if spec_decode is None:
                    active[s] -= 1
                else:
                    rid = slot_rid[s]
                    adv, _, _ = spec_decode.advance(
                        rid, rounds[rid], active[s])
                    rounds[rid] += 1
                    active[s] -= adv
                if active[s] == 0:
                    completion_ticks[slot_rid[s]] = t
        depth.append(len(handoff))
        if autoscale is not None:
            limits.append(limit)
            busy = sum(1 for rem in active if rem > 0)
            pressure = sum(1 for enq, _, _, s_cls in waiting
                           if t - enq >= autoscale.class_wait(s_cls))
            if cool > 0:
                cool -= 1
            elif pressure > 0 and limit < auto_max:
                limit += 1
                cool = autoscale.cooldown
                idle = 0
            elif not waiting and not handoff and busy < limit:
                idle += 1
                if idle >= autoscale.idle_ticks \
                        and limit > autoscale.min_slots:
                    limit -= 1
                    cool = autoscale.cooldown
                    idle = 0
            else:
                idle = 0
        t += 1
        if t > max_ticks:
            raise ScenarioDrainError(
                spec.name, max_ticks,
                queues=dict(waiting=len(waiting), handoff=len(handoff),
                            pending=len(pending) - i),
                oldest_age=(t - min(enq for enq, _, _, _ in waiting)
                            if waiting else None),
                last_batch=[rem for rem in active if rem > 0])
    out = dict(per_tick_batch=batches, per_tick_prefills=prefills,
               handoff_depth=depth, max_handoff_depth=max_depth,
               prefill_ticks=prefill_ticks, admit_ticks=admit_ticks,
               completion_ticks=completion_ticks,
               shed_ticks=shed_ticks, rounds=rounds)
    if autoscale is not None:
        out["limits"] = limits
    return out


def run_policy_over_trace(planner, policy, batches: Sequence[int],
                          fence: bool = True, spec=None,
                          policy_kw: dict | None = None):
    """Drive a controller over a recorded occupancy trace (no model).

    Every non-idle batch size is shown to the policy once, in order.
    Returns the controller (``.report()`` has the verdict).
    """
    from .policy import OffloadController
    controller = OffloadController(planner, policy=policy, fence=fence,
                                   spec=spec, **(policy_kw or {}))
    for b in batches:
        if b > 0:
            controller.observe(int(b))
    return controller


def replay_batches(trace: dict) -> list[int]:
    """Re-derive the per-tick occupancy of a recorded trace from its
    embedded schedule alone (no model, no planner) — the replay hook.
    Speculative traces replay through their embedded
    :class:`SpecDecodeConfig` (the mirror's acceptance schedule is part
    of the record)."""
    spec = ScenarioSpec.from_record(trace["scenario"])
    if "spec_decode" in trace:
        sd = SpecDecodeConfig.from_record(trace["spec_decode"]["config"])
        return simulate_spec_decode(spec, sd)["per_tick_batch"]
    return simulate_batches(spec)


# ---------------------------------------------------------------------
# End-to-end: drive the real engine and emit a replayable trace
# ---------------------------------------------------------------------

def run_scenario(scenario: ScenarioSpec, cfg, params, planner,
                 policy: str = "per-step", fence: bool = True,
                 max_seq: int | None = None,
                 policy_kw: dict | None = None, mesh=None,
                 disagg: "bool | DisaggConfig" = False,
                 slo: dict[int, str] | None = None,
                 spec_decode: SpecDecodeConfig | None = None,
                 autoscale: AutoscaleConfig | None = None,
                 prefill_scope=None, decode_scope=None,
                 on_tick=None, device=None) -> dict:
    """Serve the scenario end to end (real model decode) under an
    adaptive offload controller; return the replayable trace record.

    The trace carries only platform-independent telemetry — scheduling,
    occupancy, offload decisions and planner-derived speedups — never
    model token values, so a recorded golden replays byte-exactly
    through any model of the right vocabulary.

    ``disagg`` — ``True`` (mirror config) or a :class:`DisaggConfig`:
    the disaggregated prefill/decode cell pair (``serving/cells.py``)
    serves the scenario instead of the monolithic engine, with optional
    per-request SLO classes in ``slo`` (rid → class, see
    :func:`assign_slo`); the trace gains a ``"disagg"`` key.
    ``spec_decode`` serves the scenario speculatively (the trace gains a
    ``"spec_decode"`` key).  ``autoscale`` (requires ``disagg``): the
    decode cell's admission limit follows the grow/shrink rule through
    ``serving/daemon.py``'s ``AutoscaleController``; the trace gains an
    ``"autoscale"`` key.  ``prefill_scope`` / ``decode_scope`` (require
    ``disagg``): each cell resolves lanes under its own
    :class:`~repro_torch.core.engine.BackendScope`.  ``on_tick`` is
    called as ``fn(t, engine)`` at the top of every serve tick (the chaos
    harness fires its timeline there).  ``device`` is the model's
    (default: the card).  ``mesh`` — a lane mesh for the run (an
    ``int`` n: n shards of the planner's device; or a 1-D list of
    devices; see ``engine.configure_lane_mesh``): the run's lane
    resolutions go through the mesh rung.  Mesh resolution is
    bit-identical, so the trace must not change.
    """
    from repro_torch.core.engine import lane_mesh_on, lane_mesh_scope
    executor = getattr(getattr(planner, "sim", None), "executor", None)
    mesh = lane_mesh_on(mesh, getattr(executor, "device", None) or device)
    with lane_mesh_scope(mesh):
        return _run_scenario(scenario, cfg, params, planner, policy, fence,
                             max_seq, policy_kw, disagg, slo, spec_decode,
                             autoscale, prefill_scope, decode_scope,
                             on_tick, device)


def _run_scenario(scenario, cfg, params, planner, policy, fence, max_seq,
                  policy_kw, disagg, slo, spec_decode, autoscale,
                  prefill_scope, decode_scope, on_tick, device) -> dict:
    from .engine import Request, ServingEngine
    from .policy import OffloadController

    controller = OffloadController(planner, policy=policy, fence=fence,
                                   **(policy_kw or {}))
    if max_seq is None:
        max_seq = max((a.prompt_len + a.max_new
                       for a in scenario.arrivals), default=16)
        max_seq = max(64, 2 * max_seq)
    slo = slo or {}
    if disagg:
        from .cells import DisaggServingEngine
        dcfg = disagg if isinstance(disagg, DisaggConfig) \
            else DisaggConfig.mirror()
        eng = DisaggServingEngine(cfg, params, slots=scenario.slots,
                                  max_seq=max_seq, disagg=dcfg,
                                  controller=controller,
                                  spec_decode=spec_decode,
                                  prefill_scope=prefill_scope,
                                  decode_scope=decode_scope, device=device)
    else:
        if autoscale is not None:
            raise ValueError("autoscale requires disagg serving "
                             "(the decode cell owns the slot limit)")
        if prefill_scope is not None or decode_scope is not None:
            raise ValueError("per-cell backend scopes require disagg "
                             "serving (the cells own scope activation)")
        eng = ServingEngine(cfg, params, slots=scenario.slots,
                            max_seq=max_seq, controller=controller,
                            spec_decode=spec_decode, device=device)
    scaler = None
    if autoscale is not None:
        from .daemon import AutoscaleController
        scaler = AutoscaleController(autoscale, eng)
    if spec_decode is not None:
        # Keep the hot small-shape draft lanes pinned at the MRU end of
        # the lane LRU for the whole run.
        planner.plan_draft(fence=fence)
    rng = np.random.default_rng(scenario.seed + 1)   # token values only
    pending = sorted(scenario.arrivals, key=lambda a: (a.step, a.rid))
    reqs = {a.rid: Request(rid=a.rid,
                           prompt=rng.integers(0, cfg.vocab,
                                               size=a.prompt_len),
                           max_new=a.max_new)
            for a in pending}
    i = 0
    t = 0
    per_tick: list[int] = []
    while i < len(pending) or any(eng.active) or eng.waiting:
        if on_tick is not None:
            on_tick(t, eng)
        if spec_decode is not None:
            planner.touch_draft(fence=fence)
        while i < len(pending) and pending[i].step <= t:
            rid = pending[i].rid
            if disagg:
                eng.submit(reqs[rid], slo=slo.get(rid, SLO_LATENCY))
            else:
                eng.submit(reqs[rid])
            i += 1
        stepped = eng.step()
        if scaler is not None:
            scaler.observe(t)
        per_tick.append(eng.step_batches[-1] if stepped else 0)
        t += 1
        if t > 100_000:
            step_of = {a.rid: a.step for a in scenario.arrivals}
            if disagg:
                queued = eng.queued_rids()
                queues = dict(waiting=len(eng.prefill_cell.queue),
                              handoff=len(eng.handoff),
                              pending=len(pending) - i)
            else:
                queued = [r.rid for r in eng.waiting]
                queues = dict(waiting=len(eng.waiting),
                              pending=len(pending) - i)
            raise ScenarioDrainError(
                scenario.name, 100_000, queues=queues,
                oldest_age=(t - min(step_of[r] for r in queued)
                            if queued else None),
                last_batch=[r.rid for r in eng.active if r is not None])
    stats = eng.summary()
    shed = getattr(eng, "shed", {})
    assert all(r.done or r.rid in shed for r in reqs.values())
    trace = dict(
        scenario=scenario.to_record(),
        policy=controller.policy.name,
        fence=fence,
        per_tick_batch=per_tick,
        occupancy={str(k): v for k, v in
                   sorted(stats["batch_occupancy"].items())},
        steps=stats["steps"], tokens=stats["tokens"],
        prefills=stats["prefills"],
        controller=controller.report(),
        per_step=[r.to_record() for r in controller.trace],
    )
    if disagg:
        trace["disagg"] = stats["disagg"]
    if scaler is not None:
        trace["autoscale"] = scaler.report()
    if spec_decode is not None:
        trace["spec_decode"] = dict(config=spec_decode.to_record(),
                                    **eng.spec_report())
    return trace


def replay_trace(trace: dict, cfg, params, planner, mesh=None,
                 device=None) -> dict:
    """Re-serve a recorded trace end to end and return the fresh record.

    The scenario schedule, policy, fence mode, speculative config, and —
    for a trace recorded through the disaggregated cells or the
    autoscaler — the ``DisaggConfig``, SLO assignment and
    ``AutoscaleConfig`` are taken from the trace itself, so a replay is
    byte-comparable to the recording (the serving goldens under
    ``tests/golden/``).
    """
    disagg: "bool | DisaggConfig" = False
    slo = None
    spec_decode = None
    autoscale = None
    if "disagg" in trace:
        disagg = DisaggConfig.from_record(trace["disagg"]["config"])
        slo = {int(r): s for r, s in trace["disagg"]["slo"].items()}
    if "spec_decode" in trace:
        spec_decode = SpecDecodeConfig.from_record(
            trace["spec_decode"]["config"])
    if "autoscale" in trace:
        autoscale = AutoscaleConfig.from_record(
            trace["autoscale"]["config"])
    return run_scenario(ScenarioSpec.from_record(trace["scenario"]),
                        cfg, params, planner, policy=trace["policy"],
                        fence=trace["fence"], mesh=mesh, disagg=disagg,
                        slo=slo, spec_decode=spec_decode,
                        autoscale=autoscale, device=device)

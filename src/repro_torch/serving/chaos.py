"""Chaos harness: seeded fault timelines composed over serve scenarios.

``core/faults.py`` owns the primitives (injection seams, breaker, retry,
event log); this module owns the choreography: a :class:`ChaosAction`
timeline says which fault fires at which serve tick,
:func:`make_chaos_timeline` derives a deterministic timeline from a seed
and a scope's degradation ladder, and :func:`run_chaos_scenario` drives
a real scenario run (``scenarios.run_scenario``) with the timeline
firing from the driver's ``on_tick`` hook — retries backing off against
a :class:`~repro_torch.core.faults.VirtualClock`, so a chaos run never
really sleeps.  :func:`chaos_hooks` and :func:`incident_record` are the
two halves of that harness for any driver with an ``on_tick`` hook (the
serve daemon's too).

Because every ladder rung is bit-identical and cache poison or eviction
only changes where a lane total comes from, a faulted run completes the
same requests with the same outputs as a healthy one; for fault
schedules that never touch scheduling (backend, cache and planner
faults) the whole trace is identical.  Scheduling faults (handoff
pressure, admission shedding) shift when work happens, never what it
computes.  Every injected fault and every degradation step lands in the
trace's ``"chaos"`` record (timeline, event log, breaker state), so the
same seed and config reproduce the same incident byte for byte.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import engine, faults
from .scenarios import ScenarioSpec, make_scenario, run_scenario

CHAOS_SITES = (
    "backend", "lane_cache.poison", "lane_cache.scrub",
    "lane_cache.storm", "handoff", "planner", "replan",
)

# Actions that neither arm faults nor corrupt state: the subset a
# fault-free baseline run replays so its control flow (replans, cache
# temperature) matches the chaos run's.
NEUTRAL_ACTIONS = ("lane_cache.scrub", "lane_cache.storm", "replan")


@dataclasses.dataclass(frozen=True)
class ChaosAction:
    """One scheduled fault: at serve tick ``tick``, do ``action``.

    ``backend.<rung>`` arms ``count`` injected failures at that ladder
    rung (``count < 0``: persistent, the breaker-trip path);
    ``lane_cache.poison`` corrupts ``count`` cached lane entries in
    place; ``lane_cache.scrub`` runs the integrity sweep;
    ``lane_cache.storm`` drops the whole lane LRU cold; ``handoff`` arms
    ``count`` ticks of simulated handoff-queue pressure (the prefill cell
    stalls); ``planner`` arms ``count`` planner failures; ``replan``
    forces the serve controller through a refresh re-plan, so armed
    backend faults and cold caches are hit mid-run.
    """

    tick: int
    action: str
    count: int = 1
    note: str = ""

    def to_record(self) -> dict:
        return dict(tick=self.tick, action=self.action,
                    count=self.count, note=self.note)

    @staticmethod
    def from_record(rec: dict) -> "ChaosAction":
        return ChaosAction(**rec)


def baseline_timeline(timeline: list[ChaosAction]) -> list[ChaosAction]:
    """The fault-free shadow of a timeline: only the neutral actions
    (scrubs, storms, forced replans) survive, so a healthy run driven by
    it makes the same planner queries and cache misses."""
    return [a for a in timeline if a.action in NEUTRAL_ACTIONS]


def apply_action(act: ChaosAction, inj: faults.FaultInjector,
                 eng=None) -> None:
    """Fire one timeline action (called at its tick by the driver)."""
    if act.action.startswith("backend."):
        inj.arm(act.action, count=act.count,
                message=act.note or f"chaos: {act.action}")
    elif act.action == "lane_cache.poison":
        n = engine.lane_cache_poison(act.count, seed=act.tick)
        faults.record_event("lane_cache", "inject",
                            f"poisoned {n} cached lane entries")
    elif act.action == "lane_cache.scrub":
        engine.lane_cache_verify()
    elif act.action == "lane_cache.storm":
        info = engine.lane_cache_info()
        engine.lane_cache_clear()
        faults.record_event(
            "lane_cache", "inject",
            f"eviction storm: {info['size']} entries dropped cold")
    elif act.action in ("handoff", "planner"):
        inj.arm(act.action, count=act.count,
                message=act.note or f"chaos: {act.action} pressure")
    elif act.action == "replan":
        ctrl = getattr(eng, "controller", None)
        if ctrl is not None:
            batch = ctrl.trace[-1].batch if ctrl.trace else 1
            ctrl.replan(batch, refresh=True)
    else:
        raise ValueError(f"unknown chaos action {act.action!r}")


def make_chaos_timeline(seed: int = 0, horizon: int = 30,
                        rungs: list[str] | None = None,
                        scheduling: bool = True,
                        scope=None) -> list[ChaosAction]:
    """A deterministic fault timeline covering every seam.

    The same ``(seed, horizon, rungs, scheduling)`` always gives the same
    actions at the same ticks; ``rungs`` defaults to ``scope``'s ladder
    (``engine.ladder_rungs(scope)``).  One transient fault on the top
    rung before the first plan, one persistent burst on it mid-run when a
    lower rung exists (trips the breaker, steps the ladder down), a
    lane-cache poison caught by a scrub a tick later, four eviction
    storms each followed by a forced re-plan, a planner fault before the
    first plan and, with ``scheduling``, handoff pressure.
    ``scheduling=False`` gives a timeline whose faults cannot move work
    between ticks.
    """
    rungs = (list(rungs) if rungs is not None
             else engine.ladder_rungs(scope))
    rng = np.random.default_rng(seed)
    top = "backend." + rungs[0]
    acts = [
        ChaosAction(0, "planner", 1, "planner timeout before first plan"),
        ChaosAction(0, top, 1, "transient fault on the initial plan"),
    ]
    t0 = 2 + int(rng.integers(0, max(horizon // 4, 1)))
    acts.append(ChaosAction(t0, "lane_cache.poison",
                            1 + int(rng.integers(0, 2))))
    acts.append(ChaosAction(t0 + 1, "lane_cache.scrub", 0))
    if len(rungs) > 1:
        acts.append(ChaosAction(
            t0 + 1, top, -1,
            "persistent: trip the breaker, step the ladder down"))
    # Eviction-storm + forced-replan pairs (the storm sorts first at
    # equal ticks): each drops the cache cold and re-plans at once, so
    # every pair re-resolves the same lanes and hits whatever is armed.
    gap = max(2, horizon // 8)
    for k in range(4):
        acts.append(ChaosAction(t0 + 2 + k * gap, "lane_cache.storm", 0))
        acts.append(ChaosAction(t0 + 2 + k * gap, "replan", 0,
                                f"forced refresh replan {k + 1}/4"))
    if scheduling:
        acts.append(ChaosAction(int(rng.integers(2, max(horizon - 2, 3))),
                                "handoff", int(rng.integers(1, 4))))
    return sorted(acts, key=lambda a: (a.tick, a.action))


def default_timeline(spec: ScenarioSpec, seed: int) -> list[ChaosAction]:
    """:func:`make_chaos_timeline` over ``spec``'s arrival horizon."""
    horizon = (max(a.step for a in spec.arrivals) + 1
               if spec.arrivals else 1)
    return make_chaos_timeline(seed, horizon=max(horizon, 8))


def chaos_hooks(timeline: list[ChaosAction], breaker_threshold: int = 3):
    """Reset the fault state (events, the process breaker at
    ``breaker_threshold``) and return ``(injector, clock, on_tick)``:
    run the driver with ``on_tick`` inside ``faults.fault_scope(injector)``
    and ``faults.retry_scope(clock=clock)``, then ``faults.set_tick(None)``."""
    by_tick: dict[int, list[ChaosAction]] = {}
    for act in timeline:
        by_tick.setdefault(act.tick, []).append(act)
    clock = faults.VirtualClock()
    inj = faults.FaultInjector()
    faults.reset_events()
    faults.configure_breaker(breaker_threshold)

    def on_tick(t: int, eng) -> None:
        faults.set_tick(t)
        for act in by_tick.get(t, ()):
            apply_action(act, inj, eng)

    return inj, clock, on_tick


def incident_record(seed: int, timeline: list[ChaosAction],
                    inj: faults.FaultInjector, clock: faults.VirtualClock,
                    breaker_threshold: int, retries: int,
                    scopes=()) -> dict:
    """The trace's ``"chaos"`` record: timeline, every event, the breaker
    state and the simulated backoff sleeps; ``scope_breakers`` (each
    scope's breaker, by name) only when a given scope has its own."""
    rec = dict(
        seed=seed,
        breaker_threshold=breaker_threshold,
        retries=retries,
        timeline=[a.to_record() for a in timeline],
        injected=inj.injected,
        events=faults.events(),
        breaker=faults.backend_breaker().info(),
        backoff_sleeps=list(clock.sleeps),
    )
    scoped = [s for s in scopes if s is not None and s.breaker is not None]
    if scoped:
        rec["scope_breakers"] = {s.name or f"scope{i}": s.breaker.info()
                                 for i, s in enumerate(scoped)}
    return rec


def run_chaos_scenario(cfg, params, planner,
                       scenario: "ScenarioSpec | None" = None,
                       seed: int = 0, quick: bool = False,
                       slots: int = 8, policy: str = "sticky",
                       fence: bool = True,
                       timeline: "list[ChaosAction] | None" = None,
                       breaker_threshold: int = 3, retries: int = 1,
                       mesh=None, disagg=False, slo=None,
                       spec_decode=None,
                       policy_kw: dict | None = None,
                       prefill_scope=None, decode_scope=None,
                       device=None) -> dict:
    """Serve a scenario under a seeded fault timeline; return the trace.

    Resets the fault state, runs ``scenarios.run_scenario`` with the
    timeline firing via ``on_tick`` and retry backoffs on a virtual
    clock, and attaches the incident record (:func:`incident_record`)
    under ``trace["chaos"]``.  Deterministic end to end: the golden
    chaos trace pins the whole record.  ``prefill_scope`` /
    ``decode_scope`` (require ``disagg``) give each cell its own ladder
    and breaker.  ``device`` is the model's (default: the card); the
    lane mesh (``mesh``) is not ported and raises
    ``NotImplementedError``.
    """
    spec = scenario if scenario is not None else \
        make_scenario("chaos", seed=seed, slots=slots, quick=quick)
    if timeline is None:
        timeline = default_timeline(spec, seed)
    inj, clock, on_tick = chaos_hooks(timeline, breaker_threshold)
    try:
        with faults.fault_scope(inj), \
                faults.retry_scope(retries=retries, clock=clock):
            trace = run_scenario(
                spec, cfg, params, planner, policy=policy, fence=fence,
                policy_kw=policy_kw, mesh=mesh, disagg=disagg, slo=slo,
                spec_decode=spec_decode, prefill_scope=prefill_scope,
                decode_scope=decode_scope, on_tick=on_tick, device=device)
    finally:
        faults.set_tick(None)
    trace["chaos"] = incident_record(seed, timeline, inj, clock,
                                     breaker_threshold, retries,
                                     (prefill_scope, decode_scope))
    return trace

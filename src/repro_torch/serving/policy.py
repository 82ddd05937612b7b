"""Adaptive offload control: closed-loop policies over the planner.

The ``OffloadPlanner`` answers "which GEMV sites does PIM win at batch
B?"; this module decides *when that question is asked*.  In a live
decode loop the batch size shifts every step (requests finish, bursts
arrive), and per-step recomputation — today's ``step_telemetry``
behavior — issues one planner query per decode step.  The
``OffloadController`` wraps the planner behind pluggable policies:

* ``per-step`` — recompute the oracle offload set every step (the
  baseline and, by construction, the realized-speedup oracle).
* ``hysteresis`` — a site's host/PIM assignment flips only after the
  batch has sat on the other side of its crossover for K consecutive
  steps, so occupancy jitter around a crossover cannot thrash the
  decision.  Planner queries drop from one-per-step to one at startup.
* ``sticky`` — keep one epoch's offload set until the occupancy drifts
  away from the epoch's reference batch or the engine's resolved-lane
  cache reports a miss (``engine.lane_cache_info`` — the world went
  cold, e.g. the cache was cleared or reconfigured); only then re-plan,
  optionally re-deriving decisions through the simulator
  (``OffloadPlanner.invalidate``), which a warm lane cache turns into
  dict lookups instead of fleet work.

Every policy reports decision-switch counts, planner queries/replans
and realized-vs-oracle occupancy-weighted speedup, so "cheaper control"
is always measured against "how much speedup it gave up".
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import engine, faults, trace
from .offload import offload_set, step_cost


class OffloadPolicy:
    """Decides the offload site-set shown one live batch size per step."""

    name = "base"

    def offload_for(self, controller: "OffloadController", step: int,
                    batch: int) -> frozenset:
        raise NotImplementedError


class PerStepPolicy(OffloadPolicy):
    """Recompute the oracle offload set every decode step."""

    name = "per-step"

    def offload_for(self, controller, step, batch):
        return controller.query(batch)


class HysteresisPolicy(OffloadPolicy):
    """Damp decision flips inside a band around each site's crossover.

    Per-site state machines over the exact crossover batch
    ``b* = host_ns / pim_ns``:

    * **outside the band** (``batch < b*/band`` or ``batch > b*·band``)
      the decision is wrong by a margin worth paying for — the site
      flips to the per-step oracle immediately, so out-of-band steps
      decide *identically* to per-step recompute;
    * **inside the band** the penalty for a stale assignment is small
      (cost ratio bounded by ``band``), so the site keeps its current
      assignment until the batch has disagreed with it for ``k``
      consecutive steps (any agreeing step resets the streak) —
      occupancy jitter around a crossover cannot thrash the decision.

    The fuzzed properties: per-site flips never exceed the trace's
    crossings of that site's threshold, in-band-committed flips are
    further bounded by ``steps // k``, and every out-of-band step
    matches per-step recompute exactly.
    """

    name = "hysteresis"

    def __init__(self, k: int = 3, band: float = 1.25):
        if k < 1:
            raise ValueError("hysteresis window k must be >= 1")
        if band < 1.0:
            raise ValueError("hysteresis band must be >= 1.0")
        self.k = int(k)
        self.band = float(band)
        self._state: dict | None = None
        self._streak: dict = {}

    def in_band(self, decision, batch: int) -> bool:
        crossover = decision.host_ns / max(decision.pim_ns, 1e-9)
        return crossover / self.band < batch < crossover * self.band

    def offload_for(self, controller, step, batch):
        decisions = controller.decisions
        if self._state is None:
            first = controller.query(batch)
            self._state = {d.site.name: d.site.name in first
                           for d in decisions}
            self._streak = {d.site.name: 0 for d in decisions}
            return first
        for d in decisions:
            name = d.site.name
            desired = d.offload_at(batch)
            if desired == self._state[name]:
                self._streak[name] = 0
            elif not self.in_band(d, batch):
                self._state[name] = desired
                self._streak[name] = 0
            else:
                self._streak[name] += 1
                if self._streak[name] >= self.k:
                    self._state[name] = desired
                    self._streak[name] = 0
        return frozenset(n for n, on in self._state.items() if on)


class StickyPolicy(OffloadPolicy):
    """One offload set per epoch; re-plan on drift or lane-cache miss.

    The epoch's set is the oracle at its reference batch.  A new epoch
    starts on occupancy drift — the running mean since the epoch began
    moves more than ``drift`` slots from the reference after
    ``min_epoch`` steps (slow ramps), or a single step jumps
    ``jump`` or more slots away (bursts, drain/refill cliffs) — or when
    the engine's resolved-lane cache records a miss since the epoch
    began: the signal that the memoized timing world went cold.  Drift
    replans re-derive the set from the already-cached decisions; cold
    replans ``refresh`` through ``OffloadPlanner.invalidate`` so the
    decisions themselves are re-resolved (cheaply, when the lane cache
    is warm).
    """

    name = "sticky"

    def __init__(self, drift: float = 0.75, min_epoch: int = 3,
                 jump: float = 2.0, watch_lane_cache: bool = True):
        self.drift = float(drift)
        self.min_epoch = int(min_epoch)
        self.jump = float(jump)
        self.watch_lane_cache = watch_lane_cache
        self._set: frozenset | None = None
        self._ref = 0.0
        self._sum = 0
        self._n = 0
        self._miss0 = 0

    def _epoch(self, batch: int, offload: frozenset) -> frozenset:
        self._set = offload
        self._ref = float(batch)
        self._sum = 0
        self._n = 0
        self._miss0 = engine.lane_cache_info()["misses"]
        return offload

    def _cold(self) -> bool:
        return (self.watch_lane_cache
                and engine.lane_cache_info()["misses"] > self._miss0)

    def offload_for(self, controller, step, batch):
        if self._set is None:
            return self._epoch(batch, controller.query(batch))
        if self._cold():
            return self._epoch(batch,
                               controller.replan(batch, refresh=True))
        if abs(batch - self._ref) >= self.jump:
            return self._epoch(batch, controller.replan(batch))
        self._sum += batch
        self._n += 1
        mean = self._sum / self._n
        if self._n >= self.min_epoch and abs(mean - self._ref) > self.drift:
            return self._epoch(batch, controller.replan(batch))
        return self._set


POLICIES = {
    PerStepPolicy.name: PerStepPolicy,
    HysteresisPolicy.name: HysteresisPolicy,
    StickyPolicy.name: StickyPolicy,
}


def resolve_policy(name: str) -> str:
    """Canonicalize a policy name or raise listing every valid one.

    The :func:`~repro_torch.serving.scenarios.resolve_scenario` analogue:
    CLI-friendly underscore aliases map to the registry's dashed names
    (``per_step`` → ``per-step``) and unknown names fail with the full
    menu at validation time — the launchers route ``--policy`` through
    this instead of a frozen argparse ``choices`` list.
    """
    cand = str(name).replace("_", "-")
    if cand in POLICIES:
        return cand
    raise ValueError(f"unknown offload policy {name!r}; "
                     f"choose from {sorted(POLICIES)}")


def make_policy(name: str, **kw) -> OffloadPolicy:
    return POLICIES[resolve_policy(name)](**kw)


@dataclasses.dataclass
class StepRecord:
    """What the controller decided (and what it cost) for one step."""

    step: int
    batch: int
    offloaded: int          # |offload set|
    speedup: float          # host_ns / realized mixed_ns for this step

    def to_record(self) -> dict:
        return dict(step=self.step, batch=self.batch,
                    offloaded=self.offloaded, speedup=self.speedup)


class OffloadController:
    """Closed-loop decision maker between a serving loop and the planner.

    ``observe(batch)`` is called once per decode step with the live
    batch size and returns the step's :class:`StepRecord`; the chosen
    offload set is whatever the policy says.  The controller accounts
    every step twice — once at the policy's set (realized) and once at
    the per-step oracle set — so ``report()`` can state exactly how much
    speedup the cheaper control loop gave up, alongside the planner
    query/replan counts it saved.

    ``planner`` must provide ``plan(fence=, spec=)`` returning
    ``OffloadDecision``s and ``invalidate()``; the property tests drive
    the controller with a stub, the serving stack with the real
    :class:`~repro_torch.serving.offload.OffloadPlanner`.

    A planner failure degrades to host-only serving only when it is an
    injected fault (:class:`~repro_torch.core.faults.InjectedFault`);
    any other exception propagates once :func:`faults.retry_call` has
    spent its retries, so a kernel that fails to build or launch on the
    card ends the run instead of passing as "nothing offloaded".
    """

    def __init__(self, planner, policy: str | OffloadPolicy = "per-step",
                 fence: bool = True, spec=None, **policy_kw):
        self.planner = planner
        self.fence = fence
        self.spec = spec
        self.policy = (policy if isinstance(policy, OffloadPolicy)
                       else make_policy(policy, **policy_kw))
        self.planner_queries = 0
        self.replans = 0
        self.switches = 0
        self.switch_log: list[dict] = []
        self.trace: list[StepRecord] = []
        self.set_log: list[frozenset] = []
        self._decisions = None
        self._current: frozenset | None = None
        self._step = 0
        self._host_ns = 0.0
        self._mixed_ns = 0.0
        self._oracle_ns = 0.0
        self.planner_degraded = False

    # -- planner access (the accounting boundary) ----------------------
    @property
    def decisions(self):
        if self._decisions is None:
            try:
                self._decisions = faults.retry_call(
                    lambda: self.planner.plan(fence=self.fence,
                                              spec=self.spec),
                    site="planner")
            except faults.InjectedFault as e:
                # Degrade to host-only serving: an empty decision set
                # offloads nothing, so the serve loop keeps running
                # (correct tokens, no PIM speedup) instead of crashing.
                self.planner_degraded = True
                self._decisions = []
                faults.record_event(
                    "planner", "degrade",
                    f"host-only offload set after planner failure: "
                    f"{type(e).__name__}: {e}")
        return self._decisions

    def query(self, batch: int) -> frozenset:
        """Derive the oracle offload set at ``batch`` — counted; the
        whole point of a policy is issuing fewer of these."""
        self.planner_queries += 1
        return offload_set(self.decisions, batch)

    def replan(self, batch: int, refresh: bool = False) -> frozenset:
        """A counted re-plan; ``refresh`` also re-derives the decisions
        through the planner (simulator query, lane-cache-cheap when
        warm) instead of reusing the cached ones."""
        if refresh:
            self.planner.invalidate()
            self._decisions = None
        self.replans += 1
        return self.query(batch)

    # -- the per-step control loop -------------------------------------
    def observe(self, batch: int) -> StepRecord:
        with trace.span("policy.observe"):
            offload = self.policy.offload_for(self, self._step, batch)
            if self._current is not None and offload != self._current:
                self.switches += 1
                self.switch_log.append(dict(
                    step=self._step, batch=batch,
                    on=sorted(offload - self._current),
                    off=sorted(self._current - offload)))
            self._current = offload
            host, mixed = step_cost(self.decisions, batch, offload)
            _, oracle = step_cost(self.decisions, batch,
                                  offload_set(self.decisions, batch))
            self._host_ns += host
            self._mixed_ns += mixed
            self._oracle_ns += oracle
            rec = StepRecord(step=self._step, batch=batch,
                             offloaded=len(offload),
                             speedup=host / max(mixed, 1e-9))
            self.trace.append(rec)
            self.set_log.append(offload)
            self._step += 1
            return rec

    def report(self) -> dict:
        steps = self._step
        if steps == 0 or self._host_ns == 0:
            # No steps, or a planner-degraded run whose empty decision
            # set accrued zero cost — every ratio is neutral.
            realized = oracle = efficiency = 1.0
        else:
            realized = self._host_ns / max(self._mixed_ns, 1e-9)
            oracle = self._host_ns / max(self._oracle_ns, 1e-9)
            efficiency = self._oracle_ns / max(self._mixed_ns, 1e-9)
        out = dict(policy=self.policy.name, steps=steps,
                   switches=self.switches,
                   planner_queries=self.planner_queries,
                   replans=self.replans,
                   host_ns=self._host_ns, mixed_ns=self._mixed_ns,
                   oracle_ns=self._oracle_ns,
                   realized_speedup=realized, oracle_speedup=oracle,
                   efficiency=efficiency,
                   switch_log=list(self.switch_log))
        if self.planner_degraded:
            # Conditional so healthy reports (and pinned golden traces)
            # keep their exact key set.
            out["planner_degraded"] = True
        return out

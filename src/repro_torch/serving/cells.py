"""Disaggregated serving: a prefill cell and a decode cell joined by a
KV-handoff queue.

Production LLM serving splits prefill (compute-bound, long prompts) and
decode (memory-bound, the LP5X-PIM sweet spot) into cells with different
batching and offload economics.  This module is that split for the
serving engine:

* :class:`PrefillCell` owns the admission queue (per-tenant SLO classes,
  FIFO within a class, aging so throughput tenants cannot starve under
  latency bursts) and prefills prompts, each into a one-slot KV cache
  plus its first token, up to a per-tick budget, pushing the results
  onto the handoff queue.
* :class:`KVHandoffQueue` is the bounded FIFO between the cells; the
  prefill cell stalls rather than overrun it.
* :class:`DecodeCell` owns the batched KV cache and slots: handed-off
  requests are copied into free slots the moment slots free (continuous
  batching), and every tick runs ONE batched decode step over all active
  slots, the monolithic engine's decode loop
  (:class:`~repro_torch.serving.engine.DecodeLoop`).

Each cell can carry its own :class:`OffloadController` and its own
:class:`~repro_torch.core.engine.BackendScope` (requested backend and
circuit breaker): a cell activates its scope around its tick work, so a
prefill-side backend fault or breaker trip never changes the decode
cell's ladder.  Both cells share the process-global resolved-lane LRU,
so a prefill→decode handoff never re-resolves lanes.

Under ``DisaggConfig.mirror()`` (unbounded prefill and handoff, one SLO
class) the pair replays the monolithic engine tick for tick.  The
scheduling semantics are specified once in ``serving/scenarios.py``
(``simulate_disagg`` / ``_admission_pick``); this module is the
real-model implementation held against it.  Both cells run their model
on ``device`` (default: the card), where the parameters must lie.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine as lane_engine
from repro_torch.core import faults
from repro_torch.core.engine import resolve_device
from .engine import DecodeLoop, Request, merge_slot, prefill_one
from .offload import OffloadPlanner
from .policy import OffloadController
from .scenarios import (DisaggConfig, SLO_CLASSES, SLO_LATENCY,
                        SLO_THROUGHPUT)


def _scope_ctx(scope):
    """A cell's scope activation: ``backend_scope`` when the cell carries
    one, a no-op otherwise (unscoped cells keep whatever scope is
    active)."""
    return (lane_engine.backend_scope(scope) if scope is not None
            else contextlib.nullcontext())


class AdmissionQueue:
    """Per-SLO-class FIFO admission with aging (the anti-starvation rule).

    The pick order — starved throughput requests (waited >=
    ``starvation_age`` ticks) oldest first, then latency FIFO, then
    throughput FIFO — is ``scenarios._admission_pick``'s spec.  With a
    single class every rule degenerates to plain FIFO.
    """

    def __init__(self, starvation_age: int = 8):
        self.starvation_age = int(starvation_age)
        self._entries: list[tuple] = []    # (enq_tick, seq, Request, slo)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, req: Request, slo: str, tick: int) -> None:
        if slo not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {slo!r}; "
                             f"choose from {SLO_CLASSES}")
        self._entries.append((tick, self._seq, req, slo))
        self._seq += 1

    def pop(self, tick: int) -> tuple[Request, str, int]:
        """(request, slo, enqueue tick) of the next admission."""
        starved = [i for i, (enq, _, _, slo) in enumerate(self._entries)
                   if slo == SLO_THROUGHPUT
                   and tick - enq >= self.starvation_age]
        if starved:
            pick = min(starved, key=lambda i: self._entries[i][:2])
        else:
            latency = [i for i, e in enumerate(self._entries)
                       if e[3] == SLO_LATENCY]
            pool = latency or range(len(self._entries))
            pick = min(pool, key=lambda i: self._entries[i][:2])
        enq, _, req, slo = self._entries.pop(pick)
        return req, slo, enq

    def shed(self, tick: int) -> tuple[Request, str, int]:
        """(request, slo, enqueue tick) of the entry to drop under
        admission pressure, ``scenarios._shed_pick``'s spec: youngest
        non-starved throughput request first, then youngest latency,
        starved throughput only when nothing else waits."""
        fresh = [i for i, (enq, _, _, slo) in enumerate(self._entries)
                 if slo == SLO_THROUGHPUT
                 and tick - enq < self.starvation_age]
        if fresh:
            pick = max(fresh, key=lambda i: self._entries[i][:2])
        else:
            latency = [i for i, e in enumerate(self._entries)
                       if e[3] == SLO_LATENCY]
            pool = latency or range(len(self._entries))
            pick = max(pool, key=lambda i: self._entries[i][:2])
        enq, _, req, slo = self._entries.pop(pick)
        return req, slo, enq

    def wait_entries(self) -> list[tuple[int, str]]:
        """(enqueue tick, slo) of every waiting request — the per-class
        wait ages the autoscaler's grow signal reads."""
        return [(enq, slo) for enq, _, _, slo in self._entries]

    def rids(self) -> list[int]:
        """The waiting requests' ids, in queue order."""
        return [req.rid for _, _, req, _ in self._entries]


@dataclasses.dataclass
class KVHandoff:
    """One prefilled request in flight between the cells: the request,
    its one-slot KV cache (on the cells' device), its position after
    prefill."""

    req: Request
    cache: dict
    pos: int
    slo: str
    prefill_tick: int


class KVHandoffQueue:
    """Bounded FIFO of prefilled requests awaiting a decode slot."""

    def __init__(self, bound: int | None = None):
        self.bound = bound
        self._q: list[KVHandoff] = []
        self.handoffs = 0
        self.max_depth = 0
        self.waits: list[int] = []   # per-pop ticks spent in the queue

    def __len__(self) -> int:
        return len(self._q)

    def room(self) -> bool:
        inj = faults.injector()
        if inj is not None and inj.should_fail("handoff") is not None:
            # Simulated handoff pressure: report the queue full so the
            # prefill cell stalls this tick (the bound's graceful path).
            faults.record_event("handoff", "inject",
                                "simulated handoff pressure")
            faults.record_event("handoff", "stall",
                                "prefill cell stalls (queue reported full)")
            return False
        return self.bound is None or len(self._q) < self.bound

    def push(self, item: KVHandoff) -> None:
        if not self.room():
            raise RuntimeError(f"KV-handoff queue overrun (bound "
                               f"{self.bound}) — prefill cell must stall")
        self._q.append(item)
        self.handoffs += 1
        self.max_depth = max(self.max_depth, len(self._q))

    def pop(self, tick: int | None = None) -> KVHandoff:
        """FIFO pop; with ``tick`` the item's queue wait (ticks between
        prefill and decode admission) is recorded."""
        item = self._q.pop(0)
        if tick is not None:
            self.waits.append(int(tick) - item.prefill_tick)
        return item

    def rids(self) -> list[int]:
        return [h.req.rid for h in self._q]

    def report(self) -> dict:
        return dict(bound=self.bound, depth=len(self._q),
                    handoffs=self.handoffs, max_depth=self.max_depth)

    def wait_report(self) -> dict:
        """Queue-wait telemetry, neutral (``0.0`` mean) over no pops."""
        n = len(self.waits)
        return dict(pops=n,
                    mean_wait=(sum(self.waits) / n if n else 0.0),
                    max_wait=(max(self.waits) if n else 0))


class PrefillCell:
    """Admission + prompt prefill; produces KV handoffs.

    The prefill is the monolithic engine's (same one-slot cache, same
    ``M.prefill``, same greedy first token); only the copy into the
    batched cache is left to the decode cell, which lets this cell run
    ahead of slot availability.
    """

    def __init__(self, cfg: ArchConfig, params, max_seq: int,
                 budget: int | None = None, starvation_age: int = 8,
                 admission_capacity: int | None = None,
                 controller: Optional[OffloadController] = None,
                 scope: "lane_engine.BackendScope | None" = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.max_seq = max_seq
        self.budget = budget
        self.admission_capacity = admission_capacity
        self.queue = AdmissionQueue(starvation_age)
        self.controller = controller
        self.scope = scope
        self.stats = dict(prefills=0, ticks=0)
        self.prefill_ticks: dict[int, int] = {}
        self.enq_ticks: dict[int, int] = {}
        self.slo_of: dict[int, str] = {}
        self.shed: dict[int, int] = {}    # rid -> shed tick

    def submit(self, req: Request, slo: str, tick: int) -> None:
        self.queue.push(req, slo, tick)
        self.enq_ticks[req.rid] = tick
        self.slo_of[req.rid] = slo
        while (self.admission_capacity is not None
               and len(self.queue) > self.admission_capacity):
            # SLO-aware load shedding: drop the lowest-priority waiter
            # (the inverse admission order) instead of letting pressure
            # reach the handoff-overrun invariant.
            victim, vslo, _ = self.queue.shed(tick)
            self.shed[victim.rid] = tick
            faults.record_event(
                "admission", "shed",
                f"rid={victim.rid} slo={vslo} "
                f"(capacity {self.admission_capacity})", tick=tick)

    def _prefill(self, req: Request, slo: str, tick: int) -> KVHandoff:
        logits, cache = prefill_one(self.cfg, self.params, req,
                                    self.max_seq, self.device)
        req.out.append(int(torch.argmax(logits[0])))
        self.stats["prefills"] += 1
        return KVHandoff(req=req, cache=cache, pos=len(req.prompt),
                         slo=slo, prefill_tick=tick)

    def tick(self, t: int, handoff: KVHandoffQueue) -> int:
        """Prefill up to ``budget`` admitted requests while the handoff
        queue has room; returns the number prefilled.  Lane work runs
        under this cell's backend scope when one is set."""
        with _scope_ctx(self.scope):
            self.stats["ticks"] += 1
            n = 0
            while ((self.budget is None or n < self.budget)
                   and handoff.room() and len(self.queue)):
                req, slo, _ = self.queue.pop(t)
                item = self._prefill(req, slo, t)
                self.prefill_ticks[req.rid] = t
                handoff.push(item)
                n += 1
            if self.controller is not None and n > 0:
                self.controller.observe(n)
            return n

    def report(self) -> dict:
        out = dict(self.stats)
        out["waiting"] = len(self.queue)
        if self.admission_capacity is not None:
            out["shed"] = len(self.shed)
        if self.controller is not None:
            out["policy"] = self.controller.report()
        return out


class DecodeCell(DecodeLoop):
    """Batched continuous-batching decode over KV-cache slots.

    The decode loop is the monolithic engine's; admission comes from the
    handoff queue instead of a waiting list: a handed-off one-slot cache
    is copied, tensor by tensor in place, into the lowest free slot, FIFO.
    """

    def __init__(self, cfg: ArchConfig, params, slots: int, max_seq: int,
                 planner: Optional[OffloadPlanner] = None,
                 controller: Optional[OffloadController] = None,
                 step_telemetry: bool = False, spec_decode=None,
                 scope: "lane_engine.BackendScope | None" = None,
                 device=None):
        super().__init__(cfg, params, slots, max_seq, planner, controller,
                         step_telemetry, spec_decode, device)
        # Admission limit for autoscaling: the cache stays allocated at
        # ``slots`` (so growing is free) and only slots below ``limit``
        # accept new work; after a shrink, busy slots above the limit
        # finish their requests but are never refilled.
        self.limit = slots
        self.scope = scope

    def free_slots(self) -> int:
        return sum(1 for r in self.active if r is None)

    def admit(self, handoff: KVHandoffQueue, tick: int) -> int:
        """Copy handed-off requests into free slots below the admission
        limit, FIFO, lowest slot first: cache writes only, no lane
        work."""
        n = 0
        for slot in range(min(self.slots, self.limit)):
            if self.active[slot] is None and len(handoff):
                item = handoff.pop(tick)
                merge_slot(self.cache, item.cache, slot)
                self.pos[slot] = item.pos
                self.active[slot] = item.req
                self.admit_ticks[item.req.rid] = tick
                n += 1
        return n

    def step(self, tick: int) -> int:
        """One batched decode step; returns the batch size (0 = idle).
        Runs under this cell's backend scope when one is set."""
        with _scope_ctx(self.scope):
            return self._decode_active(tick)


class DisaggServingEngine:
    """The composed cell pair: one ``step()`` call is one driver tick.

    The serving engine's ``submit`` / ``step`` / ``run`` / ``summary``
    surface plus ``waiting`` / ``active`` / ``step_batches`` views, with
    the disaggregated internals: per tick the prefill cell admits and
    prefills (SLO-aware, budgeted, handoff-bounded), then the decode cell
    fills freed slots from the handoff queue and runs one batched decode
    step.
    """

    def __init__(self, cfg: ArchConfig, params, slots: int = 4,
                 max_seq: int = 256,
                 disagg: DisaggConfig | None = None,
                 planner: Optional[OffloadPlanner] = None,
                 controller: Optional[OffloadController] = None,
                 prefill_controller: Optional[OffloadController] = None,
                 step_telemetry: bool = False, spec_decode=None,
                 prefill_scope: "lane_engine.BackendScope | None" = None,
                 decode_scope: "lane_engine.BackendScope | None" = None,
                 device=None):
        device = resolve_device(device)
        self.disagg = disagg or DisaggConfig.mirror()
        self.handoff = KVHandoffQueue(self.disagg.handoff_bound)
        self.prefill_cell = PrefillCell(
            cfg, params, max_seq, budget=self.disagg.prefill_budget,
            starvation_age=self.disagg.starvation_age,
            admission_capacity=self.disagg.admission_capacity,
            controller=prefill_controller, scope=prefill_scope,
            device=device)
        self.decode_cell = DecodeCell(cfg, params, slots, max_seq,
                                      planner=planner,
                                      controller=controller,
                                      step_telemetry=step_telemetry,
                                      spec_decode=spec_decode,
                                      scope=decode_scope, device=device)
        self.ticks = 0

    # -- serving-engine views ------------------------------------------
    @property
    def active(self) -> list:
        return self.decode_cell.active

    @property
    def waiting(self) -> int:
        """Truthy while any request sits before its decode slot."""
        return len(self.prefill_cell.queue) + len(self.handoff)

    @property
    def step_batches(self) -> list[int]:
        return self.decode_cell.step_batches

    @property
    def completions(self) -> dict[int, int]:
        return self.decode_cell.completions

    @property
    def shed(self) -> dict[int, int]:
        """rid -> tick of every request dropped by admission shedding."""
        return self.prefill_cell.shed

    @property
    def planner(self):
        return self.decode_cell.planner

    @property
    def controller(self):
        return self.decode_cell.controller

    def queued_rids(self) -> list[int]:
        """Requests waiting for a decode slot: admission queue, then
        handoff queue."""
        return self.prefill_cell.queue.rids() + self.handoff.rids()

    def submit(self, req: Request, slo: str = SLO_LATENCY) -> None:
        self.prefill_cell.submit(req, slo, self.ticks)

    def spec_report(self) -> dict:
        """The decode cell's speculative telemetry."""
        return self.decode_cell.spec_report()

    def step(self) -> bool:
        """One tick: prefill → handoff admission → batched decode.
        Returns True when the decode cell actually stepped."""
        t = self.ticks
        self.ticks += 1
        self.prefill_cell.tick(t, self.handoff)
        self.decode_cell.admit(self.handoff, t)
        return self.decode_cell.step(t) > 0

    def run(self, max_steps: int = 1000) -> dict:
        while (any(self.active) or self.waiting) and max_steps > 0:
            self.step()
            max_steps -= 1
        return self.summary()

    # -- reporting -----------------------------------------------------
    def request_ticks(self) -> dict:
        """Per-request scheduling record, keyed like the model-free
        simulator's output."""
        return dict(prefill_ticks=dict(self.prefill_cell.prefill_ticks),
                    admit_ticks=dict(self.decode_cell.admit_ticks),
                    completion_ticks=dict(self.decode_cell.completions))

    def wait_telemetry(self, tick: int | None = None) -> dict:
        """Per-class admission-wait ages of the requests still waiting,
        neutral over empty queues (``max_wait=0``, ``mean_wait=0.0``)."""
        t = self.ticks if tick is None else int(tick)
        ages: dict[str, list[int]] = {cls: [] for cls in SLO_CLASSES}
        for enq, slo in self.prefill_cell.queue.wait_entries():
            ages[slo].append(t - enq)
        out = {}
        for cls in SLO_CLASSES:
            a = ages[cls]
            out[cls] = dict(waiting=len(a),
                            max_wait=(max(a) if a else 0),
                            mean_wait=(sum(a) / len(a) if a else 0.0))
        return out

    def scopes_report(self) -> dict | None:
        """Per-cell backend-scope record (None when neither cell is
        scoped, so unscoped summaries keep their keys)."""
        pre, dec = self.prefill_cell.scope, self.decode_cell.scope
        if pre is None and dec is None:
            return None
        return dict(
            prefill=(pre.describe() if pre is not None else None),
            decode=(dec.describe() if dec is not None else None))

    def _slo_summary(self) -> dict:
        """Per-class wait and latency means, neutral (0.0) over zero
        completions."""
        out = {}
        cell = self.prefill_cell
        for cls in SLO_CLASSES:
            rids = [r for r, s in cell.slo_of.items() if s == cls]
            done = [r for r in rids if r in self.completions]
            waits = [self.decode_cell.admit_ticks[r] - cell.enq_ticks[r]
                     for r in done]
            lats = [self.completions[r] - cell.enq_ticks[r] for r in done]
            out[cls] = dict(
                submitted=len(rids), completed=len(done),
                mean_admit_wait=(sum(waits) / len(done) if done else 0.0),
                mean_completion_ticks=(sum(lats) / len(done)
                                       if done else 0.0))
        return out

    def summary(self) -> dict:
        """The monolithic engine's summary shape plus the disaggregation
        record under ``"disagg"``; neutral on zero-request runs."""
        dec = self.decode_cell
        steps = dec.stats["steps"]
        out = dict(steps=steps, tokens=dec.stats["tokens"],
                   prefills=self.prefill_cell.stats["prefills"])
        out["batch_occupancy"] = dict(dec.batch_occupancy)
        out["completed"] = len(self.completions)
        out["in_flight"] = (sum(r is not None for r in dec.active)
                            + self.waiting)
        out["tokens_per_step"] = (dec.stats["tokens"] / steps
                                  if steps else 0.0)
        if dec.planner is not None:
            out["pim_telemetry"] = dec.pim_telemetry()
        if dec.controller is not None:
            out["policy"] = dec.controller.report()
        out["disagg"] = dict(
            config=self.disagg.to_record(),
            handoff=self.handoff.report(),
            prefill=self.prefill_cell.report(),
            slo={str(r): s for r, s in
                 sorted(self.prefill_cell.slo_of.items())},
            per_class=self._slo_summary(),
            requests={k: {str(r): t for r, t in sorted(v.items())}
                      for k, v in self.request_ticks().items()})
        if self.disagg.admission_capacity is not None:
            # Present only under bounded admission, as in the JAX
            # package's traces.
            out["disagg"]["shed"] = {
                str(r): t for r, t in sorted(self.shed.items())}
        scopes = self.scopes_report()
        if scopes is not None:
            out["disagg"]["scopes"] = scopes
        return out

"""Long-running serve daemon over the disaggregated cell pair.

The scenario driver (``scenarios.run_scenario``) serves a finite,
scripted arrival schedule and exits.  This module keeps the cell pair
serving:

* :class:`ServeDaemon` drives a :class:`~.cells.DisaggServingEngine`
  tick by tick from two arrival sources — a seeded scenario arrival
  process merged with a thread-safe injectable queue
  (:meth:`ServeDaemon.inject`) — and offers drain (stop ingest, serve
  out every queued request) and hard shutdown (stop now, account for
  every request), raising :class:`~.scenarios.ScenarioDrainError` with
  the queues' state on a stuck drain.  Idle ticks wait on the shared
  clock protocol (``faults.VirtualClock`` / ``faults.SystemClock``), so
  tests never really sleep.
* :class:`TraceWriter` streams the run's trace as tick-ordered JSON
  lines in chunks from a bounded buffer; :meth:`TraceWriter.load`
  reassembles the trace the in-memory path would have built, which
  replays through ``scenarios.replay_trace``.
* :class:`AutoscaleController` grows and shrinks the decode cell's
  admission limit against the per-class SLO wait ages the cells report:
  the real-cell implementation of the :class:`~.scenarios.AutoscaleConfig`
  rule that ``scenarios.simulate_disagg`` specifies model-free.

Per-cell :class:`~repro_torch.core.engine.BackendScope` objects ride
through unchanged: a prefill cell that degrades keeps the decode cell's
ladder untouched.  Every model and lane-resolver call runs in the thread
that calls :meth:`ServeDaemon.run` / :meth:`ServeDaemon.step`; other
threads only enqueue host data through :meth:`ServeDaemon.inject`.
"""
from __future__ import annotations

import json
import threading

import numpy as np

from repro_torch.core import faults
from repro_torch.core import engine as lane_engine
from .engine import Request
from .scenarios import (AutoscaleConfig, DisaggConfig, ScenarioDrainError,
                        ScenarioSpec, SLO_LATENCY)


class AutoscaleController:
    """Cross-cell decode-slot autoscaling over the live cell pair.

    The independent real-cell implementation of THE grow/shrink rule
    :class:`~.scenarios.AutoscaleConfig` documents (and
    ``simulate_disagg(..., autoscale=...)`` implements model-free):
    grow the decode admission limit on per-class SLO wait pressure,
    shrink it on sustained idleness, one slot per action, with a
    cooldown between actions.  ``observe(t)`` must run once at the end
    of every engine tick — the recorded ``limits`` trace is the limit
    that was in force *during* that tick, which is what the parity
    battery diffs against the simulator's.
    """

    def __init__(self, cfg: AutoscaleConfig, engine):
        self.cfg = cfg
        self.eng = engine
        cap = engine.decode_cell.slots
        self.max_slots = min(cfg.max_slots or cap, cap)
        self.limit = min(cfg.start_slots or cfg.min_slots, self.max_slots)
        engine.decode_cell.limit = self.limit
        self.limits: list[int] = []
        self.grows = 0
        self.shrinks = 0
        self._cool = 0
        self._idle = 0

    def observe(self, t: int) -> int:
        """Apply the end-of-tick rule; returns the limit for the next
        tick.  Mirrors ``simulate_disagg``'s autoscale block exactly —
        same telemetry, same branch order, same counters."""
        eng = self.eng
        self.limits.append(self.limit)
        busy = sum(1 for r in eng.decode_cell.active if r is not None)
        pressure = sum(
            1 for enq, slo in eng.prefill_cell.queue.wait_entries()
            if t - enq >= self.cfg.class_wait(slo))
        if self._cool > 0:
            self._cool -= 1
        elif pressure > 0 and self.limit < self.max_slots:
            self.limit += 1
            self.grows += 1
            self._cool = self.cfg.cooldown
            self._idle = 0
        elif (len(eng.prefill_cell.queue) == 0 and len(eng.handoff) == 0
              and busy < self.limit):
            self._idle += 1
            if (self._idle >= self.cfg.idle_ticks
                    and self.limit > self.cfg.min_slots):
                self.limit -= 1
                self.shrinks += 1
                self._cool = self.cfg.cooldown
                self._idle = 0
        else:
            self._idle = 0
        eng.decode_cell.limit = self.limit
        return self.limit

    def report(self) -> dict:
        """Trace record: embedded config (for replay) + the per-tick
        limit trace + action counts + slot-ticks actually provisioned
        (the fixed-slot oracle would provision ``slots * ticks``)."""
        return dict(config=self.cfg.to_record(),
                    limits=list(self.limits),
                    grows=self.grows, shrinks=self.shrinks,
                    slot_ticks=sum(self.limits))


class TraceWriter:
    """Streaming trace export: tick-ordered JSONL, bounded memory.

    Records are written as canonical JSON lines (sorted keys) in three
    kinds — one ``meta`` record first (the trace's scalar header:
    scenario, policy, fence), one ``tick`` record per driver tick, one
    ``summary`` record last (everything else).  Lines accumulate in a
    buffer of at most ``chunk_records`` and are flushed chunk-wise, so
    the writer's memory never grows with the run; :meth:`load`
    reassembles the trace dict from the chunks byte-identically to the
    in-memory path (the daemon battery asserts the canonical dumps are
    equal), and the result replays through ``scenarios.replay_trace``
    like any recorded trace.
    """

    def __init__(self, path, chunk_records: int = 256):
        if chunk_records < 1:
            raise ValueError("chunk_records must be >= 1")
        self.path = str(path)
        self.chunk_records = int(chunk_records)
        self._f = open(self.path, "w", encoding="utf-8")
        self._buf: list[str] = []
        self._ticks = 0
        self.records = 0
        self.flushes = 0
        self._closed = False

    def _write(self, record: dict) -> None:
        self._buf.append(json.dumps(record, sort_keys=True))
        self.records += 1
        if len(self._buf) >= self.chunk_records:
            self.flush()

    def write_meta(self, **fields) -> None:
        self._write(dict(kind="meta", **fields))

    def write_tick(self, tick: int, batch: int) -> None:
        if tick != self._ticks:
            raise ValueError(f"tick records must be tick-ordered: "
                             f"expected {self._ticks}, got {tick}")
        self._ticks += 1
        self._write(dict(kind="tick", tick=int(tick), batch=int(batch)))

    def write_summary(self, fields: dict) -> None:
        self._write(dict(kind="summary", summary=fields))

    def flush(self) -> None:
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._f.flush()
            self._buf.clear()
            self.flushes += 1

    def close(self) -> None:
        if not self._closed:
            self.flush()
            self._f.close()
            self._closed = True

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @staticmethod
    def load(path) -> dict:
        """Reassemble a streamed trace into the in-memory trace dict.

        Concatenated chunks parse line-wise; ``tick`` records (asserted
        contiguous and in order) become ``per_tick_batch``, and the
        ``meta`` / ``summary`` records merge into the scalar keys —
        byte-identical, under canonical JSON dumps, to the trace the
        daemon would have built in RAM.
        """
        meta: dict = {}
        summary: dict = {}
        per_tick: list[int] = []
        with open(str(path), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind = rec.pop("kind")
                if kind == "meta":
                    meta.update(rec)
                elif kind == "tick":
                    if rec["tick"] != len(per_tick):
                        raise ValueError(
                            f"trace stream out of order: tick "
                            f"{rec['tick']} at position {len(per_tick)}")
                    per_tick.append(rec["batch"])
                elif kind == "summary":
                    summary.update(rec["summary"])
                else:
                    raise ValueError(f"unknown trace record kind {kind!r}")
        return dict(**meta, per_tick_batch=per_tick, **summary)


class ServeDaemon:
    """Continuous driver for the disaggregated cell pair.

    One instance owns one :class:`~.cells.DisaggServingEngine` (built
    with the same controller/planner wiring as ``run_scenario``) and
    serves two arrival sources merged tick by tick:

    * a seeded **scenario arrival process** (``scenario=``, any
      :class:`~.scenarios.ScenarioSpec` from the generators) whose
      arrivals are submitted when their tick comes up, and
    * an **injectable queue** (:meth:`inject`, thread-safe) drained at
      the top of every tick — the asynchronous path a live frontend
      would use.

    Lifecycle: :meth:`run` ticks until the daemon is *draining* (see
    :meth:`drain`) and empty, until ``max_requests`` have completed
    (auto-drain), or until :meth:`shutdown` (hard stop).  Every request
    is accounted — :meth:`accounting` proves
    ``ingested == completed + shed + in_flight`` and reports arrivals
    never submitted (``dropped``) after a hard stop.  Idle ticks (no
    submission, no prefill, no decode) wait ``idle_wait`` seconds on
    the configured clock — a ``faults.VirtualClock`` in tests, the
    shared ``SystemClock`` live — never a bare ``time.sleep``.

    In scenario mode with no injected arrivals the daemon's tick loop
    is tick-for-tick the ``run_scenario`` driver, so :meth:`trace`
    (or the streamed :class:`TraceWriter` equivalent) is a standard
    replayable trace record.  The model runs on ``device`` (default:
    the card).
    """

    def __init__(self, cfg, params, planner,
                 scenario: ScenarioSpec | None = None,
                 policy: str = "per-step", fence: bool = True,
                 max_seq: int | None = None,
                 policy_kw: dict | None = None,
                 disagg: "DisaggConfig | None" = None,
                 slo: dict[int, str] | None = None,
                 spec_decode=None,
                 autoscale: AutoscaleConfig | None = None,
                 prefill_scope: "lane_engine.BackendScope | None" = None,
                 decode_scope: "lane_engine.BackendScope | None" = None,
                 max_requests: int | None = None,
                 writer: TraceWriter | None = None,
                 clock=None, idle_wait: float = 0.0,
                 on_tick=None, device=None):
        from .cells import DisaggServingEngine
        from .policy import OffloadController

        self.cfg, self.params, self.planner = cfg, params, planner
        self.scenario = scenario
        self.fence = fence
        self.controller = OffloadController(planner, policy=policy,
                                            fence=fence,
                                            **(policy_kw or {}))
        self.disagg = disagg or DisaggConfig.mirror()
        self.slo = dict(slo or {})
        self.spec_decode = spec_decode
        self.max_requests = max_requests
        self.writer = writer
        self.clock = clock if clock is not None else faults.SYSTEM_CLOCK
        self.idle_wait = float(idle_wait)
        self.on_tick = on_tick

        arrivals = list(scenario.arrivals) if scenario is not None else []
        if max_seq is None:
            max_seq = max((a.prompt_len + a.max_new for a in arrivals),
                          default=16)
            max_seq = max(64, 2 * max_seq)
        self.max_seq = max_seq
        slots = scenario.slots if scenario is not None else 4
        self.eng = DisaggServingEngine(
            cfg, params, slots=slots, max_seq=max_seq,
            disagg=self.disagg, controller=self.controller,
            spec_decode=spec_decode,
            prefill_scope=prefill_scope, decode_scope=decode_scope,
            device=device)
        self.scaler = (AutoscaleController(autoscale, self.eng)
                       if autoscale is not None else None)
        if spec_decode is not None:
            planner.plan_draft(fence=fence)

        # Seeded scenario arrivals: same request materialization as the
        # scenario driver (token values from seed+1), so a pure-scenario
        # daemon run emits the driver's exact trace.
        self._pending = sorted(arrivals, key=lambda a: (a.step, a.rid))
        self._rng = np.random.default_rng(
            (scenario.seed if scenario is not None else 0) + 1)
        self._reqs = {a.rid: Request(
            rid=a.rid,
            prompt=self._rng.integers(0, cfg.vocab, size=a.prompt_len),
            max_new=a.max_new) for a in self._pending}
        self._next_arrival = 0
        self._next_rid = max((a.rid for a in arrivals), default=-1) + 1

        # The injectable asynchronous arrival queue.
        self._inbox: list[tuple[Request, str]] = []
        self._inbox_lock = threading.Lock()

        self._draining = False
        self._stopped = False
        self.idle_ticks = 0
        self.dropped: dict[int, int] = {}       # rid -> drop tick
        self.ingested = 0
        self._per_tick: list[int] | None = ([] if writer is None else None)
        if writer is not None and scenario is not None:
            writer.write_meta(scenario=scenario.to_record(),
                              policy=self.controller.policy.name,
                              fence=fence)

    # -- arrival sources -----------------------------------------------
    def inject(self, prompt_len: int, max_new: int,
               slo: str = SLO_LATENCY, rid: int | None = None) -> int:
        """Queue one asynchronous arrival (thread-safe); returns its
        rid.  Rejected (ValueError) once the daemon is draining — a
        draining daemon serves out, it does not ingest."""
        if self._draining or self._stopped:
            raise ValueError("daemon is draining/stopped; "
                             "not accepting arrivals")
        with self._inbox_lock:
            if rid is None:
                rid = self._next_rid
                self._next_rid += 1
            req = Request(rid=rid,
                          prompt=self._rng.integers(0, self.cfg.vocab,
                                                    size=prompt_len),
                          max_new=max_new)
            self._inbox.append((req, slo))
        return rid

    # -- lifecycle ------------------------------------------------------
    def drain(self) -> None:
        """Stop ingesting (scenario arrivals not yet due are dropped,
        injections rejected) and serve out everything queued."""
        self._draining = True

    def shutdown(self) -> None:
        """Hard stop: no more ticks.  Whatever was queued stays queued
        — :meth:`accounting` itemizes it, nothing goes missing."""
        self._draining = True
        self._stopped = True

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def stopped(self) -> bool:
        return self._stopped

    def _drained(self) -> bool:
        return (not any(self.eng.active) and not self.eng.waiting
                and not self._inbox
                and self._next_arrival >= len(self._pending))

    def step(self) -> int:
        """One daemon tick: fire hooks, ingest due arrivals (scenario +
        injected), tick the cell pair, autoscale, record the trace
        tick.  Returns the decode batch size."""
        t = self.eng.ticks
        if self.on_tick is not None:
            self.on_tick(t, self.eng)
        if self.spec_decode is not None:
            self.planner.touch_draft(fence=self.fence)
        if self._draining:
            # Drop (account, don't serve) scenario arrivals not yet due.
            while self._next_arrival < len(self._pending):
                a = self._pending[self._next_arrival]
                self.dropped[a.rid] = t
                self._next_arrival += 1
        submitted = 0
        while (self._next_arrival < len(self._pending)
               and self._pending[self._next_arrival].step <= t):
            a = self._pending[self._next_arrival]
            self.eng.submit(self._reqs[a.rid],
                            slo=self.slo.get(a.rid, SLO_LATENCY))
            self.ingested += 1
            self._next_arrival += 1
            submitted += 1
        with self._inbox_lock:
            inbox, self._inbox = self._inbox, []
        for req, slo in inbox:
            self.slo[req.rid] = slo
            self.eng.submit(req, slo=slo)
            self.ingested += 1
            submitted += 1
        prefilled = len(self.eng.prefill_cell.prefill_ticks)
        stepped = self.eng.step()
        prefilled = (len(self.eng.prefill_cell.prefill_ticks)
                     - prefilled)
        batch = self.eng.step_batches[-1] if stepped else 0
        if self.scaler is not None:
            self.scaler.observe(t)
        if self.writer is not None:
            self.writer.write_tick(t, batch)
        elif self._per_tick is not None:
            self._per_tick.append(batch)
        if submitted == 0 and prefilled == 0 and batch == 0:
            self.idle_ticks += 1
            if self.idle_wait > 0:
                self.clock.sleep(self.idle_wait)
        return batch

    def run(self, max_ticks: int = 1_000_000) -> dict:
        """Tick until drained (after :meth:`drain` or request/scenario
        exhaustion), ``max_requests`` completions (auto-drain), or
        :meth:`shutdown`.  A drain that fails to empty the cells within
        ``max_ticks`` raises :class:`ScenarioDrainError` with the queues'
        state.  Returns :meth:`report`."""
        ticks = 0
        while not self._stopped:
            if self._drained():
                if self._draining or self.scenario is not None:
                    # A pure-scenario daemon completes like the driver;
                    # an injectable daemon only exits via drain().
                    break
            self.step()
            if (self.max_requests is not None
                    and len(self.eng.completions) >= self.max_requests):
                self.drain()
            ticks += 1
            if ticks > max_ticks:
                eng = self.eng
                queued = eng.queued_rids()
                raise ScenarioDrainError(
                    self.scenario.name if self.scenario else "daemon",
                    max_ticks,
                    queues=dict(waiting=len(eng.prefill_cell.queue),
                                handoff=len(eng.handoff),
                                pending=(len(self._pending)
                                         - self._next_arrival)),
                    oldest_age=(eng.ticks - min(
                        enq for enq, _ in
                        eng.prefill_cell.queue.wait_entries())
                        if len(eng.prefill_cell.queue) else None),
                    last_batch=[r.rid for r in eng.active
                                if r is not None])
        if self.writer is not None:
            self.writer.write_summary(self._summary_fields())
            self.writer.close()
        return self.report()

    # -- reporting ------------------------------------------------------
    def accounting(self) -> dict:
        """Request conservation: every arrival the daemon ever saw is
        exactly one of completed / shed / in flight / dropped.  The
        hard-shutdown battery asserts the invariant."""
        eng = self.eng
        in_flight = (len(eng.prefill_cell.queue) + len(eng.handoff)
                     + sum(r is not None for r in eng.active))
        out = dict(ingested=self.ingested,
                   completed=len(eng.completions),
                   shed=len(eng.shed),
                   in_flight=in_flight,
                   dropped=len(self.dropped),
                   queued_inbox=len(self._inbox))
        assert (out["ingested"]
                == out["completed"] + out["shed"] + out["in_flight"]), \
            f"request conservation violated: {out}"
        return out

    def _summary_fields(self) -> dict:
        stats = self.eng.summary()
        fields = dict(
            occupancy={str(k): v for k, v in
                       sorted(stats["batch_occupancy"].items())},
            steps=stats["steps"], tokens=stats["tokens"],
            prefills=stats["prefills"],
            controller=self.controller.report(),
            per_step=[r.to_record() for r in self.controller.trace],
            disagg=stats["disagg"],
        )
        if self.scaler is not None:
            fields["autoscale"] = self.scaler.report()
        if self.spec_decode is not None:
            fields["spec_decode"] = dict(
                config=self.spec_decode.to_record(),
                **self.eng.spec_report())
        return fields

    def trace(self) -> dict:
        """The in-memory trace record (scenario mode, no writer) — the
        same shape ``run_scenario`` emits, so it pins, diffs and
        replays like any recorded trace."""
        if self.scenario is None:
            raise ValueError("trace() needs a scenario-mode daemon")
        if self._per_tick is None:
            raise ValueError("trace() unavailable when streaming to a "
                             "TraceWriter — use TraceWriter.load()")
        return dict(scenario=self.scenario.to_record(),
                    policy=self.controller.policy.name,
                    fence=self.fence,
                    per_tick_batch=list(self._per_tick),
                    **self._summary_fields())

    def report(self) -> dict:
        """Operational snapshot: lifecycle state, accounting, queue and
        autoscale telemetry, per-cell scope records when scoped."""
        eng = self.eng
        out = dict(draining=self._draining, stopped=self._stopped,
                   ticks=eng.ticks, idle_ticks=self.idle_ticks,
                   accounting=self.accounting(),
                   handoff_wait=eng.handoff.wait_report(),
                   slo_wait=eng.wait_telemetry())
        if self.scaler is not None:
            out["autoscale"] = self.scaler.report()
        scopes = eng.scopes_report()
        if scopes is not None:
            out["scopes"] = scopes
        return out

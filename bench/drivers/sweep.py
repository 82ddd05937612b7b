"""Design-point sweeps: a closed loop of one client whose every query
prices a model's decode GEMV sites, on PIM and on the host, over specs
the run has not seen, so every lane misses the engine's LRU and runs
through planning, packing, the lane-scan kernel and read-back.

Query: a fresh ``OffloadPlanner(cfg, PimSimulator(device))`` and one
``plan_grid(specs)``.  Points: specs x sites x {PIM, host baseline}.
The window issues queries until ``--seconds`` have passed and ends with
the last one.  Afterwards every spec of the last query, and one spec of
the first drawn from the seed, are held point by point to the plain
reference: the command streams planning produced, every lane's total,
each point's ns and energy, and each spec's offload decisions.
"""
from __future__ import annotations

import time

import torch

from bench import generator, judge, peaks, program, tracing


class Capture:
    """Keeps, for the watched specs of the running query, what the
    program planned (streams) and returned (results), by (spec index,
    kind, site)."""

    def __init__(self, sites):
        self.names: dict = {}               # (H, W) -> site names
        for s in sites:
            self.names.setdefault((s.h, s.w), []).append(s.name)
        self.watch: list = []
        self.streams: dict = {}
        self.results: dict = {}

    def _index(self, spec):
        for i, w in enumerate(self.watch):
            if w is not None and spec == w:
                return i
        return None

    def planned(self, planned):
        for p in planned:
            i = self._index(p.req.spec)
            if i is not None:
                for name in self.names[(p.req.H, p.req.W)]:
                    self.streams[(i, p.req.kind, name)] = list(p.streams)

    def resolved(self, reqs, results):
        for r, res in zip(reqs, results):
            i = self._index(r.spec)
            if i is not None:
                for name in self.names[(r.H, r.W)]:
                    self.results[(i, r.kind, name)] = res

    def take(self) -> tuple[dict, dict]:
        out = (self.streams, self.results)
        self.streams, self.results = {}, {}
        return out


def _of_spec(i: int, found: dict) -> dict:
    """One spec's entries of a capture, keyed by (kind, site)."""
    return {k[1:]: v for k, v in found.items() if k[0] == i}


def run(r) -> None:
    from repro_torch.core import engine
    from repro_torch.core.pimsim import PimSimulator
    from repro_torch.kernels import lane_scan
    from repro_torch.pimkernel.executor import PimExecutor
    from repro_torch.pimkernel.tileconfig import PimDType
    from repro_torch.serving.offload import OffloadPlanner, decode_gemv_sites

    mix, dev = r.mix, r.device
    cfg = program.arch(r.config)
    sites = decode_gemv_sites(cfg)
    fence = mix["fence"]
    dtype = PimDType.parse(mix["dtype"])
    n_warm, n_max = mix["warm_queries"], mix["max_queries"]
    drawn = generator.sweep_queries(
        mix, generator.spec_space(r.root, mix), r.seed, n_warm + n_max)
    warm = [[program.spec(d) for d in q] for q in drawn[:n_warm]]
    plain = drawn[n_warm:]
    queries = [[program.spec(d) for d in q] for q in plain]
    per_query = len(queries[0])
    pick = int(generator.rng_for(r.seed, 9).integers(per_query))

    program.build(r)
    for q in warm:                       # the cell's shapes, other specs
        OffloadPlanner(cfg, sim=PimSimulator(device=dev),
                       dtype=dtype).plan_grid(q, fence=fence)
    program.sync(dev)

    cap = Capture(sites)
    spans = tracing.Spans(r.trace, clock=True)
    launches: list = []
    pending: list = []
    real_plan = PimExecutor.plan_many
    real_run = PimExecutor.run_many
    real_resolve = engine.resolve_lanes
    real_pack = engine.pack_lanes
    real_scan = lane_scan.lane_scan

    def plan_many(self, reqs):
        with spans.span("plan_many"):
            out = real_plan(self, reqs)
        cap.planned(out)
        return out

    def run_many(self, reqs):
        reqs = [q.resolved(self.default_spec) for q in reqs]
        out = real_run(self, reqs)
        cap.resolved(reqs, out)
        return out

    def pack_lanes(lanes):
        pending.append([s.shape[0] for _c, s in lanes])
        return real_pack(lanes)

    def scan(cycs, streams, lengths, num_banks, need_issue=True):
        lens = pending.pop() if pending else []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_scan(cycs, streams, lengths, num_banks,
                        need_issue=need_issue)
        end.record()
        launches.append((start, end, lens, need_issue))
        return out

    patches = [tracing.patch(PimExecutor, "plan_many", plan_many),
               tracing.patch(PimExecutor, "run_many", run_many),
               tracing.patch(engine, "resolve_lanes",
                             spans.wrap(real_resolve, "resolve_lanes"))]
    if r.trace:
        patches.append(tracing.patch(engine, "pack_lanes", pack_lanes))
        if dev.type == "cuda":
            patches.append(tracing.patch(lane_scan, "lane_scan", scan))
    first = last = None
    for p in patches:
        p.__enter__()
    try:
        r.window_opens()
        lat, done = [], 0
        t0 = time.perf_counter()
        while done < n_max and (done == 0
                                or time.perf_counter() - t0 < r.seconds):
            q = queries[done]
            # every spec of the query is watched; what the query before
            # kept is let go first, unless it is the first query's pick
            cap.watch, last = list(q), None

            def query():
                planner = OffloadPlanner(cfg, sim=PimSimulator(device=dev),
                                         dtype=dtype)
                with spans.span("query"):
                    return planner.plan_grid(q, fence=fence)

            t = time.perf_counter()
            if r.trace and done == 0 and dev.type == "cuda":
                box = []
                r.profile = tracing.profile(lambda: box.append(query()))
                decisions = box[0]
            else:
                decisions = query()
            lat.append(time.perf_counter() - t)
            streams, results = cap.take()
            last = (decisions, results, streams)
            if done == 0:
                first = (decisions[pick], _of_spec(pick, results),
                         _of_spec(pick, streams))
            done += 1
        program.sync(dev)
        window_s = time.perf_counter() - t0
    finally:
        for p in reversed(patches):
            p.__exit__(None, None, None)

    r.memory_peak = program.memory_peak(dev)
    r.attempted, r.failed = done, 0
    n_points = per_query * len(sites) * 2
    r.obs.update(queries=done, points=done * n_points, window_s=window_s,
                 query_s=lat,
                 plan_many_s=spans.seconds.get("plan_many", 0.0),
                 resolve_s=spans.seconds.get("resolve_lanes", 0.0))
    if r.trace:
        kernel_s = sum(s.elapsed_time(e) for s, e, _l, _i in launches) / 1e3
        r.obs.update(
            kernel_s=kernel_s, launches=len(launches),
            longest_commands=sum(max(lens, default=0)
                                 for _s, _e, lens, _i in launches),
            lane_bytes=sum(peaks.lane_scan_bytes(lens, need)
                           for _s, _e, lens, need in launches))
        if r.profile is not None:
            r.obs.update(busy_s=r.profile["busy_s"],
                         profiled_s=r.profile["window_s"])

    # -- correctness: every spec of the last query, the first's pick ------
    judged = [(plain[done - 1][k], last[0][k], _of_spec(k, last[1]),
               _of_spec(k, last[2])) for k in range(per_query)]
    if done > 1:
        judged.append((plain[0][pick],) + first)
    totals = dict(streams=0, lanes=0, points=0, decisions=0, gap=0.0,
                  compared=0)
    for spec_dict, decisions, results, streams in judged:
        got = judge.spec_points(r.config, spec_dict, decisions, results,
                                streams, mix["dtype"], fence)
        for k in totals:
            totals[k] = max(totals[k], got[k]) if k == "gap" \
                else totals[k] + got[k]
    r.obs["points_compared"] = totals["compared"]
    r.check("streams_differing", totals["streams"], 0)
    r.check("lane_totals_differing", totals["lanes"], 0)
    r.check("points_differing", totals["points"], 0)
    r.check("decisions_differing", totals["decisions"], 0)
    r.check("ns_energy_rel_gap", totals["gap"], 0.0)

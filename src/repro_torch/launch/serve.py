"""Serving launcher: continuous-batching decode + PIM offload telemetry.

LP5X-PIM accelerates decode GEMVs, so this is the primary end-to-end
entry point: it serves a model with batched requests and reports, per
decode step, what the LP5X-PIM offload would deliver on the reference
LPDDR5X-9600 x 4ch memory system.  The model runs on ``--device``
(default: the card); the offload plan is made for the FULL architecture
whatever model is served (``--smoke``, always on, serves the reduced
same-family config).

With ``--scenario`` the launcher becomes the closed-loop policy testbed:
a seeded workload (steady / bursty / diurnal / prefill-heavy /
drain-refill / chaos / spec-decode) drives the engine end to end under
an adaptive offload controller (``--policy per-step|hysteresis|sticky``)
and the run reports realized vs oracle speedup, decision switches and
planner queries.

``--disagg`` serves through the disaggregated prefill/decode cell pair
(``serving/cells.py``) instead of the monolithic engine, optionally
bounded (``--prefill-budget`` / ``--handoff-bound`` /
``--admission-capacity``) and SLO-mixed (``--slo FRAC``: the latency
class's share, the rest throughput class aged by ``--starvation-age``),
and reports the handoff queue and the per-class waits.

``--daemon`` serves the scenario through the long-running
``ServeDaemon`` (``serving/daemon.py``, always the cell pair): drain
accounting, optional SLO-driven decode autoscaling (``--autoscale``,
floor ``--min-slots``), a completion cap (``--max-requests``) and a
streamed trace (``--trace-out FILE``: tick-ordered JSON lines written in
bounded memory; ``TraceWriter.load`` reassembles the trace).

``--chaos`` runs the scenario under a seeded fault timeline
(``serving/chaos.py``, seed ``--faults``): injected backend faults,
lane-cache poison and eviction storms, planner timeouts and handoff
pressure, absorbed by the degradation ladder; the run must end with no
unhandled exception, and the report holds the incident record.  With
``--daemon`` the timeline fires from the daemon's tick hook (the JAX
package's launcher refuses the pair).

``--cache-dir`` (or ``REPRO_CACHE_DIR``) keeps the kernel build and the
resolved-lane LRU across processes (``core/warmstart.py``); the
``serve/time_to_first_batch`` and ``serve/lane_cache`` rows show what a
warm start saved.  ``--lane-backend`` accepts the JAX package's names;
all resolve to the one lane resolver here.  ``--mesh N`` resolves the
planner's lanes on a lane mesh of N shards of ``--device`` (each shard
its own launch and CUDA stream); the results, and so the report, do not
change.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import engine as lane_engine
from repro_torch.core import faults, trace, warmstart
from repro_torch.core.engine import resolve_device
from repro_torch.core.pimsim import PimSimulator
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import OffloadPlanner
from repro_torch.serving.policy import POLICIES, resolve_policy
from repro_torch.serving.scenarios import (SCENARIOS, SLO_LATENCY,
                                           SLO_THROUGHPUT, AutoscaleConfig,
                                           DisaggConfig, SpecDecodeConfig,
                                           assign_slo, make_scenario,
                                           resolve_scenario, run_scenario)


def _disagg_config(args) -> "DisaggConfig | bool":
    """The cell-pair config from the CLI knobs (False when not asked)."""
    if not args.disagg:
        if args.slo is not None:
            raise SystemExit("--slo requires --disagg (SLO classes are "
                             "a property of the cell pair's admission)")
        return False
    return DisaggConfig(prefill_budget=args.prefill_budget,
                        handoff_bound=args.handoff_bound,
                        starvation_age=args.starvation_age,
                        admission_capacity=args.admission_capacity)


def _print_disagg_report(rec: dict) -> None:
    hand = rec["handoff"]
    bound = hand["bound"] if hand["bound"] is not None else "unbounded"
    print(f"  KV handoff queue     : {hand['handoffs']} handoffs, peak "
          f"depth {hand['max_depth']} (bound {bound})")
    for cls, per in rec["per_class"].items():
        print(f"  SLO {cls:<11}      : {per['completed']}/"
              f"{per['submitted']} done, mean admit wait "
              f"{per['mean_admit_wait']:.2f} ticks, mean latency "
              f"{per['mean_completion_ticks']:.2f} ticks")


def _scenario_setup(args):
    """The scenario, its SLO classes and its speculative config."""
    spec = make_scenario(args.scenario, seed=args.seed, slots=args.slots,
                         quick=args.quick)
    slo = (assign_slo(spec, frac_latency=args.slo)
           if args.slo is not None else None)
    spec_decode = (SpecDecodeConfig(draft_len=args.draft_len,
                                    acceptance=args.acceptance,
                                    seed=args.seed)
                   if args.scenario == "spec-decode" else None)
    return spec, slo, spec_decode


def run_scenario_mode(args, full_cfg, cfg, params, device,
                      t_start: float | None = None) -> None:
    planner = OffloadPlanner(full_cfg, PimSimulator(device=device))
    # Time-to-first-batch: main() entry through the first offload plan —
    # the window that holds every cold-start cost (kernel build, lane
    # resolves).
    planner.plan(fence=args.fence)
    if t_start is not None:
        ttfb = time.perf_counter() - t_start
        print(f"serve/time_to_first_batch,{ttfb:.3f}", flush=True)
    spec, slo, spec_decode = _scenario_setup(args)
    disagg = _disagg_config(args)
    t0 = time.perf_counter()
    if args.chaos:
        from repro_torch.serving.chaos import run_chaos_scenario
        trace = run_chaos_scenario(cfg, params, planner, scenario=spec,
                                   seed=args.faults, policy=args.policy,
                                   fence=args.fence, disagg=disagg,
                                   slo=slo, spec_decode=spec_decode,
                                   device=device)
    else:
        trace = run_scenario(spec, cfg, params, planner, policy=args.policy,
                             fence=args.fence, disagg=disagg, slo=slo,
                             spec_decode=spec_decode, device=device)
    dt = time.perf_counter() - t0
    rep = trace["controller"]
    mode = "disagg cells" if disagg else "monolithic engine"
    print(f"scenario {args.scenario} (seed={args.seed}, "
          f"{len(spec.arrivals)} requests, {args.slots} slots, {mode}) "
          f"under policy {args.policy}: {trace['tokens']} tokens in "
          f"{trace['steps']} steps ({dt:.2f}s host wall)")
    occ = ", ".join(f"{b}:{c}" for b, c in trace["occupancy"].items())
    print(f"  batch occupancy      : {occ}")
    print(f"  realized speedup     : {rep['realized_speedup']:.3f}x "
          f"(oracle {rep['oracle_speedup']:.3f}x, "
          f"efficiency {rep['efficiency']:.3f})")
    print(f"  decision switches    : {rep['switches']}; planner queries "
          f"{rep['planner_queries']}/{rep['steps']} steps; "
          f"replans {rep['replans']}")
    if disagg:
        _print_disagg_report(trace["disagg"])
    if "spec_decode" in trace:
        _print_spec_decode_report(trace["spec_decode"], planner, args)
    if args.chaos:
        _print_chaos_report(trace["chaos"])


def _print_spec_decode_report(rec: dict, planner, args) -> None:
    """Draft/verify accounting + a parseable ``serve/spec_decode`` row."""
    drafted = rec["drafted"]
    rate = rec["accepted"] / drafted if drafted else 0.0
    model = planner.spec_decode_speedup(draft_len=args.draft_len,
                                        acceptance=args.acceptance,
                                        fence=args.fence)
    print(f"  speculative decode   : {rec['rounds']} rounds, "
          f"{rec['accepted']}/{drafted} drafts accepted "
          f"({rate:.2f}), {rec['wasted']} wasted, "
          f"{rec['substeps']} verify sub-steps")
    print(f"  draft-lane model     : {model['speedup']:.3f}x per-token vs "
          f"vanilla decode ({model['tokens_per_round']:.2f} tok/round)")
    print(f"serve/spec_decode,rounds={rec['rounds']},"
          f"drafted={drafted},accepted={rec['accepted']},"
          f"wasted={rec['wasted']},substeps={rec['substeps']}", flush=True)


def _print_chaos_report(rec: dict) -> None:
    """Human summary + a parseable ``serve/chaos`` row (reaching this
    line at all means no unhandled exception)."""
    by_kind: dict[str, int] = {}
    for ev in rec["events"]:
        by_kind[ev["kind"]] = by_kind.get(ev["kind"], 0) + 1
    kinds = ", ".join(f"{k}:{n}" for k, n in sorted(by_kind.items()))
    tripped = ",".join(rec["breaker"]["open"]) or "none"
    print(f"  chaos (faults seed {rec['seed']}): {rec['injected']} "
          f"injected over {len(rec['timeline'])} timeline actions")
    print(f"  incident events      : {kinds or 'none'}")
    print(f"  breaker              : threshold "
          f"{rec['breaker']['threshold']}, tripped {tripped}")
    print(f"serve/chaos,injected={rec['injected']},"
          f"events={len(rec['events'])},"
          f"degrades={by_kind.get('degrade', 0)},"
          f"trips={by_kind.get('trip', 0)},"
          f"sheds={by_kind.get('shed', 0)},unhandled=0", flush=True)


def run_daemon_mode(args, full_cfg, cfg, params, device) -> None:
    """Serve the scenario through ``ServeDaemon`` (with ``--chaos``,
    under its fault timeline) and print the operational report: a
    parseable ``serve/daemon`` row, ``unhandled=0`` on a clean run."""
    from repro_torch.serving import chaos
    from repro_torch.serving.daemon import ServeDaemon, TraceWriter

    planner = OffloadPlanner(full_cfg, PimSimulator(device=device))
    planner.plan(fence=args.fence)
    spec, slo, _spec_decode = _scenario_setup(args)
    dcfg = _disagg_config(args)
    auto = (AutoscaleConfig(min_slots=args.min_slots)
            if args.autoscale else None)
    writer = (TraceWriter(args.trace_out)
              if args.trace_out is not None else None)
    on_tick = None
    if args.chaos:
        timeline = chaos.default_timeline(spec, args.faults)
        inj, clock, on_tick = chaos.chaos_hooks(timeline)
    t0 = time.perf_counter()
    daemon = ServeDaemon(
        cfg, params, planner, scenario=spec, policy=args.policy,
        fence=args.fence,
        disagg=(dcfg if isinstance(dcfg, DisaggConfig) else None),
        slo=slo, autoscale=auto, max_requests=args.max_requests,
        writer=writer, on_tick=on_tick, device=device)
    if not args.chaos:
        rep = daemon.run()
    else:
        try:
            with faults.fault_scope(inj), \
                    faults.retry_scope(retries=1, clock=clock):
                rep = daemon.run()
        finally:
            faults.set_tick(None)
    dt = time.perf_counter() - t0
    acct = rep["accounting"]
    print(f"daemon scenario {args.scenario} (seed={args.seed}, "
          f"{len(spec.arrivals)} requests, {args.slots} slots): "
          f"{acct['completed']} completed / {acct['shed']} shed / "
          f"{acct['dropped']} dropped in {rep['ticks']} ticks "
          f"({dt:.2f}s host wall)")
    if auto is not None:
        asr = rep["autoscale"]
        lims = asr["limits"] or [0]
        print(f"  autoscale            : limit {min(lims)}..{max(lims)} "
              f"over {len(lims)} ticks ({asr['grows']} grows, "
              f"{asr['shrinks']} shrinks, "
              f"{asr['slot_ticks']} slot-ticks provisioned)")
    if writer is not None:
        print(f"  streamed trace       : {writer.records} records in "
              f"{writer.flushes} chunks -> {args.trace_out}")
    if args.chaos:
        _print_chaos_report(chaos.incident_record(
            args.faults, timeline, inj, clock, breaker_threshold=3,
            retries=1))
    print(f"serve/daemon,ingested={acct['ingested']},"
          f"completed={acct['completed']},shed={acct['shed']},"
          f"dropped={acct['dropped']},in_flight={acct['in_flight']},"
          f"ticks={rep['ticks']},unhandled=0", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--fence", action="store_true", default=True)
    ap.add_argument("--scenario", default=None,
                    help="drive a seeded workload scenario end to end "
                         "under an adaptive offload controller "
                         f"(one of {sorted(SCENARIOS)}; underscores ok)")
    ap.add_argument("--policy", default="per-step",
                    help="offload control policy for --scenario runs "
                         f"(one of {sorted(POLICIES)}; underscores ok)")
    ap.add_argument("--draft-len", type=int, default=4, metavar="L",
                    help="with --scenario spec-decode: speculative draft "
                         "length per round")
    ap.add_argument("--acceptance", type=float, default=0.7, metavar="P",
                    help="with --scenario spec-decode: per-token draft "
                         "acceptance probability (seeded model)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="smaller scenario (CI smoke)")
    ap.add_argument("--disagg", action="store_true",
                    help="serve through the disaggregated prefill/decode "
                         "cell pair (serving/cells.py) instead of the "
                         "monolithic engine")
    ap.add_argument("--slo", type=float, default=None, metavar="FRAC",
                    help="with --disagg: fraction of requests in the "
                         "latency SLO class (rest are throughput class)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    metavar="N", help="with --disagg: max prefills per "
                    "tick (default unbounded)")
    ap.add_argument("--handoff-bound", type=int, default=None,
                    metavar="N", help="with --disagg: KV-handoff queue "
                    "bound (default unbounded)")
    ap.add_argument("--starvation-age", type=int, default=8, metavar="N",
                    help="with --disagg: ticks after which a waiting "
                    "throughput-class request outranks latency traffic")
    ap.add_argument("--admission-capacity", type=int, default=None,
                    metavar="N", help="with --disagg: admission-queue "
                    "capacity; arrivals over it shed the lowest SLO "
                    "class first (default unbounded, never sheds)")
    ap.add_argument("--daemon", action="store_true",
                    help="serve --scenario through the long-running "
                         "ServeDaemon (serving/daemon.py): drain "
                         "accounting, autoscaling and streamed traces; "
                         "implies --disagg")
    ap.add_argument("--max-requests", type=int, default=None, metavar="N",
                    help="with --daemon: auto-drain after N completed "
                         "requests (default: serve the whole scenario)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="with --daemon: stream the trace to FILE as "
                         "tick-ordered JSON lines (bounded memory) "
                         "instead of holding it in RAM")
    ap.add_argument("--autoscale", action="store_true",
                    help="with --daemon: grow/shrink the decode cell's "
                         "admission limit against per-class SLO wait "
                         "ages (the AutoscaleConfig rule)")
    ap.add_argument("--min-slots", type=int, default=1, metavar="N",
                    help="with --autoscale: the admission-limit floor "
                         "(ceiling is the scenario's slot capacity)")
    ap.add_argument("--chaos", action="store_true",
                    help="run the scenario under a seeded fault "
                         "timeline (serving/chaos.py); implies "
                         "--scenario chaos unless one is given")
    ap.add_argument("--faults", type=int, default=0, metavar="SEED",
                    help="with --chaos: fault-timeline seed (same seed, "
                         "same faults at the same ticks)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent warm-start directory (kernel build + "
                         "resolved-lane snapshot); also via "
                         "REPRO_CACHE_DIR")
    ap.add_argument("--lane-backend", default=None,
                    choices=["scan", "pallas", "auto"],
                    help="lane resolver backend (default: "
                         "REPRO_LANE_BACKEND or scan); every name runs "
                         "the one lane resolver here")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="resolve the PIM lanes on a lane mesh of N "
                         "shards of --device (default: no mesh)")
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the lane resolver "
                         "(default: the current CUDA device)")
    args = ap.parse_args(argv)
    if args.chaos and not args.scenario:
        args.scenario = "chaos"
    if args.daemon:
        if not args.scenario:
            ap.error("--daemon needs --scenario (the arrival process)")
        args.disagg = True          # the daemon IS the cell pair
    for flag, name in ((args.max_requests, "--max-requests"),
                       (args.trace_out, "--trace-out")):
        if flag is not None and not args.daemon:
            ap.error(f"{name} requires --daemon")
    if args.autoscale and not args.daemon:
        ap.error("--autoscale requires --daemon")
    if args.mesh is not None and args.mesh < 1:
        ap.error("--mesh takes a shard count >= 1")
    try:
        if args.scenario:
            args.scenario = resolve_scenario(args.scenario)
        args.policy = resolve_policy(args.policy)
    except ValueError as e:
        ap.error(str(e))

    t_start = time.perf_counter()
    device = resolve_device(args.device)
    lane_engine.configure_lane_backend(args.lane_backend)
    warm = warmstart.enable_warm_start(args.cache_dir)
    if warm["cache_dir"]:
        print(f"warm start: cache-dir {warm['cache_dir']} "
              f"(compile cache {'on' if warm['compile_cache'] else 'off'}, "
              f"{warm['lanes']} lanes loaded)", flush=True)

    full_cfg = ARCHS[args.arch]
    cfg = smoke_config(full_cfg) if args.smoke else full_cfg
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} serves stub embeddings; the engine "
                         "serves token models")
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)

    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import make_lane_mesh
        mesh = make_lane_mesh(args.mesh, [device] * args.mesh)
        print(f"lane mesh: {args.mesh} shard(s) of {device}", flush=True)
    with lane_engine.lane_mesh_scope(mesh):
        _serve(args, full_cfg, cfg, params, device, t_start)


def _serve(args, full_cfg, cfg, params, device, t_start) -> None:
    """The launcher's modes, under the lane mesh ``main`` set up."""
    if args.daemon:
        run_daemon_mode(args, full_cfg, cfg, params, device)
        _warm_epilogue(args)
        return

    if args.scenario:
        run_scenario_mode(args, full_cfg, cfg, params, device,
                          t_start=t_start)
        _warm_epilogue(args)
        return

    # Offload plan computed against the FULL architecture (the simulator
    # works on real matrix sizes regardless of the smoke model served).
    planner = OffloadPlanner(full_cfg, PimSimulator(device=device))
    disagg = _disagg_config(args)
    if disagg:
        from repro_torch.serving.cells import DisaggServingEngine
        eng = DisaggServingEngine(cfg, params, slots=args.slots,
                                  max_seq=128, disagg=disagg,
                                  planner=planner, device=device)
    else:
        eng = ServingEngine(cfg, params, slots=args.slots, max_seq=128,
                            planner=planner, device=device)
    rng = np.random.default_rng(0)
    frac = 1.0 if args.slo is None else args.slo
    for i in range(args.requests):
        req = Request(rid=i,
                      prompt=rng.integers(0, cfg.vocab, size=4 + i % 8),
                      max_new=args.max_new)
        if disagg:
            eng.submit(req, slo=(SLO_LATENCY if rng.random() < frac
                                 else SLO_THROUGHPUT))
        else:
            eng.submit(req)
    t0 = time.perf_counter()
    stats = eng.run(max_steps=2000)
    dt = time.perf_counter() - t0
    mode = "disagg cells" if disagg else "monolithic engine"
    print(f"served {args.requests} requests ({mode}): {stats['tokens']} "
          f"tokens in {stats['steps']} steps ({dt:.2f}s host wall)")
    if disagg:
        _print_disagg_report(stats["disagg"])
    tel = stats["pim_telemetry"]
    print(f"PIM offload telemetry (arch={full_cfg.name}, "
          f"batch={tel['batch']}):")
    print(f"  decode GEMV time host-only : {tel['host_ns']/1e3:10.1f} us")
    print(f"  with LP5X-PIM offload      : {tel['mixed_ns']/1e3:10.1f} us")
    print(f"  speedup {tel['speedup']:.2f}x; offloaded "
          f"{len(tel['offloaded'])}/{tel['n_sites']} GEMV sites")
    _warm_epilogue(args)


def _warm_epilogue(args) -> None:
    """Parseable lane-cache counters and program spans, then the
    snapshot save (no-op without a cache dir)."""
    info = lane_engine.lane_cache_info()
    print(f"serve/lane_cache,hits={info['hits']},misses={info['misses']},"
          f"size={info['size']}", flush=True)
    print(spans_row(trace.totals()), flush=True)
    saved = warmstart.save_warm_start(args.cache_dir)
    if saved >= 0:
        print(f"warm start: saved {saved} lanes", flush=True)


def spans_row(totals: "trace.Totals") -> str:
    """``serve/spans,<span>=<count>:<total ms>,...,lane_hits=..,
    lane_misses=..``: every program span of the process, by name."""
    cells = [f"{name}={count}:{total / 1e6:.3f}"
             for name, (count, total, _child) in sorted(totals.spans.items())]
    cells += [f"lane_hits={totals.counter('engine.lane_hits')}",
              f"lane_misses={totals.counter('engine.lane_misses')}"]
    return ",".join(["serve/spans"] + cells)


if __name__ == "__main__":
    main()

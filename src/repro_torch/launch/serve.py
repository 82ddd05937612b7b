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

``--cache-dir`` (or ``REPRO_CACHE_DIR``) keeps the kernel build and the
resolved-lane LRU across processes (``core/warmstart.py``); the
``serve/time_to_first_batch`` and ``serve/lane_cache`` rows show what a
warm start saved.

Not ported yet: the disaggregated cells (``--disagg`` and its knobs),
the daemon, the chaos harness, the lane mesh and the lane-backend
switch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import engine as lane_engine
from repro_torch.core import warmstart
from repro_torch.core.engine import resolve_device
from repro_torch.core.pimsim import PimSimulator
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import OffloadPlanner
from repro_torch.serving.policy import POLICIES, resolve_policy
from repro_torch.serving.scenarios import (SCENARIOS, SpecDecodeConfig,
                                           make_scenario, resolve_scenario,
                                           run_scenario)


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
    spec = make_scenario(args.scenario, seed=args.seed, slots=args.slots,
                         quick=args.quick)
    spec_decode = (SpecDecodeConfig(draft_len=args.draft_len,
                                    acceptance=args.acceptance,
                                    seed=args.seed)
                   if args.scenario == "spec-decode" else None)
    t0 = time.perf_counter()
    trace = run_scenario(spec, cfg, params, planner, policy=args.policy,
                         fence=args.fence, spec_decode=spec_decode,
                         device=device)
    dt = time.perf_counter() - t0
    rep = trace["controller"]
    print(f"scenario {args.scenario} (seed={args.seed}, "
          f"{len(spec.arrivals)} requests, {args.slots} slots, monolithic "
          f"engine) under policy {args.policy}: {trace['tokens']} tokens in "
          f"{trace['steps']} steps ({dt:.2f}s host wall)")
    occ = ", ".join(f"{b}:{c}" for b, c in trace["occupancy"].items())
    print(f"  batch occupancy      : {occ}")
    print(f"  realized speedup     : {rep['realized_speedup']:.3f}x "
          f"(oracle {rep['oracle_speedup']:.3f}x, "
          f"efficiency {rep['efficiency']:.3f})")
    print(f"  decision switches    : {rep['switches']}; planner queries "
          f"{rep['planner_queries']}/{rep['steps']} steps; "
          f"replans {rep['replans']}")
    if "spec_decode" in trace:
        _print_spec_decode_report(trace["spec_decode"], planner, args)


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
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent warm-start directory (kernel build + "
                         "resolved-lane snapshot); also via "
                         "REPRO_CACHE_DIR")
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the lane resolver "
                         "(default: the current CUDA device)")
    args = ap.parse_args(argv)
    try:
        if args.scenario:
            args.scenario = resolve_scenario(args.scenario)
        args.policy = resolve_policy(args.policy)
    except ValueError as e:
        ap.error(str(e))

    t_start = time.perf_counter()
    device = resolve_device(args.device)
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

    if args.scenario:
        run_scenario_mode(args, full_cfg, cfg, params, device,
                          t_start=t_start)
        _warm_epilogue(args)
        return

    # Offload plan computed against the FULL architecture (the simulator
    # works on real matrix sizes regardless of the smoke model served).
    planner = OffloadPlanner(full_cfg, PimSimulator(device=device))
    eng = ServingEngine(cfg, params, slots=args.slots, max_seq=128,
                        planner=planner, device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, cfg.vocab, size=4 + i % 8),
                           max_new=args.max_new))
    t0 = time.perf_counter()
    stats = eng.run(max_steps=2000)
    dt = time.perf_counter() - t0
    print(f"served {args.requests} requests (monolithic engine): "
          f"{stats['tokens']} tokens in {stats['steps']} steps "
          f"({dt:.2f}s host wall)")
    tel = stats["pim_telemetry"]
    print(f"PIM offload telemetry (arch={full_cfg.name}, "
          f"batch={tel['batch']}):")
    print(f"  decode GEMV time host-only : {tel['host_ns']/1e3:10.1f} us")
    print(f"  with LP5X-PIM offload      : {tel['mixed_ns']/1e3:10.1f} us")
    print(f"  speedup {tel['speedup']:.2f}x; offloaded "
          f"{len(tel['offloaded'])}/{tel['n_sites']} GEMV sites")
    _warm_epilogue(args)


def _warm_epilogue(args) -> None:
    """Parseable lane-cache counters + snapshot save (no-op without a
    cache dir)."""
    info = lane_engine.lane_cache_info()
    print(f"serve/lane_cache,hits={info['hits']},misses={info['misses']},"
          f"size={info['size']}", flush=True)
    saved = warmstart.save_warm_start(args.cache_dir)
    if saved >= 0:
        print(f"warm start: saved {saved} lanes", flush=True)


if __name__ == "__main__":
    main()

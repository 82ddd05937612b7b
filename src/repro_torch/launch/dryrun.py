"""The dry-run's PIM offload report: decode-phase telemetry per arch.

    python -m repro_torch.launch.dryrun --pim --arch granite-8b
    python -m repro_torch.launch.dryrun --pim --all --scenario bursty \\
        --policy hysteresis --disagg

For each arch, :func:`pim_offload_report` plans every (spec variant x
GEMV site) point in one ``OffloadPlanner.plan_grid`` call (one batched
lane resolution on ``--device``, default the card), records each
variant's plan and decode-step speedup curve, optionally runs the
adaptive offload controller closed-loop over a scenario's occupancy
(``--scenario`` / ``--policy``, ``--disagg`` for the cell pair's decode
occupancy), and closes with the spec-family sweep.  The record is the
JAX package's, ``==`` after a JSON round trip; it is written to
``experiments/dryrun_torch/pim/<arch>.json``.

The dry-run's other mode, lowering and compiling (arch x shape x mesh)
cells under the production meshes (``--shape``, ``--mesh pod1|pod2|both``,
``--variant``, ``--extrap-only``, ``--skip-existing``), and the lane mesh
(``--pim --mesh N``) belong to the lane-mesh / distribution slice and
are refused with an error that says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

from repro_torch.configs import ARCHS

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

_NOT_PORTED = ("belongs to the lane-mesh / distribution slice, which is "
               "not ported yet")


def pim_offload_report(arch: str, batches=(1, 2, 4, 8, 16),
                       scenario: str | None = None,
                       policy: str = "per-step",
                       disagg: bool = False, device=None) -> dict:
    """Decode-phase PIM offload telemetry across a hardware-variant grid.

    One ``OffloadPlanner.plan_grid`` call covers every (spec variant x
    GEMV site) point of this model; per variant the record holds the
    plan and the end-to-end decode-step speedup over batch sizes.  With
    ``scenario`` the report also runs the adaptive offload controller
    closed-loop over that scenario's simulated occupancy trace (no model
    involved); the ``spec-decode`` scenario drives the loop from
    ``simulate_spec_decode``'s occupancy and records the draft/verify
    accounting.  With ``disagg`` a second closed loop runs over the
    disaggregated cell pair's decode occupancy (``simulate_disagg``) and
    the record gains the handoff/SLO scheduling telemetry.  The report
    closes with the heterogeneous spec-family sweep: one ``plan_grid``
    over the whole population, then each family's offload frontier and
    speculative-decode economics.  The planner resolves its lanes on
    ``device`` (default: the card).  Writes
    ``experiments/dryrun_torch/pim/<arch>.json``.
    """
    from repro_torch.configs.specfam import SPEC_FAMILIES
    from repro_torch.core.timing import (DEFAULT_SYSTEM, LpddrTimings,
                                         PimSpec, SystemSpec)
    from repro_torch.serving.offload import OffloadPlanner
    from repro_torch.serving.scenarios import (DisaggConfig,
                                               SpecDecodeConfig, assign_slo,
                                               make_scenario,
                                               occupancy_trace,
                                               resolve_scenario,
                                               run_policy_over_trace,
                                               simulate_disagg,
                                               simulate_spec_decode)

    variants = {
        "lp5x-9600": DEFAULT_SYSTEM,
        "fast-core": SystemSpec(timings=LpddrTimings(tRCD=15.0, tRP=15.0)),
        "mac2": SystemSpec(pim=PimSpec(mac_interval_ck=2)),
        "srf1k": SystemSpec(pim=PimSpec(srf_bytes=1024)),
    }
    planner = OffloadPlanner(ARCHS[arch], device=device)
    grid = planner.plan_grid(list(variants.values()))
    rec: dict = dict(arch=arch, variants={})
    for (name, spec), decisions in zip(variants.items(), grid):
        rec["variants"][name] = dict(
            sites=[{**dataclasses.asdict(d.site), "pim_ns": d.pim_ns,
                    "host_ns": d.host_ns, "reshape": d.reshape,
                    "offload_below_batch": d.offload_below_batch}
                   for d in decisions],
            # str keys: the in-memory record matches its JSON round-trip
            decode_speedup={str(b): planner.decode_speedup(batch=b,
                                                           spec=spec)
                            for b in batches},
        )
    if scenario:
        scenario = resolve_scenario(scenario)
        sc = make_scenario(scenario, seed=0, quick=True)
        if scenario == "spec-decode":
            sd = SpecDecodeConfig()
            sim = simulate_spec_decode(sc, sd)
            occ = [b for b in sim["per_tick_batch"] if b > 0]
            drafted = sum(sim["drafted"].values())
            accepted = sum(sim["accepted"].values())
            rec["spec_decode"] = dict(
                config=sd.to_record(), drafted=drafted, accepted=accepted,
                wasted=drafted - accepted,
                rounds=sum(sim["rounds"].values()),
                model=planner.spec_decode_speedup(
                    draft_len=sd.draft_len, acceptance=sd.acceptance))
        else:
            occ = occupancy_trace(sc)
        controller = run_policy_over_trace(planner, policy, occ)
        rec["serving_policy"] = dict(scenario=scenario, policy=policy,
                                     report=controller.report())
        if disagg:
            # The cell pair's decode occupancy under bounded prefill,
            # a bounded KV-handoff queue and a mixed SLO population —
            # the policy sees what the disagg decode cell would show it.
            dcfg = DisaggConfig(prefill_budget=2, handoff_bound=3,
                                starvation_age=4)
            slo = assign_slo(sc, frac_latency=0.5)
            sim = simulate_disagg(sc, dcfg, slo)
            dec = [b for b in sim["per_tick_batch"] if b > 0]
            dctl = run_policy_over_trace(planner, policy, dec)
            rec["disagg"] = dict(
                scenario=scenario, policy=policy,
                config=dcfg.to_record(),
                slo={str(r): s for r, s in sorted(slo.items())},
                max_handoff_depth=sim["max_handoff_depth"],
                decode_steps=len(dec),
                report=dctl.report())
    # Heterogeneous spec-family sweep: the whole population's decisions
    # come from ONE batched grid dispatch; frontiers and spec-decode
    # economics per family are then cache lookups + arithmetic.
    planner.plan_grid(list(SPEC_FAMILIES.values()))
    rec["spec_families"] = {
        name: dict(frontier=planner.frontier(spec=s),
                   spec_decode=planner.spec_decode_speedup(spec=s))
        for name, s in SPEC_FAMILIES.items()}
    out_dir = OUT_DIR / "pim"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}.json").write_text(json.dumps(rec, indent=1))
    return rec


def print_report(arch: str, rec: dict, scenario, policy) -> None:
    """The reference's ``[pim]`` summary lines of one arch's record."""
    base = rec["variants"]["lp5x-9600"]["decode_speedup"]["1"]
    print(f"[pim] {arch}: decode b=1 speedup "
          f"{base['speedup']:.2f}x, "
          f"{len(base['offloaded'])}/{base['n_sites']} sites", flush=True)
    if "serving_policy" in rec:
        rep = rec["serving_policy"]["report"]
        print(f"[pim] {arch}: {scenario} x {policy}: "
              f"realized {rep['realized_speedup']:.2f}x / oracle "
              f"{rep['oracle_speedup']:.2f}x (eff "
              f"{rep['efficiency']:.3f}), "
              f"{rep['planner_queries']} queries over "
              f"{rep['steps']} steps", flush=True)
    if "spec_decode" in rec:
        sdr = rec["spec_decode"]
        print(f"[pim] {arch}: spec-decode "
              f"{sdr['accepted']}/{sdr['drafted']} drafts "
              f"accepted, model "
              f"{sdr['model']['speedup']:.2f}x/token", flush=True)
    for fam, frec in rec["spec_families"].items():
        n_pim = sum(1 for b in frec["frontier"].values() if b > 1)
        print(f"[pim] {arch}: family {fam}: {n_pim}/"
              f"{len(frec['frontier'])} sites PIM-favored, "
              f"spec-decode "
              f"{frec['spec_decode']['speedup']:.2f}x/token", flush=True)
    if "disagg" in rec:
        drep = rec["disagg"]["report"]
        print(f"[pim] {arch}: disagg cells x {policy}: eff "
              f"{drep['efficiency']:.3f} over "
              f"{drep['steps']} decode steps, peak handoff "
              f"depth {rec['disagg']['max_handoff_depth']}", flush=True)


def main(argv=None) -> None:
    from repro_torch.serving.policy import POLICIES, resolve_policy
    from repro_torch.serving.scenarios import SCENARIOS, resolve_scenario

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape",
                    help=f"cell lowering only, which {_NOT_PORTED}")
    ap.add_argument("--mesh", default="pod1",
                    help="pod1|pod2|both (cell lowering) or an integer N "
                         f"(the --pim lane mesh): either {_NOT_PORTED}")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--pim", action="store_true",
                    help="emit decode-phase PIM offload telemetry per arch "
                         "(multi-spec grid, one batched lane resolution)")
    ap.add_argument("--scenario", default=None,
                    help="with --pim: also run the adaptive offload "
                         "controller closed-loop over this scenario's "
                         "simulated occupancy trace "
                         f"(one of {sorted(SCENARIOS)}; underscores ok)")
    ap.add_argument("--policy", default="per-step",
                    help="with --pim --scenario: offload control policy "
                         f"(one of {sorted(POLICIES)}; underscores ok)")
    ap.add_argument("--disagg", action="store_true",
                    help="with --pim: run the closed loop over the "
                         "disaggregated cell pair's decode occupancy "
                         "(bounded prefill/handoff, SLO-mixed admission; "
                         "defaults --scenario to bursty)")
    ap.add_argument("--extrap-only", action="store_true")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent warm-start directory (kernel build + "
                         "resolved-lane snapshot); also via "
                         "REPRO_CACHE_DIR")
    ap.add_argument("--device", default=None,
                    help="torch device the lanes resolve on (default: "
                         "the card)")
    args = ap.parse_args(argv)
    try:
        if args.scenario:
            args.scenario = resolve_scenario(args.scenario)
        args.policy = resolve_policy(args.policy)
    except ValueError as e:
        ap.error(str(e))

    lowering = [flag for flag, given in (
        ("--shape", args.shape is not None),
        (f"--mesh {args.mesh}", args.mesh != "pod1"),
        (f"--variant {args.variant}", args.variant != "baseline"),
        ("--extrap-only", args.extrap_only),
        ("--skip-existing", args.skip_existing)) if given]
    if lowering:
        ap.error(f"{', '.join(lowering)}: cell lowering and the lane mesh "
                 f"{_NOT_PORTED}")
    if not args.pim:
        ap.error(f"only --pim runs: cell lowering {_NOT_PORTED}")
    if not args.all and args.arch not in ARCHS:
        ap.error(f"--pim needs --all or --arch from {list(ARCHS)}")
    if args.disagg and args.scenario is None:
        args.scenario = "bursty"

    from repro_torch.core import warmstart
    from repro_torch.core.engine import resolve_device
    dev = resolve_device(args.device)
    warm = warmstart.enable_warm_start(args.cache_dir)
    if warm["cache_dir"]:
        state = "on" if warm["compile_cache"] else "off"
        print(f"warm start: cache-dir {warm['cache_dir']} (kernel build "
              f"cache {state}, {warm['lanes']} lanes loaded)", flush=True)

    for arch in (list(ARCHS) if args.all else [args.arch]):
        rec = pim_offload_report(arch, scenario=args.scenario,
                                 policy=args.policy, disagg=args.disagg,
                                 device=dev)
        print_report(arch, rec, args.scenario, args.policy)
    warmstart.save_warm_start(args.cache_dir)
    sys.exit(0)


if __name__ == "__main__":
    main()

"""The dry-run: every (arch x shape x mesh) cell traced on a fake
512-rank mesh, and the PIM offload report.

    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
        --mesh pod1
    python -m repro_torch.launch.dryrun --all --mesh both --jobs 8
    python -m repro_torch.launch.dryrun --pim --arch granite-8b [--mesh 4]
    python -m repro_torch.launch.dryrun --pim --all --scenario bursty \\
        --policy hysteresis --disagg

**Cell lowering.**  Per cell, :func:`run_cell`

1. builds the step (:func:`build_step`: train step with AdamW, prefill or
   decode step),
2. traces it (:func:`lower_cell`) under the production ``DeviceMesh``
   (``launch/mesh.py``: (16, 16) or (2, 16, 16) over a fake 512-rank
   process group) with the arguments placed by the sharding rules of
   ``distribution/sharding.py`` as DTensors of fake tensors: nothing is
   allocated and nothing is launched, and the group is destroyed when
   the trace ends;
3. records what the trace saw (``distribution/hlo_analysis.py``) and
   writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<variant>].json``
   (``--jobs N`` traces the cells in N worker processes).

The record has the JAX package's keys where the port has a
counterpart: ``chips``, ``lower_s`` (the trace's seconds), ``flops``
(per device: the local ops DTensor runs, counted with
``torch.utils.flop_counter``'s formulas), ``bytes_accessed`` (per device
input plus output bytes of every local op, views excluded: a no-fusion
upper bound, as XLA's is), ``collective`` and ``hlo_collective_ops``
(the traced collectives, priced by the JAX package's conventions),
``model_flops``, ``n_layers``, ``memory.argument_bytes`` and
``output_bytes`` (the local shard bytes of the step's arguments and
results), ``per_device_arg_gib`` (``argument_bytes`` in GiB: the bytes
are already per device, where the JAX package divides XLA's figure by
the chip count), ``extrap`` (from 2- and 4-layer probes) and
``wall_s``.  Keys with no counterpart: ``compile_s`` (nothing is
compiled), ``memory.temp_bytes`` and ``memory.peak_bytes`` (no buffer
assignment runs).  Added: ``device_type`` (the fake tensors' device;
the CPU's fake group runs an all-to-all as an all-gather),
``traced_ops``, ``collective_sites`` (the twelve model lines whose
collectives move the most bytes) and ``roofline`` (the cell's
``RooflineTerms`` row at the H100 spec figures of
``distribution/roofline.py``).
The port's layer loop and blockwise attention are traced unrolled, so
``flops`` already counts every executed attention block: ``extrap``
adds nothing for attention (``attn_added_global`` is 0).

**PIM report.**  :func:`pim_offload_report` plans every (spec variant x
GEMV site) point in one ``OffloadPlanner.plan_grid`` call (one batched
lane resolution on ``--device``, default the card; ``--mesh N`` splits
it over a lane mesh of N shards of that device), records each variant's
plan and decode-step speedup curve, optionally runs the adaptive offload
controller closed-loop over a scenario's occupancy (``--scenario`` /
``--policy``, ``--disagg`` for the cell pair's decode occupancy), and
closes with the spec-family sweep.  The record is the JAX package's,
``==`` after a JSON round trip; it is written to
``experiments/dryrun_torch/pim/<arch>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
import warnings

import torch

from repro_torch.configs import ARCHS, SHAPES, shapes_for

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

VARIANTS = ("baseline", "serve-tp", "serve-tp-w8", "serve-tp-w4",
            "serve-tp-w4-kv8", "remat-dots", "remat-none", "chunked-ce",
            "chunked-ce+dots", "moe-shard", "tp-save", "mesh-64x4",
            "moe-shard+save", "flash-skip", "flash-skip+ce")


def apply_variant(name: str):
    """Perf variants: reset every knob, then flip the variant's."""
    from repro_torch.distribution import roofline as RL
    from repro_torch.distribution import sharding as SH
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import layers as LAY
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name}")
    SH.SERVE_TP_ONLY = False
    M.REMAT_POLICY = "full"
    M.CE_CHUNKS = 0
    M.QUANT_BITS = 0
    M.KV_QUANT = False
    MESH.MESH_OVERRIDE = None
    MOE.DISPATCH_SPEC = None
    LAY.FLASH_SKIP_BLOCKS = False
    RL.FLASH_SKIP_BLOCKS = False
    if name.startswith("serve-tp"):
        SH.SERVE_TP_ONLY = True
        M.QUANT_BITS = {"serve-tp": 0, "serve-tp-w8": 8}.get(name, 4)
        M.KV_QUANT = name == "serve-tp-w4-kv8"
    if name in ("remat-dots", "chunked-ce+dots"):
        M.REMAT_POLICY = "dots"
    if name == "remat-none":
        M.REMAT_POLICY = "none"
    if name in ("chunked-ce", "chunked-ce+dots", "flash-skip+ce"):
        M.CE_CHUNKS = 8
    if name in ("moe-shard", "moe-shard+save"):
        MOE.DISPATCH_SPEC = ("data", None)
    if name == "moe-shard+save":
        M.REMAT_POLICY = "moe-save"
    if name == "tp-save":
        M.REMAT_POLICY = "tp-save"
    if name == "mesh-64x4":
        MESH.MESH_OVERRIDE = (64, 4)
    if name in ("flash-skip", "flash-skip+ce"):
        LAY.FLASH_SKIP_BLOCKS = True
        RL.FLASH_SKIP_BLOCKS = True


def build_step(cfg, shape):
    """``(fn, kind)``: the cell's step over its arguments."""
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import (adamw_update, tree_leaves,
                                                tree_unflatten)
    if shape.kind == "train":
        def train_step(params, opt, batch):
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = M.loss_fn(cfg, params, batch)[0]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # a leaf the loss does not reach (ln2 of an MLP-free block)
            # gets a zero grad, as jax.grad gives it
            grads = tree_unflatten(params, [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, grads)])
            params, opt = adamw_update(params, grads, opt, lr=3e-4)
            return params, opt, loss
        return train_step, "train"
    if shape.kind == "prefill":
        def prefill_step(params, batch, cache):
            with torch.no_grad():
                return M.prefill(cfg, params, batch, cache)
        return prefill_step, "prefill"

    def decode(params, cache, token, pos):
        with torch.no_grad():
            return M.decode_step(cfg, params, cache, token, pos)
    return decode, "decode"


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from repro_torch.distribution.sharding import leaves_with_paths
    total = 0
    for _path, t in leaves_with_paths(tree):
        if dataclasses.is_dataclass(t):
            total += _local_bytes([getattr(t, f.name)
                                   for f in dataclasses.fields(t)])
        elif isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_override=None, device=None, mesh=None) -> dict:
    """Trace one cell's step under its production mesh; returns what the
    trace measured (``flops``, ``bytes_accessed``, ``collectives``,
    ``argument_bytes``, ...).  ``device``: the fake tensors' device type
    (default: the card).  ``mesh``: a ``DeviceMesh`` to trace on instead
    (its process group must be live); without one the production mesh
    is built over a fake 512-rank group that exists only for the trace.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.engine import resolve_device
    from repro_torch.distribution import sharding as SH
    from repro_torch.distribution.hlo_analysis import StepRecorder
    from repro_torch.distribution.layout import mesh_layout
    from repro_torch.launch.mesh import (fake_process_group,
                                         make_production_mesh)
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import adamw_init

    if mesh is None:
        dev_type = resolve_device(device).type
        with fake_process_group():
            return lower_cell(arch, shape_name, multi_pod, cfg_override,
                              dev_type, make_production_mesh(
                                  multi_pod=multi_pod,
                                  device_type=dev_type))
    cfg = cfg_override or ARCHS[arch]
    shape = SHAPES[shape_name]
    dev_type = mesh.device_type
    pspecs = M.param_specs(cfg, torch.bfloat16)
    ispecs = M.input_specs(cfg, shape, torch.bfloat16)
    pshard = SH.param_shardings(cfg, mesh, shape.kind)
    ishard = SH.input_shardings(cfg, mesh, shape)
    fn, kind = build_step(cfg, shape)
    with FakeTensorMode():
        params = SH.distribute(pspecs, pshard)
        inputs = SH.distribute(ispecs, ishard)
        if kind == "train":
            with implicit_replication():
                opt = adamw_init(params)
            args = (params, opt, inputs["batch"])
        elif kind == "prefill":
            args = (params, inputs["batch"], inputs["cache"])
        else:
            args = (params, inputs["cache"], inputs["token"], inputs["pos"])
        arg_bytes = _local_bytes(args)
        rec = StepRecorder(dev_type)
        # The trace allocates nothing, so flash attention takes every
        # query block at once: a step stays O(key blocks) ops.
        flash_cap, L.FLASH_CHUNK_SCORES = L.FLASH_CHUNK_SCORES, None
        t0 = time.perf_counter()
        try:
            with rec, mesh_layout(), implicit_replication(), \
                    warnings.catch_warnings():
                # scalars made inside the model (positions, counts) are
                # replicated on purpose: implicit_replication's warning
                warnings.filterwarnings("ignore",
                                        message="Found a non-scalar")
                out = fn(*args)
        finally:
            L.FLASH_CHUNK_SCORES = flash_cap
        lower_s = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
    return dict(cfg=cfg, shape=shape, chips=mesh.size(), lower_s=lower_s,
                flops=rec.flops, bytes_accessed=rec.bytes_accessed,
                collectives=rec.collectives, traced_ops=rec.ops,
                argument_bytes=arg_bytes,
                output_bytes=out_bytes, device_type=dev_type)


def cost_extrapolate(arch: str, shape_name: str, multi_pod: bool,
                     cfg_override=None, device=None, mesh=None) -> dict:
    """Per-device FLOPs and bytes from 2- and 4-layer probes:
    total(L) = base + L x per_layer.

    The port traces every layer (a Python loop), so a full-depth trace
    already counts them all; the probes give the JAX package's
    extrapolation beside it, and they agree for uniform layers.  Layer
    kinds (local / global) only change attention, whose executed blocks
    the trace counts in full (``attn_added_global`` is 0)."""
    from repro_torch.distribution.roofline import attention_hlo_flops
    cfg = cfg_override or ARCHS[arch]
    nl_a, nl_b = 2, 4
    vals = {}
    for nl in (nl_a, nl_b):
        low = lower_cell(arch, shape_name, multi_pod,
                         cfg_override=dataclasses.replace(cfg, n_layers=nl),
                         device=device, mesh=mesh)
        vals[nl] = (low["flops"], low["bytes_accessed"])
    fa, ba = vals[nl_a]
    fb, bb = vals[nl_b]
    per_layer_f = (fb - fa) / (nl_b - nl_a)
    per_layer_b = (bb - ba) / (nl_b - nl_a)
    flops_dev = fa - nl_a * per_layer_f + cfg.n_layers * per_layer_f
    bytes_dev = ba - nl_a * per_layer_b + cfg.n_layers * per_layer_b
    attn = attention_hlo_flops(cfg, SHAPES[shape_name])
    return dict(flops_dev=flops_dev, bytes_dev=bytes_dev,
                matmul_flops_dev=flops_dev,
                attn_flops_global=attn["total_global"],
                attn_counted_once_global=attn["total_global"],
                attn_added_global=0.0,
                probe_layers=[nl_a, nl_b])


def _out_path(arch: str, shape_name: str, mesh_name: str,
              variant: str = "baseline") -> pathlib.Path:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return OUT_DIR / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, extrapolate: bool = True,
             variant: str = "baseline", device=None, cfg_override=None,
             mesh=None) -> dict:
    """Trace one cell and record it (see the module docstring); an error
    is recorded with its traceback, not raised, so a sweep goes on."""
    from repro_torch.distribution.hlo_analysis import (bytes_by_site,
                                                       collective_bytes)
    from repro_torch.distribution.roofline import (RooflineTerms,
                                                   min_traffic_bytes,
                                                   model_flops)
    mesh_name = "pod2" if multi_pod else "pod1"
    apply_variant(variant)
    t0 = time.perf_counter()
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_name,
               variant=variant, status="ok")
    try:
        low = lower_cell(arch, shape_name, multi_pod, cfg_override,
                         device, mesh)
        coll = collective_bytes(low["collectives"])
        rec.update(
            chips=low["chips"], device_type=low["device_type"],
            lower_s=round(low["lower_s"], 1),
            flops=float(low["flops"]),
            bytes_accessed=float(low["bytes_accessed"]),
            collective=coll,
            model_flops=model_flops(low["cfg"], low["shape"]),
            n_layers=low["cfg"].n_layers,
            memory=dict(argument_bytes=low["argument_bytes"],
                        output_bytes=low["output_bytes"]),
            hlo_collective_ops={k: v for k, v in coll.items()
                                if k != "total"},
            traced_ops=low["traced_ops"],
            collective_sites=bytes_by_site(low["collectives"], top=12),
        )
        rec["per_device_arg_gib"] = rec["memory"]["argument_bytes"] / 2**30
        # traced figures are per device: the terms take them mesh-wide
        rec["roofline"] = RooflineTerms(
            arch=arch, shape=shape_name, mesh=mesh_name, chips=rec["chips"],
            hlo_flops=rec["flops"] * rec["chips"],
            hlo_bytes=rec["bytes_accessed"] * rec["chips"],
            coll_bytes=coll["total"] * rec["chips"],
            model_flops=rec["model_flops"],
            traffic_dev=min_traffic_bytes(low["cfg"], low["shape"])).row()
        if extrapolate:
            rec["extrap"] = cost_extrapolate(arch, shape_name, multi_pod,
                                             cfg_override, device, mesh)
            rec["extrap"]["variant"] = variant
    except Exception as e:  # noqa: BLE001 - record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.perf_counter() - t0, 1)
    apply_variant("baseline")
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        _out_path(arch, shape_name, mesh_name, variant).write_text(
            json.dumps(rec, indent=1))
    return rec


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape_name) for arch, cfg in ARCHS.items()
            for shape_name in shapes_for(cfg)]


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


def _lower_one(job) -> tuple:
    """A worker's cell: ``(arch, shape, multi_pod, variant, device)`` ->
    ``(cell, record)``."""
    arch, shape_name, mp, variant, device = job
    return job[:3], run_cell(arch, shape_name, mp, variant=variant,
                             device=device)


def _print_cell(rec: dict) -> None:
    ok = rec["status"] == "ok"
    msg = (f"{rec['flops']:.3e} flops/dev, "
           f"coll {rec['collective']['total']:.3e} B, "
           f"trace {rec['lower_s']}s" if ok else rec.get("error", "?"))
    print(f"[{rec['status']}] {rec['arch']} {rec['shape']} {rec['mesh']}: "
          f"{msg}", flush=True)


def main(argv=None) -> None:
    from repro_torch.serving.policy import POLICIES, resolve_policy
    from repro_torch.serving.scenarios import SCENARIOS, resolve_scenario

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod1",
                    help="pod1|pod2|both selects the production mesh for "
                         "cell lowering; with --pim an integer N instead "
                         "splits the offload grid's lane resolution over a "
                         "lane mesh of N shards of --device")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help=f"one of {', '.join(VARIANTS)}")
    ap.add_argument("--pim", action="store_true",
                    help="emit decode-phase PIM offload telemetry per arch "
                         "(multi-spec grid, one batched lane resolution) "
                         "instead of tracing cells")
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
    ap.add_argument("--extrap-only", action="store_true",
                    help="recompute the probe extrapolation of existing "
                         "cells without the full-depth trace")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persistent warm-start directory (kernel build + "
                         "resolved-lane snapshot); also via "
                         "REPRO_CACHE_DIR")
    ap.add_argument("--device", default=None,
                    help="torch device: where --pim lanes resolve, and the "
                         "device type cells are traced for (default: the "
                         "card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cell lowering: trace cells in this many worker "
                         "processes")
    args = ap.parse_args(argv)
    try:
        if args.scenario:
            args.scenario = resolve_scenario(args.scenario)
        args.policy = resolve_policy(args.policy)
    except ValueError as e:
        ap.error(str(e))
    if args.variant not in VARIANTS:
        ap.error(f"--variant must be one of {', '.join(VARIANTS)}")

    from repro_torch.core.engine import resolve_device
    dev = resolve_device(args.device)
    if args.pim:
        _pim_main(ap, args, dev)
    if args.disagg:
        ap.error("--disagg applies to --pim runs only")
    if args.mesh not in ("pod1", "pod2", "both"):
        ap.error("--mesh must be pod1|pod2|both for cell lowering "
                 "(integer lane-mesh sizes apply to --pim only)")
    if not args.all and (args.arch not in ARCHS
                         or args.shape not in SHAPES):
        ap.error(f"cell lowering needs --all or --arch from {list(ARCHS)} "
                 f"and --shape from {list(SHAPES)}")
    meshes = {"pod1": [False], "pod2": [True],
              "both": [False, True]}[args.mesh]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    failures = 0
    jobs = []
    for arch, shape_name in cells:
        for mp in meshes:
            mesh_name = "pod2" if mp else "pod1"
            out = _out_path(arch, shape_name, mesh_name, args.variant)
            if args.skip_existing and out.exists():
                prev = json.loads(out.read_text())
                if prev.get("status") == "ok":
                    print(f"[skip] {arch} {shape_name} {mesh_name}")
                    continue
            if args.extrap_only:
                if not out.exists():
                    continue
                rec = json.loads(out.read_text())
                if rec.get("status") != "ok":
                    continue
                from repro_torch.distribution.roofline import model_flops
                apply_variant(args.variant)
                try:
                    rec["extrap"] = cost_extrapolate(arch, shape_name, mp,
                                                     device=dev)
                    rec["extrap"]["variant"] = args.variant
                    rec["model_flops"] = model_flops(ARCHS[arch],
                                                     SHAPES[shape_name])
                    out.write_text(json.dumps(rec, indent=1))
                    print(f"[extrap] {arch} {shape_name} {mesh_name}: "
                          f"{rec['extrap']['flops_dev']:.3e} flops/dev",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    failures += 1
                    print(f"[error] extrap {arch} {shape_name} "
                          f"{mesh_name}: {e}", flush=True)
                apply_variant("baseline")
                continue
            jobs.append((arch, shape_name, mp, args.variant, str(dev)))
    if args.jobs > 1 and len(jobs) > 1:
        import multiprocessing as mp_
        with mp_.get_context("spawn").Pool(args.jobs,
                                           maxtasksperchild=1) as pool:
            for _cell, rec in pool.imap_unordered(_lower_one, jobs):
                failures += rec["status"] != "ok"
                _print_cell(rec)
    else:
        for job in jobs:
            _cell, rec = _lower_one(job)
            failures += rec["status"] != "ok"
            _print_cell(rec)
    sys.exit(1 if failures else 0)


def _pim_main(ap, args, dev) -> None:
    """``--pim``: the offload report of each arch, then exit."""
    if not args.all and args.arch not in ARCHS:
        ap.error(f"--pim needs --all or --arch from {list(ARCHS)}")
    if args.disagg and args.scenario is None:
        args.scenario = "bursty"
    from repro_torch.core import engine, warmstart
    if args.mesh.isdigit():
        engine.configure_lane_mesh(engine.lane_mesh_on(int(args.mesh), dev))
        print(f"[pim] lane mesh: {args.mesh} shard(s) of {dev}", flush=True)
    elif args.mesh != "pod1":
        ap.error("--pim takes an integer --mesh N (the lane mesh); pod "
                 "meshes apply to cell lowering only")
    warm = warmstart.enable_warm_start(args.cache_dir)
    if warm["cache_dir"]:
        state = "on" if warm["compile_cache"] else "off"
        print(f"warm start: cache-dir {warm['cache_dir']} (kernel build "
              f"cache {state}, {warm['lanes']} lanes loaded)", flush=True)
    try:
        for arch in (list(ARCHS) if args.all else [args.arch]):
            rec = pim_offload_report(arch, scenario=args.scenario,
                                     policy=args.policy,
                                     disagg=args.disagg, device=dev)
            print_report(arch, rec, args.scenario, args.policy)
        warmstart.save_warm_start(args.cache_dir)
    finally:
        engine.configure_lane_mesh(None)
    sys.exit(0)


if __name__ == "__main__":
    main()

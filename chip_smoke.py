#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the last line):

1. The card (``nvidia-smi``) and the kernel build (``nvcc`` from the
   sources under ``src/repro_torch/kernels/csrc``).
2. The lane-scan kernel against its plain torch version on the card:
   fuzzed lanes at every instantiated bank count (ragged lengths,
   out-of-range opcodes and banks, wrapping timings), the probe lane,
   totals-only launches, and the PIM streams of one Fig-4 point.  Issue
   arrays and totals must be bit-equal.
3. The reference's numbers at full width: ``tests/golden/fleet_parity.json``
   and ``tests/golden/torch_port_points.json`` (the quickstart points and
   the granite-8b W8A8 offload plan, computed by the JAX package) must
   come out exactly.
4. The main path, with the lane LRU cold and the launch count at 0: the
   quickstart flow, the full Fig-4 sweep (7 dtypes, both axes) and the
   granite-8b ``decode_speedup(batch=1)``.  Each part's wall time ends in
   ``torch.cuda.synchronize()``.
5. The kernel's time at the main path's own launches, beside its bound.

The second-to-last line is the ``kernels`` JSON record; the last is
``{"ok": true, "device": {...}}``.
"""
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device-memory rate
CHAIN_CYCLES_PER_STEP = 32         # 8 dependent int ops x ~4 cycles


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def elapsed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()                                            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import granite_8b
    from repro_torch.core import engine
    from repro_torch.core.pimsim import PimSimulator
    from repro_torch.core.timing import (DEFAULT_SYSTEM, LpddrTimings,
                                         PimSpec, SystemSpec)
    from repro_torch.kernels import build, lane_scan
    from repro_torch.pimkernel.executor import (FunctionalGemv,
                                                GemvRequest, PimExecutor)
    from repro_torch.pimkernel.tileconfig import ALL_DTYPES, PimDType
    from repro_torch.serving.offload import OffloadPlanner

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = smi("name,power.limit")
    print(card)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"card: {torch.cuda.get_device_name(0)}, max SM clock {sm_mhz} "
          f"MHz, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    print(f"[1] kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_INFO['seconds']:.2f} s)")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip())

    # ---- 2. kernel == plain on the card ---------------------------------
    rng = np.random.default_rng(0)
    worst = 0

    def compare(cycs, streams, lengths, nb, what):
        nonlocal worst
        args = (cycs.to(dev), streams.to(dev), lengths.to(dev), nb)
        for need_issue in (True, False):
            ik, tk = lane_scan.lane_scan(*args, need_issue=need_issue)
            ip, tp = lane_scan.lane_scan_plain(*args, need_issue=need_issue)
            torch.cuda.synchronize()
            err = int((tk.long() - tp.long()).abs().max()) if tk.numel() \
                else 0
            if need_issue and ik.numel():
                err = max(err, int((ik.long() - ip.long()).abs().max()))
            worst = max(worst, err)
            check(err == 0, f"kernel != plain on {what} "
                  f"(need_issue={need_issue}, max abs err {err})")

    def fuzz(nb: int, f: int, n: int):
        cycs = rng.integers(0, 64, size=(f, len(lane_scan.CYC_FIELDS)))
        wrap = rng.random(cycs.shape) < 0.03       # int32 wraparound
        cycs = np.where(wrap, (1 << 30) + rng.integers(0, 1 << 20,
                                                       cycs.shape), cycs)
        streams = np.zeros((f, n, 4), np.int64)
        streams[..., 0] = rng.integers(0, 17, size=(f, n))
        odd = rng.random((f, n)) < 0.05
        streams[..., 0] = np.where(odd, rng.integers(-40, 60, (f, n)),
                                   streams[..., 0])
        streams[..., 1] = rng.integers(0, nb, size=(f, n))
        odd = rng.random((f, n)) < 0.05
        streams[..., 1] = np.where(odd, rng.integers(-2 * nb, 3 * nb,
                                                     (f, n)),
                                   streams[..., 1])
        streams[..., 2:] = rng.integers(0, 128, size=(f, n, 2))
        lengths = rng.integers(0, n + 1, size=f)
        lengths[0] = n
        as_i32 = lambda x: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(x, dtype=np.int32))
        return as_i32(cycs), as_i32(streams), as_i32(lengths)

    for nb in lane_scan.SUPPORTED_BANKS:
        compare(*fuzz(nb, 8, 64), nb, f"fuzzed lanes, {nb} banks")
    for nb in (8, 12, 16):
        compare(*fuzz(nb, 96, 400), nb, f"long fuzzed lanes, {nb} banks")
        spec = SystemSpec(timings=LpddrTimings(num_bankgroups=nb // 4))
        probe = lane_scan.probe_stream(nb)[None].contiguous()
        compare(engine.pack_cycles([spec.derive_cycles()]), probe,
                torch.tensor([probe.shape[1]], dtype=torch.int32), nb,
                f"probe lane, {nb} banks")

    # The PIM streams of one Fig-4 point (512 x 4096 W8A8, ~8k commands
    # per channel: the plain side stays short enough for the card).
    fig4 = PimExecutor(device=dev).plan_many(
        [GemvRequest.pim(512, 4096, PimDType.W8A8)])[0]
    pim_inputs = engine.pack_lanes([(fig4.ctx.cyc, s)
                                    for s in fig4.streams])
    compare(*pim_inputs, 16, "Fig-4 PIM streams 512x4096 W8A8")
    steps = int(pim_inputs[2].max())
    cu = [x.to(dev) for x in pim_inputs]
    plain_ms = elapsed_ms(
        lambda: lane_scan.lane_scan_plain(*cu, 16, need_issue=False), 1)
    short_kernel_ms = elapsed_ms(
        lambda: lane_scan.lane_scan(*cu, 16, need_issue=False), 5)
    print(f"[2] kernel == plain on the card (max abs err {worst}); "
          f"Fig-4 PIM lanes ({cu[1].shape[0]} x {steps} steps): plain "
          f"{plain_ms:.1f} ms, kernel {short_kernel_ms:.3f} ms")

    # ---- 3. the reference's numbers at full width ------------------------
    def record(res) -> dict:
        return dict(cycles=res.cycles, ns=res.ns, flops=res.flops,
                    weight_bytes=res.weight_bytes,
                    utilization=res.utilization, split=res.split,
                    counts=[int(c) for c in res.counts], energy=res.energy)

    def roundtrip(x):
        return json.loads(json.dumps(x))

    golden_specs = {"lp5x-9600": DEFAULT_SYSTEM,
                    "rcd24-mac2": SystemSpec(timings=LpddrTimings(tRCD=24.0),
                                             pim=PimSpec(mac_interval_ck=2))}
    fixture = json.loads((ROOT / "tests/golden/fleet_parity.json")
                         .read_text())
    reqs = []
    for label in fixture:
        sname, rest = label.split("/")
        kind, shape, dt, *flags = rest.split("-")
        h, w = (int(v) for v in shape.split("x"))
        sp = golden_specs[sname]
        reqs.append(GemvRequest.pim(h, w, dt, fence="fence" in flags,
                                    reshape="reshape" in flags, spec=sp)
                    if kind == "pim" else GemvRequest.baseline(h, w, dt,
                                                               spec=sp))
    got = PimExecutor(device=dev).run_many(reqs)
    check(roundtrip({k: record(r) for k, r in zip(fixture, got)}) == fixture,
          "fleet_parity.json not reproduced")

    points = json.loads((ROOT / "tests/golden/torch_port_points.json")
                        .read_text())
    quick = [("pim-4096x4096-W8A8", dict()),
             ("pim-4096x4096-W8A8-fence", dict(fence=True)),
             ("pim-1024x4096-W8A8", dict()),
             ("pim-1024x4096-W8A8-reshape", dict(reshape=True))]

    def quickstart_records(sim) -> dict:
        out = {"base-4096x4096-W8A8": record(sim.baseline(4096, 4096,
                                                          "W8A8"))}
        for label, kw in quick:
            h = int(label.split("-")[1].split("x")[0])
            out[label] = record(sim.gemv(h, 4096, "W8A8", **kw))
        return roundtrip(out)

    check(quickstart_records(PimSimulator(device=dev))
          == points["quickstart"], "quickstart points not reproduced")

    def plan_records(planner) -> list:
        return roundtrip([dict(site=d.site.name, h=d.site.h, w=d.site.w,
                               count=d.site.count, pim_ns=d.pim_ns,
                               host_ns=d.host_ns, reshape=d.reshape,
                               offload_below_batch=d.offload_below_batch)
                          for d in planner.plan()])

    planner = OffloadPlanner(granite_8b.CONFIG, device=dev)
    check(plan_records(planner) == points["granite_8b_plan"],
          "granite-8b offload plan not reproduced")
    print(f"[3] fleet_parity.json ({len(fixture)} points) and "
          f"torch_port_points.json (quickstart + granite-8b plan, "
          f"{len(points['granite_8b_plan'])} sites) reproduced exactly")

    # ---- 4. the main path ------------------------------------------------
    launched: list[tuple] = []
    real_scan = lane_scan.lane_scan

    def recording_scan(*args, **kw):     # keeps the inputs for phase 5
        launched.append((part, args, kw))
        return real_scan(*args, **kw)

    lane_scan.lane_scan = recording_scan
    engine.lane_cache_reset()
    lane_scan.LAUNCHES = 0
    walls, launches = {}, {}

    part = "quickstart"
    t0 = time.perf_counter()
    sim = PimSimulator(device=dev)
    check(quickstart_records(sim) == points["quickstart"],
          "quickstart numbers changed on the main path")
    qrng = np.random.default_rng(0)
    wts = qrng.integers(-128, 128, size=(256, 2048)).astype(np.int32)
    x = qrng.integers(-128, 128, size=(2048,)).astype(np.int32)
    y, res = sim.gemv_functional(wts, x, "W8A8")
    check(np.array_equal(y, wts.astype(np.int64) @ x.astype(np.int64)),
          "functional GEMV != W @ x")
    items = []
    for hs, ws in ((128, 512), (192, 1024), (64, 2048)):
        items.append(FunctionalGemv(
            qrng.integers(-8, 8, size=(hs, ws)).astype(np.int32),
            qrng.integers(-8, 8, size=(ws,)).astype(np.int32),
            PimDType.W4A8))
    for it, (yv, _r) in zip(items, sim.gemv_functional_many(items)):
        check(np.array_equal(yv, it.weights.astype(np.int64)
                             @ it.x.astype(np.int64)),
              "batched functional GEMV != W @ x")
    torch.cuda.synchronize()
    walls[part] = time.perf_counter() - t0
    launches[part] = lane_scan.LAUNCHES

    part = "fig4_sweep"
    t0 = time.perf_counter()
    dims = [512, 1024, 2048, 4096, 8192]
    surfaces = {axis: sim.sweep(dims, ALL_DTYPES, axis=axis)
                for axis in ("activation", "output")}
    torch.cuda.synchronize()
    walls[part] = time.perf_counter() - t0
    launches[part] = lane_scan.LAUNCHES - sum(launches.values())
    head = (points["quickstart"]["base-4096x4096-W8A8"]["ns"]
            / points["quickstart"]["pim-4096x4096-W8A8"]["ns"])
    for axis, surf in surfaces.items():
        check(sorted(surf) == sorted(d.name for d in ALL_DTYPES),
              f"sweep {axis}: dtypes {sorted(surf)}")
        vals = np.asarray([surf[d.name] for d in ALL_DTYPES])
        check(vals.shape == (7, 5) and bool(np.isfinite(vals).all())
              and bool((vals > 0).all()), f"sweep {axis}: {vals}")
        check(surf["W8A8"][dims.index(4096)] == head,
              f"sweep {axis}: 4096x4096 W8A8 point != quickstart")

    part = "granite_8b_decode"
    t0 = time.perf_counter()
    tel = OffloadPlanner(granite_8b.CONFIG,
                         sim=PimSimulator(device=dev)).decode_speedup(1)
    torch.cuda.synchronize()
    walls[part] = time.perf_counter() - t0
    launches[part] = lane_scan.LAUNCHES - sum(launches.values())
    lane_scan.lane_scan = real_scan
    check(roundtrip(tel) == points["granite_8b_decode_speedup_b1"],
          "granite-8b decode speedup != fixture")
    total_launches = lane_scan.LAUNCHES
    check(total_launches > 0 and all(v > 0 for v in launches.values()),
          f"main path did not launch the kernel: {launches}")
    for p in walls:
        print(f"[4] {p}: {walls[p]:.2f} s wall, {launches[p]} kernel "
              f"launches")
    print(f"[4] W8A8 4096x4096 speedup {head:.3f}x; granite-8b decode "
          f"speedup at batch 1: {tel['speedup']:.4f}x "
          f"({len(tel['offloaded'])}/{tel['n_sites']} sites offloaded)")

    # ---- 5. the kernel at the main path's launches ----------------------
    def bound(args, need_issue: bool) -> tuple[float, str]:
        cycs, streams, lengths = args[0], args[1], args[2]
        f, n = streams.shape[0], streams.shape[1]
        nbytes = (16 * int(lengths.sum()) + 4 * cycs.numel()
                  + 4 * lengths.numel() + 4 * f
                  + (4 * f * n if need_issue else 0))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        chain_ms = (int(lengths.max()) * CHAIN_CYCLES_PER_STEP
                    / (sm_mhz * 1e6) * 1e3)
        return max(bytes_ms, chain_ms), ("operations" if chain_ms
                                         >= bytes_ms else "bytes")

    fleets = {}
    for p in ("fig4_sweep", "granite_8b_decode"):
        runs = [(a, kw) for q, a, kw in launched if q == p]
        ms = bound_ms = 0.0
        by = "operations"
        for args, kw in runs:
            ms += elapsed_ms(lambda: real_scan(*args, **kw), 3)
            b, by = bound(args, kw.get("need_issue", True))
            bound_ms += b
        fleets[p] = dict(
            launches=len(runs), ms=ms, bound_ms=bound_ms, bound_by=by,
            lanes=sum(int(a[1].shape[0]) for a, _ in runs),
            commands=sum(int(a[2].sum()) for a, _ in runs),
            longest_lane=max(int(a[2].max()) for a, _ in runs))
        print(f"[5] {p}: {json.dumps(fleets[p])}")
    del launched

    main_fleet = fleets["granite_8b_decode"]
    kernels = {"kernels": [{
        "name": "lane_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lane_scan.cu",
        "replaces": "src/repro/kernels/lane_scan.py:49",
        "launches": total_launches, "max_abs_err": worst,
        "ms": main_fleet["ms"], "plain_ms": plain_ms,
        "bound_ms": main_fleet["bound_ms"],
        "bound_by": main_fleet["bound_by"], "library_ms": None,
        "matches_plain": worst == 0,
        "ms_on": "granite-8b decode_speedup fleet, LRU cold",
        "plain_on": f"Fig-4 PIM 512x4096 W8A8 lanes ({steps} steps)",
        "kernel_ms_on_plain_inputs": short_kernel_ms,
        "fleets": fleets}]}
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

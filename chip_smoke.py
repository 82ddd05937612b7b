#!/usr/bin/env python3
"""Build the port's kernels on one CUDA card, time each kernel alone, then
run the card's tests.

    python3 chip_smoke.py

1. The card (``nvidia-smi``) and the kernel build (``nvcc`` from the
   sources under ``src/repro_torch/kernels/csrc``), with the registers
   and spills ptxas reports for the lane-scan kernel (one per bank
   count), the tensor-core fp and int GEMM kernels and the int GEMV's
   vector kernel (one per format and rows per warp).
2. The lane-scan kernel alone at the main path's own launches: the full
   Fig-4 sweep (7 dtypes, both axes) and granite-8b's
   ``decode_speedup(batch=1)``, the lane LRU cold, each launch recorded
   and then timed beside its bound (the longest lane's serial chain or
   the bytes it needs); and its plain version beside it on the PIM lanes
   of one Fig-4 point.
3. The PIM-tile kernels alone, on the operands ``pim_linear`` hands them
   for one granite-8b layer plus ``lm_head`` at full width (the inputs of
   ``tests/golden/torch_pim_linear.json``): the int GEMV at all 40 site x
   format launches, each beside its bound, and the sum over them of time
   - bound; a 1 x 32 int GEMV, the protocol's floor; the tensor-core int
   GEMM on ``lm_head``'s GEMV operands as a batch of one, beside the
   GEMV; each kernel at ``lm_head``, beside its bound, its plain version
   and, where one exists, one PyTorch call of the same function; and the
   int GEMM at W8A8, batch 16 (two N tiles), beside ``_int_mm``.
4. The card's tests, ``python -m pytest -q --noconftest -m gpu
   tests/test_torch_gpu.py``: the kernels against their plain versions,
   the goldens at full width, models, serving, training, the dry-run and
   the lane mesh.  The script exits with their exit code.

Times follow one protocol, :func:`timed_ms`: L2 flushed before every
launch, one pair of CUDA events per launch, the median, min and max over
many launches (100 for the PIM-tile kernels, 5 for each lane-scan launch,
which runs for up to 0.1 s), a kernel and its library call timed in
turns.  Before the tests' output comes the card's name and power limit
and the ``kernels`` JSON record (all five kernels); a failure in phases
1-3 exits 1 before it.
"""
import gc
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]

import torch_card  # noqa: E402
from bench import peaks  # noqa: E402

# H100 SXM dense tensor-core peaks: int8 and fp8, and bf16 (an int16
# activation counts as two int8 halves, so A16 paths take the bf16 rate).
PEAK_OPS_8BIT = 1979e12
PEAK_OPS_16BIT = 989e12
CHAIN_CYCLES_PER_STEP = 32         # 8 dependent int ops x ~4 cycles
L2_FLUSH_BYTES = 128 << 20         # written before each timed launch
HOST_COVER_CYCLES = 400_000        # device sleep before each: ~0.2 ms
KERNEL_REPS = 100                  # timed launches per PIM-tile kernel
LANE_REPS = 5                      # per lane-scan launch (each <= 0.1 s)

# The PIM-tile kernels: wrapper name -> (the TPU kernel it replaces, source).
PIM_KERNELS = {
    "pim_gemv_int": ("src/repro/kernels/pim_gemv.py:37",
                     "src/repro_torch/kernels/csrc/pim_gemv.cu"),
    "pim_gemv_fp": ("src/repro/kernels/pim_gemv.py:63",
                    "src/repro_torch/kernels/csrc/pim_gemv.cu"),
    "pim_gemm_int": ("src/repro/kernels/pim_gemm.py:22",
                     "src/repro_torch/kernels/csrc/pim_gemm.cu"),
    "pim_gemm_fp": ("src/repro/kernels/pim_gemm.py:46",
                    "src/repro_torch/kernels/csrc/pim_gemm.cu"),
}


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


_FLUSH: list = []


def timed_ms(fns: dict, reps: int) -> dict:
    """Device time of each callable in ``fns``, taken in turns, with L2
    cold: before every launch a buffer of ``L2_FLUSH_BYTES`` (above the
    card's 50 MB L2) is written and then another of half that size is
    read, so L2 holds none of the operands and no dirty lines whose
    write-back the timed launch would pay for.  A device-side sleep then
    keeps the card busy while the host records the start event and
    enqueues the launch, so host work in a wrapper never lands between a
    launch's own pair of CUDA events.  Returns, per name, the median, min
    and max over ``reps`` launches."""
    if not _FLUSH:
        _FLUSH.extend([
            torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda"),
            torch.zeros(L2_FLUSH_BYTES // 2, dtype=torch.uint8,
                        device="cuda")])
    for fn in fns.values():                         # warm-up
        fn()
    torch.cuda.synchronize()
    pairs = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            _FLUSH[0].zero_()
            _FLUSH[1].max()
            torch.cuda._sleep(HOST_COVER_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs[name].append((start, end))
    torch.cuda.synchronize()
    out = {}
    for name, ev in pairs.items():
        t = sorted(a.elapsed_time(b) for a, b in ev)
        out[name] = dict(ms=t[len(t) // 2] if len(t) % 2
                         else (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2,
                         min_ms=t[0], max_ms=t[-1], launches=len(t))
    return out


def ptxas_kernels(log: str, pattern: str) -> list[dict]:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported for
    each entry function whose mangled name matches ``pattern``."""
    found = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        if not re.search(pattern, name):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        args = re.findall(r"ILi(\d+)E|Li(\d+)E", name)
        found.append(dict(
            name=re.search(pattern, name).group(0) + "<" + ",".join(
                a or b for a, b in args) + ">",
            registers=int(regs.group(1)) if regs else None,
            spill_bytes=(int(spill.group(1)) + int(spill.group(2))
                         if spill else None)))
    return found


def kernel_bound(out: torch.Tensor, args: tuple) -> tuple[float, str, int]:
    """The least time (ms) the card could take for one PIM-tile call on
    ``args`` giving ``out``: the larger of the bytes it must move (each
    tensor argument read once, the output written once) over the memory
    rate and its 2 B H W operations at the tensor-core peak; what bounds
    it; and the bytes."""
    w_op, x_op = args[0], args[1]
    width = x_op.shape[-1]
    batch = 1 if x_op.dim() == 1 else x_op.shape[0]
    nbytes = out.numel() * 4 + sum(a.numel() * a.element_size()
                                   for a in args
                                   if isinstance(a, torch.Tensor))
    bytes_ms = nbytes / peaks.HBM_BYTES_PER_S * 1e3
    peak = PEAK_OPS_16BIT if x_op.element_size() == 2 else PEAK_OPS_8BIT
    ops_ms = 2 * batch * w_op.shape[0] * width / peak * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def time_kernel(name: str, dtype: str, kernel, plain, out: torch.Tensor,
                args: tuple, kw: dict) -> dict:
    """One timed row of phase 3: the kernel on ``args`` (median of
    ``KERNEL_REPS``, in turns with its library call), its plain version,
    its bound and its largest difference from plain."""
    w_op, x_op = args[0], args[1]
    batch = 1 if x_op.dim() == 1 else x_op.shape[0]
    err = torch_card.pim_error(name, out, plain(*args, **kw), args)
    fns = {"kernel": lambda: kernel(*args, **kw)}
    lib = library_call(dtype, w_op, x_op)
    if lib is not None:
        fns["library"] = lib
    t = timed_ms(fns, KERNEL_REPS)          # kernel and library in turns
    plain_t = timed_ms({"plain": lambda: plain(*args, **kw)}, 5)["plain"]
    bound_ms, bound_by, nbytes = kernel_bound(out, args)
    row = dict(
        ms=t["kernel"]["ms"], plain_ms=plain_t["ms"],
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=t["library"]["ms"] if lib else None,
        max_abs_err=err, batch=batch, bytes=nbytes,
        spread={k: [v["min_ms"], v["max_ms"]] for k, v in t.items()},
        launches_timed=KERNEL_REPS)
    print(f"[3] {name} lm_head {dtype} B={batch}: {json.dumps(row)}")
    return row


def gemv_int_sites(kernel, calls: dict, variant_of=None) -> dict:
    """The int GEMV at every site and int format of phase 3
    (``calls``: (site, dtype) -> the out, args and kw of its call), each
    timed on its own operands (median of ``KERNEL_REPS``, L2 flushed)
    beside its bound; then the sums over those launches, each launched
    once there, of time, bound and time - bound.  ``variant_of(args,
    kw)`` names the kernel variant a call takes, where there are
    variants."""
    rows = {}
    for (site, dtype), (out, args, kw) in calls.items():
        t = timed_ms({"kernel": lambda: kernel(*args, **kw)},
                     KERNEL_REPS)["kernel"]
        bound_ms, bound_by, _ = kernel_bound(out, args)
        row = dict(h=args[0].shape[0], w=args[1].shape[0], ms=t["ms"],
                   spread=[t["min_ms"], t["max_ms"]], bound_ms=bound_ms,
                   bound_by=bound_by, gap_ms=t["ms"] - bound_ms,
                   variant=variant_of(args, kw) if variant_of else None)
        rows[f"{site}/{dtype}"] = row
        print(f"[3] pim_gemv_int {site} {dtype}: {json.dumps(row)}")
    total = {k: sum(r[k] for r in rows.values())
             for k in ("ms", "bound_ms", "gap_ms")}
    print(f"[3] pim_gemv_int over {len(rows)} site x format launches: "
          f"time {total['ms']!r} ms, bound {total['bound_ms']!r} ms, "
          f"sum(time - bound) {total['gap_ms']!r} ms")
    return dict(sites=rows, launches=len(rows), **total)


def mma_at_batch_1(kernel, calls: dict) -> dict:
    """The tensor-core int GEMM (``pim_gemm_int``) on the int GEMV's
    ``lm_head`` operands as a batch of one, timed beside the GEMV (in
    turns): a yardstick for the GEMV, which the port never replaces by
    it."""
    from repro_torch.kernels import pim_gemm

    out = {}
    for (site, dtype), (_, args, kw) in calls.items():
        if site != "lm_head":
            continue
        gemm_args = (args[0], args[1][None], *args[2:])
        check(pim_gemm.int_variant(args[0], gemm_args[1]) == "mma",
              f"lm_head {dtype} at B = 1 is not on the MMA GEMM")
        t = timed_ms({"gemv": lambda: kernel(*args, **kw),
                      "mma": lambda: pim_gemm.pim_gemm_int(*gemm_args,
                                                           **kw)},
                     KERNEL_REPS)
        out[dtype] = {k: v["ms"] for k, v in t.items()}
        print(f"[3] lm_head {dtype} B=1: pim_gemv_int "
              f"{t['gemv']['ms']!r} ms, MMA GEMM {t['mma']['ms']!r} ms")
    return out


def library_call(dtype: str, w_op: torch.Tensor, x_op: torch.Tensor):
    """One PyTorch call of the same function, to time as a yardstick (the
    port never calls it), or None where no single call computes it:
    ``torch._int_mm`` for W8A8 (its batch padded with zero rows to 32,
    above its minimum of 16 and a multiple of 8) and ``torch._scaled_mm``
    with unit scales for FP_W8A8 (batch padded to 16).  A16, W4 and
    FP_W8A16 have no such call."""
    xb = x_op if x_op.dim() == 2 else x_op[None]
    if dtype == "W8A8":
        a = torch.zeros((32, xb.shape[1]), dtype=torch.int8, device=xb.device)
        a[: xb.shape[0]] = xb
        return lambda: torch._int_mm(a, w_op.T)
    if dtype == "FP_W8A8":
        a = torch.zeros((16, xb.shape[1]), dtype=torch.uint8,
                        device=xb.device)
        a[: xb.shape[0]] = xb.view(torch.uint8)
        a = a.view(torch.float8_e4m3fn)
        one = torch.ones((), device=xb.device)
        return lambda: torch._scaled_mm(
            a, w_op.T, scale_a=one, scale_b=one, out_dtype=torch.float32)
    return None


def build(lane_scan) -> dict:
    """Phase 1: build the kernel library and report ptxas's registers and
    spills; returns each kernel's ptxas rows."""
    from repro_torch.kernels import build as B

    t0 = time.perf_counter()
    B.load_library()
    print(f"[1] kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {B.BUILD_INFO['seconds']:.2f} s)")
    logs = B.BUILD_INFO["logs"]
    for source, log in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        print(f"    ptxas {source}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill "
              f"bytes {spills}")
    found = {"lane_scan": ptxas_kernels(logs.get("lane_scan.cu", ""),
                                        r"lane_scan_kernel")}
    for k in found["lane_scan"]:
        print(f"    ptxas {k['name']} (NB): {k['registers']} registers, "
              f"{k['spill_bytes']} spill bytes")
    check(not logs
          or len(found["lane_scan"]) == len(lane_scan.SUPPORTED_BANKS),
          f"ptxas reported {len(found['lane_scan'])} lane-scan kernels")
    gemm_log = logs.get("pim_gemm.cu", "")
    gemv_log = logs.get("pim_gemv.cu", "")
    for name, log, pattern, want, params in (
            ("pim_gemm_fp", gemm_log, r"gemm_fp_mma_kernel", 4, "XBYTES, NT"),
            ("pim_gemm_int", gemm_log, r"gemm_int_mma_kernel", 8,
             "WBITS, XBYTES, NT"),
            ("pim_gemv_int", gemv_log, r"gemv_int_rows_kernel", 6,
             "WBITS, XBYTES, R")):
        found[name] = ptxas_kernels(log, pattern)
        for k in found[name]:
            print(f"    ptxas {k['name']} ({params}): {k['registers']} "
                  f"registers, {k['spill_bytes']} spill bytes")
        check(not log or len(found[name]) == want,
              f"ptxas reported {len(found[name])} vector {name} kernels, "
              f"not {want}")
    return found


def lane_scan_alone(dev, sm_mhz: float) -> dict:
    """Phase 2: the lane-scan kernel timed at the main path's launches,
    and beside its plain version on one Fig-4 point's PIM lanes."""
    from repro_torch.configs import granite_8b
    from repro_torch.core import engine
    from repro_torch.core.pimsim import PimSimulator
    from repro_torch.kernels import lane_scan
    from repro_torch.pimkernel.executor import GemvRequest, PimExecutor
    from repro_torch.pimkernel.tileconfig import ALL_DTYPES, PimDType
    from repro_torch.serving.offload import OffloadPlanner

    launched: dict = {"fig4_sweep": [], "granite_8b_decode": []}
    real_scan = lane_scan.lane_scan
    part = ""

    def recording_scan(*args, **kw):
        launched[part].append((args, kw))
        return real_scan(*args, **kw)

    lane_scan.lane_scan = recording_scan
    engine.lane_cache_reset()
    try:
        part = "fig4_sweep"
        sim = PimSimulator(device=dev)
        for axis in ("activation", "output"):
            sim.sweep([512, 1024, 2048, 4096, 8192], ALL_DTYPES, axis=axis)
        part = "granite_8b_decode"
        OffloadPlanner(granite_8b.CONFIG,
                       sim=PimSimulator(device=dev)).decode_speedup(1)
    finally:
        lane_scan.lane_scan = real_scan
    torch.cuda.synchronize()

    def bound(args, need_issue: bool) -> tuple[float, str]:
        lengths = args[2]
        bytes_ms = (peaks.lane_scan_bytes(lengths.tolist(), need_issue)
                    / peaks.HBM_BYTES_PER_S * 1e3)
        chain_ms = (int(lengths.max()) * CHAIN_CYCLES_PER_STEP
                    / (sm_mhz * 1e6) * 1e3)
        return max(bytes_ms, chain_ms), ("operations" if chain_ms
                                         >= bytes_ms else "bytes")

    fleets = {}
    for p, runs in launched.items():
        check(bool(runs), f"{p} launched no lane scan")
        ms = bound_ms = 0.0
        spread = [0.0, 0.0]
        by = "operations"
        for args, kw in runs:
            t = timed_ms({"kernel": lambda: real_scan(*args, **kw)},
                         LANE_REPS)["kernel"]
            ms += t["ms"]
            spread = [spread[0] + t["min_ms"], spread[1] + t["max_ms"]]
            b, by = bound(args, kw.get("need_issue", True))
            bound_ms += b
        fleets[p] = dict(
            launches=len(runs), ms=ms, spread=spread, launches_timed=LANE_REPS,
            bound_ms=bound_ms, bound_by=by,
            lanes=sum(int(a[2].shape[0]) for a, _ in runs),
            commands=sum(int(a[2].sum()) for a, _ in runs),
            longest_lane=max(int(a[2].max()) for a, _ in runs))
        print(f"[2] {p}: {json.dumps(fleets[p])}")

    # The PIM streams of one Fig-4 point (512 x 4096 W8A8, ~8k commands
    # per channel: the plain side stays short enough for the card).
    fig4 = PimExecutor(device=dev).plan_many(
        [GemvRequest.pim(512, 4096, PimDType.W8A8)])[0]
    cu = [x.to(dev) for x in engine.pack_lanes([(fig4.ctx.cyc, s)
                                                for s in fig4.streams])]
    plain_ms = timed_ms({"plain": lambda: lane_scan.lane_scan_plain(
        *cu, 16, need_issue=False)}, 1)["plain"]["ms"]
    kernel_ms = timed_ms({"kernel": lambda: lane_scan.lane_scan(
        *cu, 16, need_issue=False)}, 9)["kernel"]["ms"]
    steps = int(cu[2].max())
    print(f"[2] Fig-4 PIM lanes ({cu[2].shape[0]} x {steps} steps): plain "
          f"{plain_ms:.1f} ms, kernel {kernel_ms:.3f} ms")
    return dict(fleets=fleets, plain_ms=plain_ms,
                kernel_ms_on_plain_inputs=kernel_ms,
                plain_on=f"Fig-4 PIM 512x4096 W8A8 lanes ({steps} steps)")


def pim_tiles_alone(dev, mods: dict, plain: dict) -> dict:
    """Phase 3: one granite-8b layer plus ``lm_head`` through
    ``pim_linear`` on the card, every call's operands kept; then each
    kernel timed on them."""
    from repro_torch.kernels import ops, pim_gemv
    from repro_torch.pimkernel.tileconfig import ALL_DTYPES

    fixture = json.loads((ROOT / "tests/golden/torch_pim_linear.json")
                         .read_text())
    heavy: dict = {}
    gemv_calls: dict = {}
    now: dict = {}

    def keep(name, out, args, kw):
        if now["site"] == "lm_head":
            heavy[(name, now["dtype"])] = (out, args, kw)
        if name == "pim_gemv_int":
            gemv_calls[(now["site"], now["dtype"])] = (out, args, kw)

    before = torch_card.launch_counts()
    real = torch_card.patch_pim_kernels(mods, keep)
    try:
        for index, site in enumerate(fixture["sites"]):
            wts, acts = torch_card.site_inputs(fixture["seed"], index,
                                               site["h"], site["w"])
            wd = torch.from_numpy(wts).to(dev)
            xd = torch.from_numpy(acts).to(dev)
            for dtype in ALL_DTYPES:
                now.update(site=site["name"], dtype=dtype.name)
                qw = ops.prepare_weights(wd, dtype, device=dev)
                ops.pim_linear(xd[0], qw)
                if site["name"] == "lm_head":
                    ops.pim_linear(xd, qw)
    finally:
        torch_card.restore_pim_kernels(mods, real)
    torch.cuda.synchronize()
    launches = {k: v - before.get(k, 0)
                for k, v in torch_card.launch_counts().items()
                if k.startswith("pim_") and v != before.get(k, 0)}
    print(f"[3] pim_linear over {len(fixture['sites'])} sites x "
          f"{len(ALL_DTYPES)} dtypes: launches {json.dumps(launches)}")
    check(len(gemv_calls) == 40, f"{len(gemv_calls)} int GEMV launches")

    sites = gemv_int_sites(
        real["pim_gemv_int"], gemv_calls,
        lambda args, kw: pim_gemv.gemv_int_variant(args[0], args[1],
                                                   kw["w_bits"]))
    mma_b1 = mma_at_batch_1(real["pim_gemv_int"], gemv_calls)
    # The protocol's floor: a 1 x 32 W8A8 GEMV, whose bytes take
    # nanoseconds (x_scale on the card, as pim_linear gives it).
    args = (torch.ones((1, 32), dtype=torch.int8, device=dev),
            torch.ones(32, dtype=torch.int8, device=dev),
            torch.ones(1, device=dev), torch.ones((), device=dev))
    floor = timed_ms({"kernel": lambda: real["pim_gemv_int"](*args)},
                     KERNEL_REPS)["kernel"]
    print(f"[3] pim_gemv_int floor, 1 x 32 W8A8: {json.dumps(floor)}")
    sites["floor"] = floor
    timed = {}
    for (name, dtype), (out, args, kw) in sorted(heavy.items()):
        timed[(name, dtype)] = time_kernel(name, dtype, real[name],
                                           plain[name], out, args, kw)
    # The int GEMM at batch 16 (two N tiles per pass): lm_head's W8A8
    # operands with 8 more activation rows.
    out, args, kw = heavy[("pim_gemm_int", "W8A8")]
    args = (args[0], torch.cat([args[1], args[1].roll(1, dims=1)]),
            *args[2:])
    out = real["pim_gemm_int"](*args, **kw)
    timed[("pim_gemm_int", "W8A8/b16")] = time_kernel(
        "pim_gemm_int", "W8A8", real["pim_gemm_int"], plain["pim_gemm_int"],
        out, args, kw)
    return dict(timed=timed, gemv_int_sites=sites, mma_at_batch_1=mma_b1,
                launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import lane_scan, pim_gemm, pim_gemv

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = smi("name,power.limit")
    print(card)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"card: {torch.cuda.get_device_name(0)}, max SM clock {sm_mhz} "
          f"MHz, torch {torch.__version__}, CUDA {torch.version.cuda}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32: the fp plain versions need "
          "full float32")

    ptxas = build(lane_scan)                                        # 1
    lanes = lane_scan_alone(dev, sm_mhz)                            # 2
    mods = {"pim_gemv_int": pim_gemv, "pim_gemv_fp": pim_gemv,
            "pim_gemm_int": pim_gemm, "pim_gemm_fp": pim_gemm}
    plain = {name: getattr(mod, f"{name}_plain") for name, mod in mods.items()}
    tiles = pim_tiles_alone(dev, mods, plain)                       # 3

    main_fleet = lanes["fleets"]["granite_8b_decode"]
    entries = [{
        "name": "lane_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lane_scan.cu",
        "replaces": "src/repro/kernels/lane_scan.py:49",
        "launches": sum(f["launches"] for f in lanes["fleets"].values()),
        "ms": main_fleet["ms"], "plain_ms": lanes["plain_ms"],
        "bound_ms": main_fleet["bound_ms"],
        "bound_by": main_fleet["bound_by"], "library_ms": None,
        "ms_on": "granite-8b decode_speedup fleet, LRU cold",
        "plain_on": lanes["plain_on"],
        "kernel_ms_on_plain_inputs": lanes["kernel_ms_on_plain_inputs"],
        "fleets": lanes["fleets"], "ptxas": ptxas["lane_scan"]}]
    headline = {"pim_gemv_int": "W8A8", "pim_gemv_fp": "FP_W8A8",
                "pim_gemm_int": "W8A8", "pim_gemm_fp": "FP_W8A8"}
    for name, (replaces, source) in PIM_KERNELS.items():
        by_dtype = {d: t for (n, d), t in tiles["timed"].items() if n == name}
        head = by_dtype[headline[name]]
        variants = {k.rsplit(".", 1)[1]: v
                    for k, v in tiles["launches"].items()
                    if k.startswith(f"{name}.launches.")}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(v for k, v in tiles["launches"].items()
                            if k.startswith(f"{name}.")),
            "max_abs_err": max(t["max_abs_err"] for t in by_dtype.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "ms_on": f"lm_head 49152x4096 {headline[name]}, batch "
                     f"{head['batch']}; median of {KERNEL_REPS} launches, L2 "
                     f"flushed before each, in turns with the library call",
            "library_on": ("torch._int_mm, batch padded to 32"
                           if name.endswith("_int")
                           else "torch._scaled_mm, unit scales, batch "
                                "padded to 16"),
            "by_dtype": by_dtype,
            **({"variants": variants} if variants else {}),
            **({"ptxas": ptxas[name]} if name in ptxas else {}),
            **({"sites": {k: v for k, v in tiles["gemv_int_sites"].items()
                          if k != "sites"},
                "mma_at_batch_1": tiles["mma_at_batch_1"]}
               if name == "pim_gemv_int" else {})})
    print(card)
    print(json.dumps({"kernels": entries}))
    del lanes, tiles
    _FLUSH.clear()
    gc.collect()
    torch.cuda.empty_cache()
    sys.stdout.flush()                                              # 4
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    return subprocess.run([sys.executable, "-m", "pytest", "-q",
                           "--noconftest", "-m", "gpu",
                           "tests/test_torch_gpu.py"], cwd=ROOT,
                          env=env).returncode


if __name__ == "__main__":
    sys.exit(main())

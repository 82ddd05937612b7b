"""The port on the card: each test mirrors a phase of ``chip_smoke.py``.

Every test here is marked ``gpu`` and skips itself when no CUDA device
is present (decided inside the test, never at import).  The file imports
only torch, numpy and ``repro_torch`` — no JAX — so it also runs where
JAX is not installed; the pinned numbers come from the goldens the JAX
package wrote.  On a machine with a card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's ``conftest.py`` imports the JAX package.)
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, granite_8b, smoke_config
from repro_torch.core import commands as C
from repro_torch.core import engine, faults
from repro_torch.core.engine_ref import RefEngine
from repro_torch.core.pimsim import PimSimulator
from repro_torch.core.timing import (DEFAULT_SYSTEM, LpddrTimings, PimSpec,
                                     SystemSpec)
from repro_torch.kernels import lane_scan, ops, pim_gemm, pim_gemv, ref
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.pimkernel.executor import (FunctionalGemv, GemvRequest,
                                            PimExecutor)
from repro_torch.pimkernel.tileconfig import ALL_DTYPES, PimDType
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import OffloadPlanner
from repro_torch.serving.chaos import make_chaos_timeline, run_chaos_scenario
from repro_torch.serving.scenarios import (DisaggConfig, ScenarioSpec,
                                           assign_slo, make_scenario,
                                           replay_trace, run_policy_over_trace,
                                           run_scenario)

GOLDEN = pathlib.Path(__file__).parent / "golden"
ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_SPECS = {"lp5x-9600": DEFAULT_SYSTEM,
                "rcd24-mac2": SystemSpec(timings=LpddrTimings(tRCD=24.0),
                                         pim=PimSpec(mac_interval_ck=2))}

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    engine.lane_cache_reset()
    yield torch.device("cuda", 0)
    engine.lane_cache_reset()


def record(res) -> dict:
    return json.loads(json.dumps(dict(
        cycles=res.cycles, ns=res.ns, flops=res.flops,
        weight_bytes=res.weight_bytes, utilization=res.utilization,
        split=res.split, counts=[int(c) for c in res.counts],
        energy=res.energy)))


def kernel_equals_plain(cycs, streams, lengths, nb, dev):
    args = (cycs.to(dev), streams.to(dev), lengths.to(dev), nb)
    for need_issue in (True, False):
        before = lane_scan.LAUNCHES
        ik, tk = lane_scan.lane_scan(*args, need_issue=need_issue)
        assert lane_scan.LAUNCHES == before + 1
        ip, tp = lane_scan.lane_scan_plain(*args, need_issue=need_issue)
        assert torch.equal(tk, tp)
        if need_issue:
            assert torch.equal(ik, ip)
        else:
            assert ik is None


def ragged(block: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The ragged slab of an ``(F, N, 4)`` block: each lane's first
    ``lengths[f]`` commands, end to end."""
    return block[np.arange(block.shape[1])[None, :] < lengths[:, None]]


def fuzzed(nb: int, f: int, n: int, seed: int):
    """Random timing rows (some large enough to wrap int32) and a ragged
    slab of lanes of random lengths up to ``n`` (zero-length ones among
    them), with out-of-range opcodes and banks."""
    rng = np.random.default_rng(seed)
    cycs = rng.integers(0, 64, size=(f, len(lane_scan.CYC_FIELDS)))
    cycs = np.where(rng.random(cycs.shape) < 0.03,
                    (1 << 30) + rng.integers(0, 1 << 20, cycs.shape), cycs)
    streams = rng.integers(0, 128, size=(f, n, 4))
    streams[..., 0] = np.where(rng.random((f, n)) < 0.05,
                               rng.integers(-40, 60, (f, n)),
                               rng.integers(0, 17, (f, n)))
    streams[..., 1] = np.where(rng.random((f, n)) < 0.05,
                               rng.integers(-2 * nb, 3 * nb, (f, n)),
                               rng.integers(0, nb, (f, n)))
    lengths = rng.integers(0, n + 1, size=f)
    lengths[rng.random(f) < 0.1] = 0
    return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
                 for x in (cycs, ragged(streams, lengths), lengths))


@pytest.mark.parametrize("nb", lane_scan.SUPPORTED_BANKS)
def test_kernel_matches_plain_fuzzed(dev, nb):
    kernel_equals_plain(*fuzzed(nb, 24, 128, seed=nb), nb, dev)


@pytest.mark.parametrize("bankgroups", [2, 3, 4])
def test_kernel_matches_plain_probe_lane(dev, bankgroups):
    spec = SystemSpec(timings=LpddrTimings(num_bankgroups=bankgroups))
    nb = spec.timings.num_banks
    probe = lane_scan.probe_stream(nb)
    kernel_equals_plain(engine.pack_cycles([spec.derive_cycles()]), probe,
                        torch.tensor([16], dtype=torch.int32), nb, dev)


def test_kernel_matches_plain_on_pim_streams(dev):
    planned = PimExecutor(device=dev).plan_many(
        [GemvRequest.pim(256, 2048, PimDType.W8A16, fence=True)])[0]
    kernel_equals_plain(*engine.pack_lanes([(planned.ctx.cyc, s)
                                            for s in planned.streams]),
                        16, dev)


EDGE_LENGTHS = (0, 1, 31, 32, 33, 63, 64, 65)   # around the 32-command chunks
EDGE_N = 70
EDGE_OPS = (-1, -5, -16, -17, -40, 17, 18, 33, 60)   # out of range
# Fields set near -2**31 in the wrapping rows.  A command that adds one
# to a small cycle lands far below NEG; two such terms added wrap.  The
# opening of each wrapping lane (reads, PREA, FENCE, MODE) drives every
# term of t0 and every bank's ready_act below NEG, so the REFAB and PREA
# after it issue below NEG, where a reduction whose idle threads held NEG
# would differ.
WRAP_FIELDS = ("cRP", "cRFC", "cMODE", "cACT", "cPRE", "cCAS", "cFENCE",
               "cMACCMD")
WRAP_OPENING = ((1, 0), (4, 0), (4, 1), (5, 2), (3, 0), (16, 0), (7, 0),
                (6, 0), (3, 0))


def edge_banks(nb: int) -> tuple:
    """Raw banks that index no bank (read at their clamped index, written
    nowhere) or, 4..7, no ACT_MB quad."""
    return (-1, -nb - 1, 4, 5, 6, 7, nb, 100)


def edge_lanes(nb: int, seed: int):
    """A ragged slab of lanes of every length in ``EDGE_LENGTHS``, twice:
    under small random timings, and under timings whose ``WRAP_FIELDS``
    are near -2**31.  The streams mix
    valid opcodes with ``EDGE_OPS`` and in-range banks with
    :func:`edge_banks`; each wrapping lane opens with
    ``WRAP_OPENING``."""
    rng = np.random.default_rng([nb, seed])
    f = 2 * len(EDGE_LENGTHS)
    cycs = rng.integers(0, 9, size=(f, len(lane_scan.CYC_FIELDS)))
    for name in WRAP_FIELDS:
        j = lane_scan.CYC_FIELDS.index(name)
        cycs[len(EDGE_LENGTHS):, j] = -(1 << 31) + rng.integers(
            1, 64, len(EDGE_LENGTHS))
    streams = rng.integers(0, 128, size=(f, EDGE_N, 4))
    streams[..., 0] = rng.choice(
        [*range(17), 6, 3, 10, 13, 9] + list(EDGE_OPS), size=(f, EDGE_N))
    streams[..., 1] = np.where(rng.random((f, EDGE_N)) < 0.3,
                               rng.choice(edge_banks(nb), (f, EDGE_N)),
                               rng.integers(0, nb, (f, EDGE_N)))
    streams[len(EDGE_LENGTHS):, :len(WRAP_OPENING), :2] = WRAP_OPENING
    lengths = np.array(EDGE_LENGTHS * 2)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
                 for x in (cycs, ragged(streams, lengths), lengths))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("nb", [4, 32])
def test_kernel_matches_plain_at_chunk_and_warp_edges(dev, nb, seed):
    """The warp kernel at its edges: lengths around each 32-command
    chunk, 4 banks (28 threads without a bank) and 32 (the full warp),
    banks and opcodes out of range, and timings that wrap far below NEG,
    where a reduction whose idle threads held NEG would differ."""
    kernel_equals_plain(*edge_lanes(nb, seed), nb, dev)


@pytest.mark.parametrize("nb", [8, 16])
def test_kernel_matches_plain_on_ragged_slabs(dev, nb):
    """Ragged slabs as the engine packs them: zero-length lanes between
    long and 1-command ones, the longest last, and a mesh shard padded to
    its width with zero-length rows of its first lane's timing row."""
    rng = np.random.default_rng(nb)
    cycs, _s, _l = fuzzed(nb, 6, 8, seed=nb)
    lens = [0, 1, 200, 0, 0, 33, 1, 0, 400]
    block = rng.integers(0, 17, size=(len(lens), max(lens), 4))
    block[..., 1] = rng.integers(0, nb, size=block.shape[:2])
    rows = cycs[rng.integers(0, cycs.shape[0], len(lens)).tolist()]
    lengths = torch.tensor(lens, dtype=torch.int32)
    slab = torch.from_numpy(ragged(block, np.array(lens)).astype(np.int32))
    kernel_equals_plain(rows.contiguous(), slab, lengths, nb, dev)
    width = 16                  # a mesh shard: 9 lanes, then 7 padding rows
    pad = width - len(lens)
    kernel_equals_plain(torch.cat([rows, rows[:1].expand(pad, -1)]),
                        slab, torch.cat([lengths, lengths.new_zeros(pad)]),
                        nb, dev)


def test_kernel_matches_plain_past_2_24_commands(dev):
    """A slab of more than 2**24 commands (16.9 M in ~16.5 k lanes of
    ~1 k): every lane's start is summed in the kernel in long long."""
    f = 16_500
    rng = np.random.default_rng(24)
    lengths = rng.integers(960, 1089, size=f)
    assert lengths.sum() > 1 << 24
    cycs = rng.integers(0, 64, size=(f, len(lane_scan.CYC_FIELDS)))
    block = rng.integers(0, 17, size=(f, int(lengths.max()), 4),
                         dtype=np.int32)
    block[..., 1] %= 16
    kernel_equals_plain(
        *(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
          for x in (cycs, ragged(block, lengths), lengths)), 16, dev)


def test_launch_rejects_bad_inputs_on_card(dev):
    cycs, streams, lengths = (x.to(dev) for x in fuzzed(16, 2, 8, seed=0))
    with pytest.raises(ValueError, match="num_banks"):
        lane_scan.lane_scan(cycs, streams, lengths, 10)
    with pytest.raises(ValueError, match="on cpu"):
        lane_scan.lane_scan(cycs.cpu(), streams, lengths, 16)


def test_fleet_parity_golden_exact(dev):
    fixture = json.loads((GOLDEN / "fleet_parity.json").read_text())
    reqs = []
    for label in fixture:
        sname, rest = label.split("/")
        kind, shape, dt, *flags = rest.split("-")
        h, w = (int(v) for v in shape.split("x"))
        sp = GOLDEN_SPECS[sname]
        reqs.append(GemvRequest.pim(h, w, dt, fence="fence" in flags,
                                    reshape="reshape" in flags, spec=sp)
                    if kind == "pim"
                    else GemvRequest.baseline(h, w, dt, spec=sp))
    got = PimExecutor(device=dev).run_many(reqs)
    assert {k: record(r) for k, r in zip(fixture, got)} == fixture


def test_points_fixture_reproduced_at_full_width(dev):
    points = json.loads((GOLDEN / "torch_port_points.json").read_text())
    sim = PimSimulator(device=dev)
    got = {}
    for label in points["quickstart"]:
        kind, shape, dt, *flags = label.split("-")
        h, w = (int(v) for v in shape.split("x"))
        got[label] = record(
            sim.gemv(h, w, dt, fence="fence" in flags,
                     reshape="reshape" in flags)
            if kind == "pim" else sim.baseline(h, w, dt))
    assert got == points["quickstart"]
    planner = OffloadPlanner(granite_8b.CONFIG, sim=sim)
    plan = [dict(site=d.site.name, h=d.site.h, w=d.site.w,
                 count=d.site.count, pim_ns=d.pim_ns, host_ns=d.host_ns,
                 reshape=d.reshape,
                 offload_below_batch=d.offload_below_batch)
            for d in planner.plan()]
    assert json.loads(json.dumps(plan)) == points["granite_8b_plan"]
    assert (json.loads(json.dumps(planner.decode_speedup(batch=1)))
            == points["granite_8b_decode_speedup_b1"])


def test_main_path_goes_through_the_kernel(dev):
    """A sweep, a functional GEMV and a replan with the LRU cold launch
    the kernel; the warm replan launches nothing."""
    sim = PimSimulator(device=dev)
    before = lane_scan.LAUNCHES
    surf = sim.sweep([512, 1024], ALL_DTYPES, axis="output")
    assert lane_scan.LAUNCHES > before
    assert all(np.isfinite(v).all() and min(v) > 0 for v in surf.values())
    rng = np.random.default_rng(0)
    item = FunctionalGemv(rng.integers(-8, 8, (96, 700)).astype(np.int32),
                          rng.integers(-8, 8, (700,)).astype(np.int32),
                          PimDType.W4A8)
    (y, _res), = sim.gemv_functional_many([item])
    np.testing.assert_array_equal(
        y, item.weights.astype(np.int64) @ item.x.astype(np.int64))
    planner = OffloadPlanner(granite_8b.CONFIG, sim=sim)
    planner.plan()
    warm = lane_scan.LAUNCHES
    planner.invalidate()
    planner.plan()
    assert lane_scan.LAUNCHES == warm


def every_opcode_stream(rng, nb: int) -> np.ndarray:
    """A valid stream that issues all 17 opcodes, in seeded amounts."""
    b = C.StreamBuilder()
    for _ in range(3):
        bank, row = int(rng.integers(0, nb)), int(rng.integers(0, 64))
        b.emit(C.NOP)
        b.emit(C.ACT, bank, row)
        b.emit_repeat(C.RD, int(rng.integers(1, 5)), a=bank, b=row)
        b.emit_repeat(C.WR, int(rng.integers(1, 3)), a=bank, b=row)
        b.emit(C.PRE, bank)
        b.emit(C.PREA)
        b.emit(C.REFAB)
        b.emit(C.MODE_MB)
        b.emit(C.WR_IRF)
        for q in range(4):
            b.emit(C.ACT_MB, q, int(rng.integers(0, 64)))
        b.emit_repeat(C.WR_SRF, int(rng.integers(1, 4)), a=0, b=0)
        b.emit_repeat(C.MAC, int(rng.integers(1, 6)), c_start=0)
        b.emit(C.FENCE)
        b.emit(C.MOV_ACC)
        b.emit_repeat(C.RD_ACC, int(rng.integers(1, 3)),
                      a=int(rng.integers(0, nb)))
        b.emit(C.PRE_MB)
        b.emit(C.MODE_SB)
    return b.build()


@pytest.mark.parametrize("bankgroups", [2, 3, 4])
def test_ref_engine_matches_kernel_on_every_opcode(dev, bankgroups):
    """The port's oracle (``RefEngine``, numpy) against the kernel: issue
    arrays and totals of short valid streams of every opcode, and of a
    fenced PIM GEMV's channels."""
    spec = SystemSpec(timings=LpddrTimings(num_bankgroups=bankgroups))
    cyc = spec.derive_cycles()
    rng = np.random.default_rng(bankgroups)
    streams = [every_opcode_stream(rng, cyc.num_banks) for _ in range(6)]
    assert set(np.concatenate([s[:, 0] for s in streams])) \
        == set(range(C.NUM_OPCODES))
    if bankgroups == 4:
        streams += list(PimExecutor(device=dev).plan_many(
            [GemvRequest.pim(256, 2048, PimDType.W8A16, fence=True)])[0]
            .streams)
    cycs, packed, lengths = engine.pack_lanes([(cyc, s) for s in streams])
    iss, tot = lane_scan.lane_scan(cycs.to(dev), packed.to(dev),
                                   lengths.to(dev), cyc.num_banks)
    iss, tot = iss.cpu().numpy(), tot.cpu().numpy()
    at = 0
    for row, s in enumerate(streams):
        iss_ref, tot_ref = RefEngine(cyc).run(s)
        np.testing.assert_array_equal(iss[at:at + len(s)].astype(np.int64),
                                      iss_ref)
        assert int(tot[row]) == tot_ref
        at += len(s)


@pytest.mark.parametrize("name", ["serve_trace", "disagg_trace",
                                  "spec_decode_trace"])
def test_serving_golden_controller_at_full_width(dev, name):
    """The goldens' controller report and per-step records, re-derived
    by the port's planner at full granite-8b width through the kernel."""
    fixture = json.loads((GOLDEN / f"{name}.json").read_text())
    planner = OffloadPlanner(ARCHS["granite-8b"], device=dev)
    before = lane_scan.LAUNCHES
    c = run_policy_over_trace(planner, fixture["policy"],
                              fixture["per_tick_batch"],
                              fence=fixture["fence"])
    assert lane_scan.LAUNCHES > before
    assert json.loads(json.dumps(c.report())) == fixture["controller"]
    assert (json.loads(json.dumps([r.to_record() for r in c.trace]))
            == fixture["per_step"])


# ---------------------------------------------------------------------
# The PIM-tile kernels (chip_smoke.py phases 6 and 7)
# ---------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PIM = {"pim_gemv_int": pim_gemv, "pim_gemv_fp": pim_gemv,
       "pim_gemm_int": pim_gemm, "pim_gemm_fp": pim_gemm}


def held_to_plain(name, *args, **kw):
    """Launch one wrapper on the card (counted once) and hold it to its
    plain version: int bit-equal, fp within the f32 sum bound."""
    mod = PIM[name]
    before = mod.LAUNCHES[name]
    out = getattr(mod, name)(*args, **kw)
    assert mod.LAUNCHES[name] == before + 1
    want = getattr(mod, f"{name}_plain")(*args, **kw)
    torch.cuda.synchronize()
    _chip_smoke().pim_error(name, out, want, args)
    return out


def through_pim_linear(x, qw):
    """``pim_linear`` on the card, each kernel call held to its plain
    version on the operands pim_linear handed it."""
    smoke = _chip_smoke()
    calls = []

    def hold(name, out, args, kw):
        want = getattr(PIM[name], f"{name}_plain")(*args, **kw)
        smoke.pim_error(name, out, want, args)
        calls.append(name)

    real = smoke.patch_pim_kernels(PIM, hold)
    try:
        y = ops.pim_linear(x, qw)
    finally:
        smoke.restore_pim_kernels(PIM, real)
    assert len(calls) == 1
    return y


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: d.name)
@pytest.mark.parametrize("h,w", [(130, 258), (256, 4096), (37, 1000)])
def test_pim_kernels_match_plain_through_pim_linear(dev, dtype, h, w):
    rng = np.random.default_rng(h + w)
    wd = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32))
    xd = torch.from_numpy(rng.standard_normal((9, w)).astype(np.float32))
    qw = ops.prepare_weights(wd.to(dev), dtype, device=dev)
    for x in (xd[0], xd[:1], xd[:3], xd[:8], xd):
        before = {name: mod.LAUNCHES[name] for name, mod in PIM.items()}
        y = through_pim_linear(x.to(dev), qw)
        assert y.shape == ((h,) if x.dim() == 1 else (x.shape[0], h))
        assert sum(mod.LAUNCHES[name] - before[name]
                   for name, mod in PIM.items()) == 1


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("x_dtype", [torch.int8, torch.int16])
def test_int_extremes_and_misaligned_views_on_card(dev, w_bits, x_dtype):
    """Every int4 nibble / int8 byte against int8/int16 extremes, on
    aligned operands (vector loads) and misaligned views (byte-wise)."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(w_bits)
    wq = (torch.stack([torch.randperm(256, generator=gen)
                       for _ in range(16)]) - 128).to(torch.int8).to(dev)
    width = 256 * (2 if w_bits == 4 else 1)
    info = torch.iinfo(x_dtype)
    xb = torch.randint(info.min, info.max + 1, (9, width), generator=gen)
    xb[:, :4] = torch.tensor([info.min, info.max, -1, 0])
    xb = xb.to(x_dtype).to(dev)
    ws = torch.linspace(0.5, 2.0, 16, device=dev)
    for wop, xop in ((wq, xb), (smoke.misaligned(wq), smoke.misaligned(xb))):
        held_to_plain("pim_gemv_int", wop, xop[0], ws, 0.37, w_bits=w_bits)
        held_to_plain("pim_gemm_int", wop, xop, ws, 0.37, w_bits=w_bits)


def test_int32_wraparound_on_card(dev):
    qw = ops.prepare_weights(torch.full((8, 16384), 0.5, device=dev),
                             "W8A16", device=dev)
    x = torch.full((16384,), 3.0, device=dev)
    ws = pim_gemv.row_scale(qw.scale, ref.quantize_acts(x, 16)[1])
    want = torch.tensor(-538951680.0, device=dev) * ws
    assert torch.equal(ops.pim_linear(x, qw), want)
    assert torch.equal(ops.pim_linear(torch.stack([x, x]), qw)[1], want)
    # A B = 8 GEMM on the tensor-core kernel: 127 * 32767 * 16384 wraps
    # where the byte planes' sums are combined.
    xb = torch.full((8, 16384), 32767, dtype=torch.int16, device=dev)
    assert pim_gemm.int_variant(qw.q, xb) == "mma"
    variants = dict(pim_gemm.INT_VARIANT_LAUNCHES)
    out = pim_gemm.pim_gemm_int(qw.q, xb, qw.scale, 1.0)
    assert pim_gemm.INT_VARIANT_LAUNCHES == dict(
        variants, mma=variants["mma"] + 1)
    assert torch.equal(out, torch.tensor(-538951680.0, device=dev)
                       * qw.scale[None].expand(8, 8))
    # W8A8 over 1.5 M columns: every warp's share passes 2^31 inside the
    # MMA's own s32 accumulators, which must wrap, not saturate.
    wq = torch.full((16, 3 << 19), 127, dtype=torch.int8, device=dev)
    xq = torch.full((8, 3 << 19), -128, dtype=torch.int8, device=dev)
    ws = torch.ones(16, device=dev)
    assert pim_gemm.int_variant(wq, xq) == "mma"
    out = held_to_plain("pim_gemm_int", wq, xq, ws, 1.0)
    assert bool((out == float(-127 * 128 * (3 << 19) % (1 << 32))).all())


@pytest.mark.parametrize("dtype", ["FP_W8A8", "FP_W8A16"])
def test_fp8_nan_and_saturation_on_card(dev, dtype):
    rng = np.random.default_rng(7)
    wf = rng.standard_normal((40, 64)).astype(np.float32)
    wf[:, 0], wf[3], wf[5, 1] = 448.0, -448.0, 1000.0
    xf = rng.standard_normal((6, 64)).astype(np.float32)
    xf[1, 2], xf[2, 3], xf[3, 4] = 464.0, 464.01, -1000.0
    xf[4, 5], xf[5, 6] = np.inf, np.nan
    qw = ops.prepare_weights(torch.from_numpy(wf).to(dev), dtype,
                             device=dev)
    cpu = ops.prepare_weights(wf, dtype, device="cpu")
    assert torch.equal(qw.q.view(torch.uint8).cpu(), cpu.q.view(torch.uint8))
    for x in (xf, xf[1], xf[3]):
        y = through_pim_linear(torch.from_numpy(x).to(dev), qw)
        assert torch.equal(y.isnan().cpu(),
                           ops.pim_linear(torch.from_numpy(x), cpu).isnan())


def fp_gemm_operands(rng, b, h, w, x_dtype, dev):
    """fp8 weights (H, W) and fp8 / bf16 activations (B, W) with a +-448
    weight row, a NaN weight, and a NaN and a +-448 activation."""
    wf = rng.standard_normal((h, w)).astype(np.float32) * 3.0
    wf[h // 2] = np.where(np.arange(w) % 2, 448.0, -448.0)
    if h > 2:
        wf[h - 1, w // 2] = np.nan
    xf = rng.standard_normal((b, w)).astype(np.float32) * 3.0
    xf[b - 1, w - 1] = np.nan
    xf[0, 0] = 448.0 if b > 1 else xf[0, 0]
    w8 = ref.to_e4m3fn(torch.from_numpy(wf)).to(dev)
    xt = torch.from_numpy(xf)
    x = (ref.to_e4m3fn(xt) if x_dtype == torch.float8_e4m3fn
         else xt.to(x_dtype)).to(dev)
    return w8, x


@pytest.mark.parametrize("w", [16, 48, 64, 4128, 4096])
@pytest.mark.parametrize("x_dtype", [torch.float8_e4m3fn, torch.bfloat16],
                         ids=["fp8", "bf16"])
def test_gemm_fp_tensor_core_edges(dev, x_dtype, w):
    """The tensor-core fp GEMM against its plain version on every edge
    of its tiles: batch rows past 8 and 16, weight rows past 16 and 32,
    widths that are not multiples of the 128-column span, NaN and +-448;
    aligned operands take the MMA variant, misaligned views the
    byte-wise one."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(w)
    for b in (1, 2, 7, 8, 9, 17):
        for h in (1, 15, 16, 17, 130):
            w8, x = fp_gemm_operands(rng, b, h, w, x_dtype, dev)
            variants = dict(pim_gemm.FP_VARIANT_LAUNCHES)
            assert pim_gemm.fp_variant(w8, x) == "mma"
            out = pim_gemm.pim_gemm_fp(w8, x)
            assert pim_gemm.FP_VARIANT_LAUNCHES == dict(
                variants, mma=variants["mma"] + 1)
            want = pim_gemm.pim_gemm_fp_plain(w8, x)
            torch.cuda.synchronize()
            smoke.pim_error("pim_gemm_fp", out, want, (w8, x))
            assert out.isnan().any()               # the NaN reached it
    if x_dtype == torch.bfloat16:
        # Activations from 2**-124 down into bf16's subnormals (the last
        # batch row all subnormal), so that many products, and the last
        # row's sums, are f32 subnormals inside the MMA's sums.
        for b, h in ((1, 17), (9, 130)):
            wf = rng.standard_normal((h, w)).astype(np.float32) * 3.0
            xf = rng.standard_normal((b, w)) * 2.0 ** -(124 + np.arange(w)
                                                        % 8)
            xf[b - 1] *= 2.0 ** -8
            w8 = ref.to_e4m3fn(torch.from_numpy(wf)).to(dev)
            x = torch.from_numpy(xf.astype(np.float32)).to(torch.bfloat16)
            prods = x.float()[:, None, :] * w8.cpu().float()[None]
            assert bool(((prods != 0) & (prods.abs() < 2.0 ** -126)).any())
            x = x.to(dev)
            assert pim_gemm.fp_variant(w8, x) == "mma"
            out = pim_gemm.pim_gemm_fp(w8, x)
            want = pim_gemm.pim_gemm_fp_plain(w8, x)
            torch.cuda.synchronize()
            assert bool((want[b - 1] != 0).any())  # the plain sums keep them
            smoke.pim_error("pim_gemm_fp", out, want, (w8, x))
    w8, x = fp_gemm_operands(rng, 9, 17, w, x_dtype, dev)
    w8, x = smoke.misaligned(w8), smoke.misaligned(x)
    variants = dict(pim_gemm.FP_VARIANT_LAUNCHES)
    assert pim_gemm.fp_variant(w8, x) == "bytes"
    held_to_plain("pim_gemm_fp", w8, x)
    assert pim_gemm.FP_VARIANT_LAUNCHES == dict(
        variants, bytes=variants["bytes"] + 1)


INT_FORMATS = {"W8A8": (8, torch.int8), "W8A16": (8, torch.int16),
               "W4A8": (4, torch.int8), "W4A4": (4, torch.int8),
               "W4A16": (4, torch.int16)}


def int_gemm_operands(gen, b, h, w, fmt: str, dev):
    """Weights (H, W[/2]) int8 with a row of -128 / 127 (int4: -8 / 7)
    and a row cycling through every int4 nibble / int8 byte; activations
    (B, W) with the type's extremes, and for int16 the byte planes'
    extremes: -32768 (hi -128, lo 0), 32767 (127, 255), -1 (-1, 255),
    0, 255 and 256."""
    w_bits, x_dtype = INT_FORMATS[fmt]
    lo, hi = -2 ** (w_bits - 1), 2 ** (w_bits - 1) - 1
    wq = torch.randint(lo, hi + 1, (h, w), generator=gen)
    wq[h // 2] = torch.where(torch.arange(w) % 2 == 1, hi, lo)
    wq[h - 1] = torch.arange(w) % (hi - lo + 1) + lo
    if w_bits == 4:
        wq = ref.pack_w4(wq)
    a_bits = 4 if fmt == "W4A4" else 8 * x_dtype.itemsize
    alo, ahi = -2 ** (a_bits - 1), 2 ** (a_bits - 1) - 1
    xb = torch.randint(alo, ahi + 1, (b, w), generator=gen)
    edge = [alo, ahi, -1, 0] + ([255, 256] if a_bits == 16 else [])
    xb[b - 1, :len(edge)] = torch.tensor(edge)
    xb[0, -len(edge):] = torch.tensor(edge)
    return wq.to(torch.int8).to(dev), xb.to(x_dtype).to(dev)


@pytest.mark.parametrize("w", [32, 64, 4096, 4128])
@pytest.mark.parametrize("fmt", INT_FORMATS)
def test_gemm_int_tensor_core_edges(dev, fmt, w):
    """The tensor-core int GEMM bit for bit against its plain version on
    every edge of its tiles -- batch rows past 8 and 16, weight rows past
    16, widths that are not multiples of the warps' spans -- with the
    weight and activation extremes; aligned operands take the MMA
    variant, a misaligned view the byte-wise one."""
    w_bits = INT_FORMATS[fmt][0]
    gen = torch.Generator().manual_seed(w + w_bits)
    for b in (1, 2, 7, 8, 9, 17):
        for h in (1, 15, 16, 17, 130):
            wq, xb = int_gemm_operands(gen, b, h, w, fmt, dev)
            ws = torch.rand(h, generator=gen).to(dev) + 0.5
            assert pim_gemm.int_variant(wq, xb) == "mma"
            variants = dict(pim_gemm.INT_VARIANT_LAUNCHES)
            out = held_to_plain("pim_gemm_int", wq, xb, ws, 0.37,
                                w_bits=w_bits)
            assert pim_gemm.INT_VARIANT_LAUNCHES == dict(
                variants, mma=variants["mma"] + 1)
            assert out.shape == (b, h)
    smoke = _chip_smoke()
    wq, xb = int_gemm_operands(gen, 9, 17, w, fmt, dev)
    wq, xb = smoke.misaligned(wq), smoke.misaligned(xb)
    assert pim_gemm.int_variant(wq, xb) == "bytes"
    variants = dict(pim_gemm.INT_VARIANT_LAUNCHES)
    held_to_plain("pim_gemm_int", wq, xb, torch.ones(17, device=dev), 0.37,
                  w_bits=w_bits)
    assert pim_gemm.INT_VARIANT_LAUNCHES == dict(
        variants, bytes=variants["bytes"] + 1)


def gemv_int_expect(wq, x, fmt, variant, dev):
    """One int GEMV launch through ``pim_gemv_int``, which must choose
    ``variant`` (counted once there), held bit for bit to plain."""
    w_bits = INT_FORMATS[fmt][0]
    h = wq.shape[0]
    ws = torch.linspace(0.5, 2.0, h, device=dev)
    before = dict(pim_gemv.GEMV_INT_VARIANT_LAUNCHES)
    assert pim_gemv.gemv_int_variant(wq, x, w_bits) == variant
    out = held_to_plain("pim_gemv_int", wq, x, ws, 0.37, w_bits=w_bits)
    assert pim_gemv.GEMV_INT_VARIANT_LAUNCHES == dict(
        before, **{variant: before[variant] + 1})
    assert out.shape == (h,)


def gemv_rows(fmt: str, dev) -> tuple[int, int, int]:
    """R for small and large H, and the least H that takes the large."""
    w_bits, x_dtype = INT_FORMATS[fmt]
    small, large = pim_gemv.GEMV_INT_ROWS[(w_bits, x_dtype.itemsize)]
    return small, large, pim_gemv.gemv_int_large_h(w_bits,
                                                   x_dtype.itemsize, dev)


@pytest.mark.parametrize("w", [32, 64, 4096, 4128, 14336])
@pytest.mark.parametrize("fmt", INT_FORMATS)
def test_gemv_int_vector_edges(dev, fmt, w):
    """The int GEMV's vector kernel bit for bit against plain at the
    edges of its warps' row groups -- H = 1, R - 1, R + 1, 15, 17, 1024,
    1025, all on the small-H R -- and widths up to mlp.wo's 14336, with
    the weight extremes and the byte planes' extremes; a misaligned view
    goes byte-wise."""
    small = gemv_rows(fmt, dev)[0]
    gen = torch.Generator().manual_seed(w + INT_FORMATS[fmt][0])
    for h in sorted({1, max(1, small - 1), small + 1, 15, 17, 1024, 1025}):
        wq, xb = int_gemm_operands(gen, 1, h, w, fmt, dev)
        gemv_int_expect(wq, xb[0], fmt, f"rows{small}", dev)
    smoke = _chip_smoke()
    wq, xb = int_gemm_operands(gen, 1, 17, w, fmt, dev)
    gemv_int_expect(smoke.misaligned(wq), smoke.misaligned(xb[0]), fmt,
                    "bytes", dev)


@pytest.mark.parametrize("fmt", INT_FORMATS)
def test_gemv_int_large_h_edges(dev, fmt):
    """Around the least H that takes the large-H R: one row short of it,
    at it, and a ragged last row group past it."""
    small, large, least = gemv_rows(fmt, dev)
    gen = torch.Generator().manual_seed(INT_FORMATS[fmt][0] + 5)
    for h, rows in ((least - 1, small), (least, large),
                    (least + large + 1, large)):
        for w in (32, 4128):
            wq, xb = int_gemm_operands(gen, 1, h, w, fmt, dev)
            gemv_int_expect(wq, xb[0], fmt, f"rows{rows}", dev)


@pytest.mark.parametrize("fmt", INT_FORMATS)
def test_gemv_int_every_variant(dev, fmt):
    """Both vector variants the wrapper gives a format (its small-H and
    large-H R) bit for bit against plain on ragged shapes: rows past a
    block's 8 R, widths ending inside a pass of 32 x 4 chunks."""
    small, large, least = gemv_rows(fmt, dev)
    gen = torch.Generator().manual_seed(11)
    for h, w in ((37, 4128), (9, 64), (1030, 32), (67, 14336),
                 (least + 37, 4128), (least + 9, 64), (least + 67, 14336)):
        wq, xb = int_gemm_operands(gen, 1, h, w, fmt, dev)
        gemv_int_expect(wq, xb[0], fmt,
                        f"rows{large if h >= least else small}", dev)


def test_gemv_int_w4a16_wraparound_on_card(dev):
    """7 * 32767 * 16384 passes 2^31: the W4A16 GEMV's byte-plane sums
    and the int4 bias correction wrap as int32 does."""
    wq = ref.pack_w4(torch.full((8, 16384), 7, dtype=torch.int8)).to(dev)
    xq = torch.full((16384,), 32767, dtype=torch.int16, device=dev)
    ws = torch.linspace(0.5, 1.5, 8, device=dev)
    assert pim_gemv.gemv_int_variant(wq, xq, 4) == "rows2"
    out = held_to_plain("pim_gemv_int", wq, xq, ws, 1.0, w_bits=4)
    wrapped = 7 * 32767 * 16384 - (1 << 32)
    assert torch.equal(out, torch.tensor(float(wrapped), device=dev) * ws)


def test_prepare_weights_on_card_gives_the_cpu_bytes(dev):
    rng = np.random.default_rng(3)
    wf = (rng.standard_normal((300, 512)) * 0.02).astype(np.float32)
    for dtype in ALL_DTYPES:
        card = ops.prepare_weights(wf, dtype, device=dev)
        cpu = ops.prepare_weights(wf, dtype, device="cpu")
        assert card.q.device.type == "cuda"
        assert torch.equal(card.q.view(torch.uint8).cpu(),
                           cpu.q.view(torch.uint8))
        if not dtype.is_fp:
            assert torch.equal(card.scale.cpu(), cpu.scale)


def test_pim_wrappers_refuse_mixed_devices(dev):
    wq = torch.zeros((4, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="is on cpu"):
        pim_gemv.pim_gemv_int(wq, torch.zeros(32, dtype=torch.int8),
                              torch.ones(4, device=dev), 1.0)


def test_granite_8b_linear_fixture_on_card(dev):
    """The full-width fixture: 8 sites x 7 dtypes x batch 1 and 8."""
    smoke = _chip_smoke()
    fixture = json.loads((GOLDEN / "torch_pim_linear.json").read_text())
    before = {name: mod.LAUNCHES[name] for name, mod in PIM.items()}
    variants = dict(pim_gemm.FP_VARIANT_LAUNCHES)
    int_variants = dict(pim_gemm.INT_VARIANT_LAUNCHES)
    gemv_variants = dict(pim_gemv.GEMV_INT_VARIANT_LAUNCHES)
    for index, site in enumerate(fixture["sites"]):
        wts, acts = smoke.site_inputs(fixture["seed"], index, site["h"],
                                      site["w"])
        wd, xd = torch.from_numpy(wts).to(dev), torch.from_numpy(acts).to(dev)
        for dtype in ALL_DTYPES:
            qw = ops.prepare_weights(wd, dtype, device=dev)
            for b in (1, 8):
                y = ops.pim_linear(xd[0] if b == 1 else xd, qw)
                key = f"{site['name']}/{dtype.name}/b{b}"
                assert smoke.fixture_mismatch(
                    fixture["results"][key], y.cpu().numpy(),
                    fixture["fp_rel_tol"]) is None, key
    assert all(mod.LAUNCHES[name] > before[name]
               for name, mod in PIM.items())
    # Every full-width GEMM took the tensor-core variant.
    assert pim_gemm.FP_VARIANT_LAUNCHES == dict(
        variants, mma=variants["mma"] + pim_gemm.LAUNCHES["pim_gemm_fp"]
        - before["pim_gemm_fp"])
    assert pim_gemm.INT_VARIANT_LAUNCHES == dict(
        int_variants, mma=int_variants["mma"]
        + pim_gemm.LAUNCHES["pim_gemm_int"] - before["pim_gemm_int"])
    # ... and every int GEMV a vector variant.
    gemv = pim_gemv.GEMV_INT_VARIANT_LAUNCHES
    assert gemv["bytes"] == gemv_variants["bytes"]
    assert sum(gemv.values()) - sum(gemv_variants.values()) == (
        pim_gemv.LAUNCHES["pim_gemv_int"] - before["pim_gemv_int"])


# ---------------------------------------------------------------------
# The models and serving with a model (chip_smoke.py phase 9)
# ---------------------------------------------------------------------

def _smoke_weights(arch: str, dev):
    cfg = smoke_config(ARCHS[arch])
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, cpu, params_from_numpy(params_to_numpy(cpu), dev)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_smoke_model_on_card_equals_cpu(dev, arch):
    """forward, prefill and 4 ragged decode steps: every logit within
    1e-4 x its step's max |logit| and the greedy tokens equal."""
    smoke = _chip_smoke()
    cfg, cpu, card = _smoke_weights(arch, dev)
    batch = smoke.smoke_batch(cfg, np.random.default_rng(0))
    (want, _), (got, _) = smoke.paired_steps(M, cfg, cpu, card, batch, dev)
    msg, _worst = smoke.steps_mismatch(want, got, 1e-4)
    assert msg is None, msg


@pytest.mark.parametrize("bits,kv_quant", [(8, False), (4, False),
                                           (8, True)])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_quantized_smoke_model_on_card_equals_cpu(dev, arch, bits,
                                                  kv_quant):
    """W8 / W4 (and the int8 KV cache): the quantized leaves bit-equal,
    the int8 KV entries bit-equal to the CPU's quantizer of the card's
    floats, logits and greedy tokens as above."""
    smoke = _chip_smoke()
    cfg, cpu, card = _smoke_weights(arch, dev)
    batch = smoke.smoke_batch(cfg, np.random.default_rng(0))
    msg, _worst = smoke.quantized_mismatch(M, cfg, cpu, card, batch, dev,
                                           bits, kv_quant)
    assert msg is None, msg


def test_kv_quantizer_on_card_bit_equal_cpu(dev):
    msg = _chip_smoke().kv_quant_mismatch(M, dev)
    assert msg is None, msg


def test_engine_streams_on_card_equal_cpu(dev):
    cfg, cpu, card = _smoke_weights("granite-8b", dev)
    streams = []
    for params, device in ((cpu, "cpu"), (card, dev)):
        eng = ServingEngine(cfg, params, slots=3, max_seq=40, device=device)
        rng = np.random.default_rng(4)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                                   size=3 + 2 * i),
                        max_new=3 + i) for i in range(6)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        streams.append([r.out for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("name", ["serve_trace", "spec_decode_trace",
                                  "disagg_trace"])
def test_replay_golden_on_card_with_a_cold_planner(dev, name):
    cfg = smoke_config(ARCHS["granite-8b"])
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    fixture = json.loads((GOLDEN / f"{name}.json").read_text())
    before = lane_scan.LAUNCHES
    got = replay_trace(fixture, cfg, params,
                       OffloadPlanner(ARCHS["granite-8b"], device=dev),
                       device=dev)
    assert lane_scan.LAUNCHES > before
    assert json.loads(json.dumps(got)) == fixture


def test_disagg_golden_through_scoped_cells_on_card(dev):
    """``chip_smoke.py`` phase 10 ``disagg_golden``: the cells, each under
    its own backend scope, with a cold full-width planner, reproduce
    ``disagg_trace.json`` (the smoke model: the trace holds no token)."""
    cfg = smoke_config(ARCHS["granite-8b"])
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    fixture = json.loads((GOLDEN / "disagg_trace.json").read_text())
    before = lane_scan.LAUNCHES
    got = run_scenario(
        ScenarioSpec.from_record(fixture["scenario"]), cfg, params,
        OffloadPlanner(ARCHS["granite-8b"], device=dev),
        policy=fixture["policy"], fence=fixture["fence"],
        disagg=DisaggConfig.from_record(fixture["disagg"]["config"]),
        slo={int(r): s for r, s in fixture["disagg"]["slo"].items()},
        prefill_scope=engine.BackendScope(name="prefill"),
        decode_scope=engine.BackendScope(name="decode"), device=dev)
    assert lane_scan.LAUNCHES > before
    got = json.loads(json.dumps(got))
    scopes = got["disagg"].pop("scopes")
    assert got == fixture
    assert [s["rungs"] for s in scopes.values()] == [["scan"], ["scan"]]


def test_chaos_golden_on_card_with_a_fresh_planner(dev):
    """``chip_smoke.py`` phase 10 ``chaos_golden``: the golden's incident
    on a fresh full-width mamba2-130m planner, the chaos record
    included; the cold plan and the four storms go through the kernel."""
    cfg = smoke_config(ARCHS["granite-8b"])
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    fixture = json.loads((GOLDEN / "chaos_trace.json").read_text())
    spec = make_scenario("chaos", seed=5, slots=4, quick=True)
    horizon = max(a.step for a in spec.arrivals) + 1
    before = lane_scan.LAUNCHES
    try:
        got = run_chaos_scenario(
            cfg, params, OffloadPlanner(ARCHS["mamba2-130m"], device=dev),
            scenario=spec,
            timeline=make_chaos_timeline(5, horizon=max(horizon, 8),
                                         rungs=["scan"], scheduling=True),
            disagg=DisaggConfig(prefill_budget=2, handoff_bound=3,
                                starvation_age=4, admission_capacity=6),
            slo=assign_slo(spec, 0.6), device=dev)
    finally:
        faults.reset()
    assert lane_scan.LAUNCHES - before >= 5
    assert json.loads(json.dumps(got)) == fixture


def test_warm_start_round_trip_in_fresh_processes(dev, tmp_path):
    """The launcher twice on one cache directory: the second process
    loads every lane the first saved and resolves none."""
    smoke = _chip_smoke()
    argv = ["--scenario", "bursty", "--policy", "hysteresis", "--quick",
            "--cache-dir", str(tmp_path)]
    cold, _ = smoke.run_launcher(argv)
    warm, _ = smoke.run_launcher(argv)
    saved = int(cold.split("warm start: saved ")[1].split()[0])
    assert saved > 0 and smoke.lane_cache_row(cold)["misses"] > 0
    assert f"{saved} lanes loaded" in warm
    assert smoke.lane_cache_row(warm)["misses"] == 0


# ---------------------------------------------------------------------
# Training and the dry-run's PIM report (chip_smoke.py phase 11)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "mamba2-130m",
                                  "internvl2-26b"])
def test_smoke_train_step_on_card_equals_cpu(dev, arch):
    """``loss_fn``'s loss and grads and one trainer step on the card ==
    on the CPU within float32 noise (``chip_smoke`` phase 11's check)."""
    msg, _ = _chip_smoke().train_smoke_mismatch(smoke_config(ARCHS[arch]),
                                                dev)
    assert msg is None, msg


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """A trainer on the card saves at step 2; a fresh one restores the
    tree bit-equal and its step 3 gives the same loss."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = smoke_config(ARCHS["granite-8b"])
    tcfg = TrainConfig(lr=3e-3, warmup=1, total_steps=10, microbatches=2,
                       ckpt_every=2, ckpt_dir=str(tmp_path))
    src = SyntheticLM(cfg.vocab, seed=0)
    batches = [to_device(src.batch(s, 4, 16), dev) for s in range(3)]
    a = Trainer(cfg, tcfg, generator=torch.Generator(dev).manual_seed(0))
    a.train(iter(batches[:2]), 2, log_every=1 << 30)
    saved = [t.cpu() for t in tree_leaves((a.params, a.opt))]
    b = Trainer(cfg, tcfg, generator=torch.Generator(dev).manual_seed(1))
    assert b.restore_latest() and b.step == 2
    for want, got in zip(saved, tree_leaves((b.params, b.opt))):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    la = a.train(iter(batches[2:]), 1, log_every=1 << 30)[-1]["loss"]
    lb = b.train(iter(batches[2:]), 1, log_every=1 << 30)[-1]["loss"]
    assert abs(la - lb) <= 1e-6 * abs(la)


def test_pim_report_on_card_equals_cpu(dev, monkeypatch, tmp_path):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "ARCHS",
                        {"granite-8b": smoke_config(ARCHS["granite-8b"])})
    before = lane_scan.LAUNCHES
    card = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                     policy="hysteresis", disagg=True,
                                     device=dev)
    assert lane_scan.LAUNCHES > before
    engine.lane_cache_reset()
    cpu = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                    policy="hysteresis", disagg=True,
                                    device="cpu")
    assert json.loads(json.dumps(card)) == json.loads(json.dumps(cpu))


# ---------------------------------------------------------------------
# Phase 12: the lane mesh and the cell lowering
# ---------------------------------------------------------------------

def test_lane_mesh_and_threaded_rungs_on_card(dev):
    """The granite-8b plan's lanes on four shards of the card, and on the
    threaded rung over two entries of it, equal the scan rung's, each
    shard launching the kernel on its own stream."""
    spec_pts = [(DEFAULT_SYSTEM.derive_cycles(), list(streams))
                for streams in _granite_streams()]
    solo = engine.resolve_fleet(spec_pts, device=dev)
    engine.lane_cache_reset()
    engine.MESH_SHARD_LAUNCHES.clear()
    with engine.lane_mesh_scope(engine.build_lane_mesh(4, [dev] * 4)):
        assert engine.ladder_rungs() == ["mesh", "scan"]
        meshed = engine.resolve_fleet(spec_pts, device=dev)
    assert sorted(engine.MESH_SHARD_LAUNCHES) == [0, 1, 2, 3]
    engine.lane_cache_reset()
    engine.configure_lane_devices([dev, dev])
    try:
        assert engine.ladder_rungs() == ["threaded", "scan"]
        threaded = engine.resolve_fleet(spec_pts, device=dev)
    finally:
        engine.configure_lane_devices(None)
    for a, b, c in zip(solo, meshed, threaded):
        assert np.array_equal(a.totals, b.totals)
        assert np.array_equal(a.totals, c.totals)
        for ia, ib, ic in zip(a.issue, b.issue, c.issue):
            assert np.array_equal(ia, ib) and np.array_equal(ia, ic)


def _granite_streams():
    """The granite-8b W8A8 decode plan's command streams, per GEMV."""
    ex = PimExecutor(device="cpu")
    sites = [GemvRequest.pim(h, w, PimDType.W8A8, fence=True)
             for h, w in ((4096, 4096), (1024, 4096), (14336, 4096))]
    return [ex.plan_many([r])[0].streams for r in sites]


def test_pim_report_on_card_under_lane_mesh(dev):
    from repro_torch.launch import dryrun
    fx = json.loads((GOLDEN / "torch_pim_report.json").read_text())
    with engine.lane_mesh_scope(engine.build_lane_mesh(4, [dev] * 4)):
        rec = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                        policy="hysteresis", disagg=True,
                                        device=dev)
    assert json.loads(json.dumps(rec)) == fx


def test_cell_lowers_on_cuda_fake_tensors(dev):
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("granite-8b", "decode_32k", False, save=False,
                          extrapolate=False, device=dev)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["device_type"] == "cuda" and rec["chips"] == 256
    assert not dist.is_initialized()

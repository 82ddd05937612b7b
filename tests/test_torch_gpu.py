"""The port's correctness on the card: the lane-scan kernel, the
simulator's goldens at full width, the PIM-tile kernels, the models,
serving, training, the dry-run's report and lowering, and the lane mesh.

Every test here is marked ``gpu`` and skips itself when no CUDA device
is present (decided inside the test, never at import).  The file imports
only torch, numpy, ``repro_torch`` and ``tests/torch_card.py`` — no JAX
— so it also runs where JAX is not installed; the pinned numbers come
from the goldens the JAX package wrote.  On a machine with a card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's ``conftest.py`` imports the JAX package.)
Kernel launches are read from the tracer's counters (``core/trace.py``).
"""
import dataclasses
import gc
import json
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, granite_8b, smoke_config
from repro_torch.core import commands as C
from repro_torch.core import engine, faults, trace
from repro_torch.core.engine_ref import RefEngine
from repro_torch.core.pimsim import PimSimulator
from repro_torch.core.timing import (DEFAULT_SYSTEM, LpddrTimings, PimSpec,
                                     SystemSpec)
from repro_torch.kernels import lane_scan, ops, pim_gemm, pim_gemv, ref
from repro_torch.models import model as M
from repro_torch.models.convert import (draw_numpy_params, params_from_numpy,
                                        params_to_numpy)
from repro_torch.pimkernel.executor import (FunctionalGemv, GemvRequest,
                                            PimExecutor)
from repro_torch.pimkernel.tileconfig import ALL_DTYPES, PimDType
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import OffloadPlanner, decode_gemv_sites
from repro_torch.serving.chaos import make_chaos_timeline, run_chaos_scenario
from repro_torch.serving.scenarios import (SCENARIOS, AutoscaleConfig,
                                           DisaggConfig, ScenarioSpec,
                                           assign_slo, make_scenario,
                                           occupancy_trace, replay_batches,
                                           replay_trace, run_policy_over_trace,
                                           run_scenario, simulate_disagg)
import torch_card

GOLDEN = pathlib.Path(__file__).parent / "golden"
ROOT = torch_card.ROOT
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


def scans() -> int:
    """Lane-scan kernel launches so far."""
    return trace.totals().counter("lane_scan.launches")


def golden(name: str) -> dict:
    return json.loads((GOLDEN / f"{name}.json").read_text())


def record(res) -> dict:
    return json.loads(json.dumps(dict(
        cycles=res.cycles, ns=res.ns, flops=res.flops,
        weight_bytes=res.weight_bytes, utilization=res.utilization,
        split=res.split, counts=[int(c) for c in res.counts],
        energy=res.energy)))


def kernel_equals_plain(cycs, streams, lengths, nb, dev):
    args = (cycs.to(dev), streams.to(dev), lengths.to(dev), nb)
    for need_issue in (True, False):
        before = scans()
        ik, tk = lane_scan.lane_scan(*args, need_issue=need_issue)
        assert scans() == before + 1
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


@pytest.mark.parametrize("nb,f,n", [
    *((nb, 24, 128) for nb in lane_scan.SUPPORTED_BANKS),
    *((nb, 96, 400) for nb in (8, 12, 16))])         # long lanes
def test_kernel_matches_plain_fuzzed(dev, nb, f, n):
    kernel_equals_plain(*fuzzed(nb, f, n, seed=nb + n), nb, dev)


@pytest.mark.parametrize("bankgroups", [2, 3, 4])
def test_kernel_matches_plain_probe_lane(dev, bankgroups):
    spec = SystemSpec(timings=LpddrTimings(num_bankgroups=bankgroups))
    nb = spec.timings.num_banks
    probe = lane_scan.probe_stream(nb)
    kernel_equals_plain(engine.pack_cycles([spec.derive_cycles()]), probe,
                        torch.tensor([16], dtype=torch.int32), nb, dev)


@pytest.mark.parametrize("h,w,dtype,fence", [
    (256, 2048, PimDType.W8A16, True),
    (512, 4096, PimDType.W8A8, False)])             # a Fig-4 point
def test_kernel_matches_plain_on_pim_streams(dev, h, w, dtype, fence):
    planned = PimExecutor(device=dev).plan_many(
        [GemvRequest.pim(h, w, dtype, fence=fence)])[0]
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
    fixture = golden("fleet_parity")
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
    points = golden("torch_port_points")
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
    """With the LRU cold, the functional GEMVs, the full Fig-4 sweep (7
    dtypes x 5 sizes, both axes) and the granite-8b decode speed-up each
    launch the kernel; the warm replan launches nothing."""
    points = golden("torch_port_points")
    sim = PimSimulator(device=dev)
    before = scans()
    rng = np.random.default_rng(0)
    wts = rng.integers(-128, 128, size=(256, 2048)).astype(np.int32)
    x = rng.integers(-128, 128, size=(2048,)).astype(np.int32)
    y, _res = sim.gemv_functional(wts, x, "W8A8")
    np.testing.assert_array_equal(y, wts.astype(np.int64) @ x.astype(np.int64))
    items = [FunctionalGemv(rng.integers(-8, 8, (h, w)).astype(np.int32),
                            rng.integers(-8, 8, (w,)).astype(np.int32),
                            PimDType.W4A8)
             for h, w in ((128, 512), (192, 1024), (64, 2048), (96, 700))]
    for item, (y, _res) in zip(items, sim.gemv_functional_many(items)):
        np.testing.assert_array_equal(
            y, item.weights.astype(np.int64) @ item.x.astype(np.int64))
    assert scans() > before
    before = scans()
    dims = [512, 1024, 2048, 4096, 8192]
    quick = points["quickstart"]
    head = (quick["base-4096x4096-W8A8"]["ns"]
            / quick["pim-4096x4096-W8A8"]["ns"])
    for axis in ("activation", "output"):
        surf = sim.sweep(dims, ALL_DTYPES, axis=axis)
        assert sorted(surf) == sorted(d.name for d in ALL_DTYPES)
        vals = np.asarray([surf[d.name] for d in ALL_DTYPES])
        assert vals.shape == (7, 5)
        assert np.isfinite(vals).all() and (vals > 0).all()
        assert surf["W8A8"][dims.index(4096)] == head
    assert scans() > before
    before = scans()
    planner = OffloadPlanner(granite_8b.CONFIG, sim=sim)
    assert (json.loads(json.dumps(planner.decode_speedup(1)))
            == points["granite_8b_decode_speedup_b1"])
    assert scans() > before
    warm = scans()
    planner.invalidate()
    planner.plan()
    assert scans() == warm


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
    """The goldens' scheduling, by the model-free mirrors, and their
    controller report and per-step records, re-derived by the port's
    planner at full granite-8b width through the kernel."""
    fixture = golden(name)
    if name == "disagg_trace":
        rec = fixture["disagg"]
        sim = simulate_disagg(ScenarioSpec.from_record(fixture["scenario"]),
                              DisaggConfig.from_record(rec["config"]),
                              {int(r): c for r, c in rec["slo"].items()})
        assert sim["per_tick_batch"] == fixture["per_tick_batch"]
        for key in ("prefill_ticks", "admit_ticks", "completion_ticks"):
            assert rec["requests"][key] == {str(r): t
                                            for r, t in sim[key].items()}
        assert rec["handoff"]["max_depth"] == sim["max_handoff_depth"]
    else:
        assert replay_batches(fixture) == fixture["per_tick_batch"]
    planner = OffloadPlanner(ARCHS["granite-8b"], device=dev)
    before = scans()
    c = run_policy_over_trace(planner, fixture["policy"],
                              fixture["per_tick_batch"],
                              fence=fixture["fence"])
    assert scans() > before
    assert json.loads(json.dumps(c.report())) == fixture["controller"]
    assert (json.loads(json.dumps([r.to_record() for r in c.trace]))
            == fixture["per_step"])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_battery_at_full_width(dev, name):
    """Every policy over the scenario's occupancy trace, planned at full
    granite-8b width through the kernel: ``per-step`` is the oracle; the
    others reach 95 % of it with fewer planner queries than steps."""
    planner = OffloadPlanner(ARCHS["granite-8b"], device=dev)
    occupancy = occupancy_trace(make_scenario(name, seed=0))
    for pol in ("per-step", "hysteresis", "sticky"):
        rep = run_policy_over_trace(planner, pol, occupancy).report()
        assert rep["steps"] == len(occupancy), pol
        if pol == "per-step":
            assert rep["efficiency"] == 1.0, rep
            assert rep["planner_queries"] == rep["steps"], rep
        else:
            assert rep["efficiency"] >= 0.95, (pol, rep)
            assert rep["realized_speedup"] <= rep["oracle_speedup"] + 1e-12
            assert rep["planner_queries"] < rep["steps"], (pol, rep)


def test_speculative_planning_at_full_width(dev):
    """Draft planning at full granite-8b width launches the kernel and
    prices every site."""
    planner = OffloadPlanner(ARCHS["granite-8b"], device=dev)
    planner.plan()
    before = scans()
    draft = planner.plan_draft()
    touched = planner.touch_draft()
    tel = planner.spec_decode_speedup(batch=1)
    assert scans() > before
    assert len(draft) == len(planner.plan()) and touched > 0
    assert all(d.pim_ns > 0 and d.host_ns > 0 for d in draft)
    assert np.isfinite(tel["speedup"]) and tel["speedup"] > 0, tel


ORACLE_MAX_COMMANDS = 100_000      # lanes up to this long go to RefEngine


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_arch_plans_at_full_width_and_the_oracle_agrees(
        dev, arch, monkeypatch):
    """The arch's full-width plan, the LRU cold, goes through the kernel
    and prices every site; then the port's ``RefEngine`` on every lane of
    it up to ``ORACLE_MAX_COMMANDS`` commands gives the kernel's issue
    cycles and the totals the plan used."""
    real_scan, real_pack = lane_scan.lane_scan, engine.pack_lanes
    packed: list = []
    short: list = []

    def pack(lanes):
        packed[:] = lanes
        return real_pack(lanes)

    def scan(cycs, streams, lengths, nb, **kw):
        iss, tot = real_scan(cycs, streams, lengths, nb, **kw)
        tot_host = tot.cpu().numpy()
        short.extend((cyc, s, int(tot_host[row]))
                     for row, (cyc, s) in enumerate(packed)
                     if s.shape[0] <= ORACLE_MAX_COMMANDS)
        return iss, tot

    monkeypatch.setattr(engine, "pack_lanes", pack)
    monkeypatch.setattr(lane_scan, "lane_scan", scan)
    before = scans()
    plan = OffloadPlanner(ARCHS[arch], device=dev).plan(fence=True)
    monkeypatch.undo()
    assert scans() > before
    assert all(d.pim_ns > 0 and d.host_ns > 0 for d in plan)
    assert short
    by_banks: dict = {}
    for lane in short:
        by_banks.setdefault(lane[0].num_banks, []).append(lane)
    for nb, lanes in sorted(by_banks.items()):
        cycs, streams, lengths = engine.pack_lanes(
            [(c, s) for c, s, _t in lanes])
        iss, tot = lane_scan.lane_scan(cycs.to(dev), streams.to(dev),
                                       lengths.to(dev), nb)
        iss, tot = iss.cpu().numpy(), tot.cpu().numpy()
        at = 0
        for row, (cyc, s, total) in enumerate(lanes):
            iss_ref, tot_ref = RefEngine(cyc, validate=False).run(s)
            n = s.shape[0]
            np.testing.assert_array_equal(iss[at:at + n].astype(np.int64),
                                          iss_ref)
            assert int(tot[row]) == tot_ref == total
            at += n


# ---------------------------------------------------------------------
# The PIM-tile kernels
# ---------------------------------------------------------------------


PIM = {"pim_gemv_int": pim_gemv, "pim_gemv_fp": pim_gemv,
       "pim_gemm_int": pim_gemm, "pim_gemm_fp": pim_gemm}


def held_to_plain(name, *args, **kw):
    """Launch one wrapper on the card (counted once) and hold it to its
    plain version: int bit-equal, fp within the f32 sum bound."""
    mod = PIM[name]
    before = torch_card.launches(name)
    out = getattr(mod, name)(*args, **kw)
    assert torch_card.launches(name) == before + 1
    want = getattr(mod, f"{name}_plain")(*args, **kw)
    torch.cuda.synchronize()
    torch_card.pim_error(name, out, want, args)
    return out


def through_pim_linear(x, qw):
    """``pim_linear`` on the card, each kernel call held to its plain
    version on the operands pim_linear handed it."""
    calls = []

    def hold(name, out, args, kw):
        want = getattr(PIM[name], f"{name}_plain")(*args, **kw)
        torch_card.pim_error(name, out, want, args)
        calls.append(name)

    real = torch_card.patch_pim_kernels(PIM, hold)
    try:
        y = ops.pim_linear(x, qw)
    finally:
        torch_card.restore_pim_kernels(PIM, real)
    assert len(calls) == 1
    return y


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: d.name)
@pytest.mark.parametrize("h,w,scaled", [
    (130, 258, False), (256, 4096, False), (37, 1000, False),
    *((h, w, True) for h, w in ((1, 32), (7, 16), (130, 258), (37, 1000),
                                (256, 4096), (1023, 2050), (64, 4128),
                                (300, 96)))])
def test_pim_kernels_match_plain_through_pim_linear(dev, dtype, h, w,
                                                    scaled):
    """Ragged shapes (row bytes that are and are not multiples of 16),
    batch 1 to 9; ``scaled``: weights and activations at random
    magnitudes, and one activation row with outliers (fp8 NaN there)."""
    rng = np.random.default_rng(h + w)
    wf = rng.standard_normal((h, w))
    xf = rng.standard_normal((9, w))
    if scaled:
        wf *= rng.uniform(0.01, 3.0)
        xf *= rng.uniform(0.1, 10.0)
        xf[2, ::97] *= 60.0
    wd = torch.from_numpy(wf.astype(np.float32))
    xd = torch.from_numpy(xf.astype(np.float32))
    qw = ops.prepare_weights(wd.to(dev), dtype, device=dev)
    for x in (xd[0], xd[:1], xd[:3], xd[:8], xd):
        before = sum(torch_card.launches(name) for name in PIM)
        y = through_pim_linear(x.to(dev), qw)
        assert y.shape == ((h,) if x.dim() == 1 else (x.shape[0], h))
        assert sum(torch_card.launches(name) for name in PIM) == before + 1


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("x_dtype", [torch.int8, torch.int16])
def test_int_extremes_and_misaligned_views_on_card(dev, w_bits, x_dtype):
    """Every int4 nibble / int8 byte against int8/int16 extremes, on
    aligned operands (vector loads) and misaligned views (byte-wise)."""
    gen = torch.Generator().manual_seed(w_bits)
    wq = (torch.stack([torch.randperm(256, generator=gen)
                       for _ in range(16)]) - 128).to(torch.int8).to(dev)
    width = 256 * (2 if w_bits == 4 else 1)
    info = torch.iinfo(x_dtype)
    xb = torch.randint(info.min, info.max + 1, (9, width), generator=gen)
    xb[:, :4] = torch.tensor([info.min, info.max, -1, 0])
    xb = xb.to(x_dtype).to(dev)
    ws = torch.linspace(0.5, 2.0, 16, device=dev)
    for wop, xop in ((wq, xb), (torch_card.misaligned(wq),
                               torch_card.misaligned(xb))):
        held_to_plain("pim_gemv_int", wop, xop[0], ws, 0.37, w_bits=w_bits)
        held_to_plain("pim_gemm_int", wop, xop, ws, 0.37, w_bits=w_bits)


@pytest.mark.parametrize("x_dtype", [torch.float8_e4m3fn, torch.bfloat16],
                         ids=["fp8", "bf16"])
def test_fp_kernels_on_misaligned_views(dev, x_dtype):
    """The fp GEMV and GEMM on views one element past a 16-byte boundary
    (the byte-wise path)."""
    rng = np.random.default_rng(6)
    w8 = ref.to_e4m3fn(torch.from_numpy(
        rng.standard_normal((48, 200)).astype(np.float32)).to(dev))
    xb = torch.from_numpy(rng.standard_normal((5, 200)).astype(np.float32))
    xb = (ref.to_e4m3fn(xb) if x_dtype == torch.float8_e4m3fn
          else xb.to(x_dtype)).to(dev)
    w8, xb = torch_card.misaligned(w8), torch_card.misaligned(xb)
    held_to_plain("pim_gemv_fp", w8, xb[1].contiguous())
    held_to_plain("pim_gemm_fp", w8, xb)


def test_int32_wraparound_on_card(dev):
    qw = ops.prepare_weights(torch.full((8, 16384), 0.5, device=dev),
                             "W8A16", device=dev)
    x = torch.full((16384,), 3.0, device=dev)
    ws = pim_gemv.row_scale(qw.scale, ref.quantize_acts(x, 16)[1])
    want = torch.tensor(-538951680.0, device=dev) * ws
    assert torch.equal(ops.pim_linear(x, qw), want)
    assert torch.equal(ops.pim_linear(torch.stack([x, x]), qw)[1], want)
    xq = ref.quantize_acts(x.expand(8, -1), 16)[0].contiguous()
    assert pim_gemm.int_variant(qw.q, xq) == "mma"
    assert torch.equal(ops.pim_linear(x.expand(8, -1), qw),
                       want.expand(8, -1))
    # A B = 8 GEMM on the tensor-core kernel: 127 * 32767 * 16384 wraps
    # where the byte planes' sums are combined.
    xb = torch.full((8, 16384), 32767, dtype=torch.int16, device=dev)
    assert pim_gemm.int_variant(qw.q, xb) == "mma"
    mma = trace.totals().counter("pim_gemm_int.launches.mma")
    out = pim_gemm.pim_gemm_int(qw.q, xb, qw.scale, 1.0)
    assert trace.totals().counter("pim_gemm_int.launches.mma") == mma + 1
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
    xf[4, 5], xf[5, 6], xf[1, 7] = np.inf, np.nan, 448.0
    qw = ops.prepare_weights(torch.from_numpy(wf).to(dev), dtype,
                             device=dev)
    cpu = ops.prepare_weights(wf, dtype, device="cpu")
    assert torch.equal(qw.q.view(torch.uint8).cpu(), cpu.q.view(torch.uint8))
    for x in (xf, *xf):
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
    mma = "pim_gemm_fp.launches.mma"
    rng = np.random.default_rng(w)
    for b in (1, 2, 7, 8, 9, 17):
        for h in (1, 15, 16, 17, 33, 130):
            w8, x = fp_gemm_operands(rng, b, h, w, x_dtype, dev)
            before = trace.totals().counter(mma)
            assert pim_gemm.fp_variant(w8, x) == "mma"
            out = pim_gemm.pim_gemm_fp(w8, x)
            assert trace.totals().counter(mma) == before + 1
            want = pim_gemm.pim_gemm_fp_plain(w8, x)
            torch.cuda.synchronize()
            torch_card.pim_error("pim_gemm_fp", out, want, (w8, x))
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
            torch_card.pim_error("pim_gemm_fp", out, want, (w8, x))
    w8, x = fp_gemm_operands(rng, 9, 17, w, x_dtype, dev)
    w8, x = torch_card.misaligned(w8), torch_card.misaligned(x)
    before = trace.totals().counter("pim_gemm_fp.launches.bytes")
    assert pim_gemm.fp_variant(w8, x) == "bytes"
    held_to_plain("pim_gemm_fp", w8, x)
    assert trace.totals().counter("pim_gemm_fp.launches.bytes") == before + 1


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
    mma, by_bytes = "pim_gemm_int.launches.mma", "pim_gemm_int.launches.bytes"
    gen = torch.Generator().manual_seed(w + w_bits)
    for b in (1, 2, 7, 8, 9, 17):
        for h in (1, 15, 16, 17, 33, 130):
            wq, xb = int_gemm_operands(gen, b, h, w, fmt, dev)
            ws = torch.rand(h, generator=gen).to(dev) + 0.5
            assert pim_gemm.int_variant(wq, xb) == "mma"
            before = trace.totals().counter(mma)
            out = held_to_plain("pim_gemm_int", wq, xb, ws, 0.37,
                                w_bits=w_bits)
            assert trace.totals().counter(mma) == before + 1
            assert out.shape == (b, h)
    wq, xb = int_gemm_operands(gen, 9, 17, w, fmt, dev)
    wq, xb = torch_card.misaligned(wq), torch_card.misaligned(xb)
    assert pim_gemm.int_variant(wq, xb) == "bytes"
    before = trace.totals().counter(by_bytes)
    held_to_plain("pim_gemm_int", wq, xb, torch.ones(17, device=dev), 0.37,
                  w_bits=w_bits)
    assert trace.totals().counter(by_bytes) == before + 1


def gemv_int_expect(wq, x, fmt, variant, dev):
    """One int GEMV launch through ``pim_gemv_int``, which must choose
    ``variant`` (counted once there), held bit for bit to plain."""
    w_bits = INT_FORMATS[fmt][0]
    h = wq.shape[0]
    ws = torch.linspace(0.5, 2.0, h, device=dev)
    name = f"pim_gemv_int.launches.{variant}"
    before = trace.totals().counter(name)
    assert pim_gemv.gemv_int_variant(wq, x, w_bits) == variant
    out = held_to_plain("pim_gemv_int", wq, x, ws, 0.37, w_bits=w_bits)
    assert trace.totals().counter(name) == before + 1
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
    wq, xb = int_gemm_operands(gen, 1, 17, w, fmt, dev)
    gemv_int_expect(torch_card.misaligned(wq), torch_card.misaligned(xb[0]),
                    fmt, "bytes", dev)


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
    """The full-width fixture: 8 sites x 7 dtypes x batch 1 and 8; every
    GEMM takes the tensor-core variant and every int GEMV a vector one."""
    fixture = golden("torch_pim_linear")
    assert ([(s.name, s.h, s.w) for s in decode_gemv_sites(granite_8b.CONFIG)]
            == [(s["name"], s["h"], s["w"]) for s in fixture["sites"]])
    before = torch_card.launch_counts()
    for index, site in enumerate(fixture["sites"]):
        wts, acts = torch_card.site_inputs(fixture["seed"], index, site["h"],
                                           site["w"])
        wd, xd = torch.from_numpy(wts).to(dev), torch.from_numpy(acts).to(dev)
        for dtype in ALL_DTYPES:
            qw = ops.prepare_weights(wd, dtype, device=dev)
            for b in (1, 8):
                y = ops.pim_linear(xd[0] if b == 1 else xd, qw)
                key = f"{site['name']}/{dtype.name}/b{b}"
                assert torch_card.fixture_mismatch(
                    fixture["results"][key], y.cpu().numpy(),
                    fixture["fp_rel_tol"]) is None, key
    after = torch_card.launch_counts()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    assert all(sum(v for k, v in moved.items() if k.startswith(name + "."))
               > 0 for name in PIM), moved
    # Every full-width GEMM took the tensor-core variant, and every int
    # GEMV a vector one: no launch counted under "bytes".
    assert not any(k.endswith(".bytes") for k in moved), moved
    assert moved["pim_gemm_fp.launches.mma"] > 0
    assert moved["pim_gemm_int.launches.mma"] > 0
    assert sum(v for k, v in moved.items()
               if k.startswith("pim_gemv_int.launches.rows")) > 0


# ---------------------------------------------------------------------
# The models and serving with a model
# ---------------------------------------------------------------------

def _smoke_weights(arch: str, dev):
    cfg = smoke_config(ARCHS[arch])
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, cpu, params_from_numpy(params_to_numpy(cpu), dev)


def _smoke_granite(dev):
    cfg = smoke_config(ARCHS["granite-8b"])
    return cfg, M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)


def _full_f32():
    """The matmuls run in full float32 (TF32 off)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_model_logits_fixture_on_card(dev):
    """``tests/golden/torch_model_logits.json``: granite-8b at its
    published widths cut to 2 layers, the JAX package's prefill and 4
    ragged greedy decode steps, within its ``rel_tol`` x max |logit| and
    with equal greedy tokens."""
    _full_f32()
    fx = golden("torch_model_logits")
    cfg = dataclasses.replace(ARCHS[fx["arch"]], n_layers=fx["n_layers"])
    params = params_from_numpy(draw_numpy_params(cfg, fx["seed"]), dev)
    steps = torch_card.serve_greedy(M, cfg, params, fx["prompts"],
                                    fx["decode_steps"], fx["max_seq"], dev)
    msg, _worst = torch_card.logits_mismatch(fx["steps"], steps,
                                             fx["rel_tol"])
    assert msg is None, msg


@pytest.mark.parametrize("arch", list(ARCHS))
def test_smoke_model_on_card_equals_cpu(dev, arch):
    """forward, prefill and 4 ragged decode steps: every logit within
    1e-4 x its step's max |logit| and the greedy tokens equal."""
    cfg, cpu, card = _smoke_weights(arch, dev)
    batch = torch_card.smoke_batch(cfg, np.random.default_rng(0))
    (want, _), (got, _) = torch_card.paired_steps(M, cfg, cpu, card, batch,
                                                  dev)
    msg, _worst = torch_card.steps_mismatch(want, got, 1e-4)
    assert msg is None, msg


@pytest.mark.parametrize("bits,kv_quant", [(8, False), (4, False),
                                           (8, True)])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_quantized_smoke_model_on_card_equals_cpu(dev, arch, bits,
                                                  kv_quant):
    """W8 / W4 (and the int8 KV cache): the quantized leaves bit-equal,
    the int8 KV entries bit-equal to the CPU's quantizer of the card's
    floats, logits and greedy tokens as above."""
    cfg, cpu, card = _smoke_weights(arch, dev)
    batch = torch_card.smoke_batch(cfg, np.random.default_rng(0))
    msg, _worst = torch_card.quantized_mismatch(M, cfg, cpu, card, batch,
                                                dev, bits, kv_quant)
    assert msg is None, msg


def test_smoke_hybrid_on_card_against_the_reference(dev):
    """Granite-4.0-H at its smoke size on the card, TF32 off: the full
    forward and an engine's prefill and ragged decode held to the plain
    reference's full forward, as ``test_torch_granite_hybrid.py`` holds
    them on the CPU (same tolerance, same reason)."""
    import test_torch_granite_hybrid as H

    def to(tree):
        return ({k: to(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(dev))

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = to(H.weights())
        seq = H.tokens(75).to(dev)
        got, _ = M.forward(H.CFG, p, {"tokens": seq[None]})
        want = H.REF.logits(H.cfg_dict(), p, seq)
        assert H.rel_err(got[0], want) < H.REL_TOL
        eng = ServingEngine(H.CFG, p, slots=3, max_seq=96, device=dev)
        reqs = [Request(rid=i, prompt=H.tokens(n, seed=10 + i).numpy(),
                        max_new=m)
                for i, (n, m) in enumerate([(40, 9), (7, 14), (33, 5),
                                            (20, 8)])]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=100)
        for r in reqs:
            seq = list(r.prompt) + r.out[:-1]
            ref = H.REF.logits(H.cfg_dict(), p, torch.as_tensor(seq),
                               range(len(r.prompt) - 1, len(seq)))
            best = ref.max(-1).values
            chosen = ref.gather(1, torch.as_tensor(r.out, device=dev)[:, None])
            assert float((best - chosen[:, 0]).max()) <= \
                H.REL_TOL * float(ref.abs().max()), r.rid
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_smoke_deepseek_v3_on_card_against_the_reference(dev):
    """DeepSeek-V3 at its smoke size on the card, TF32 off: the full
    forward (expanded latent attention) and an engine's prefill and
    ragged decode (absorbed, its step replayed as a CUDA graph) held to
    the plain reference's full forward, as ``test_torch_deepseek_v3.py``
    holds them on the CPU (same tolerance, same reason)."""
    import test_torch_deepseek_v3 as D

    def to(tree):
        return ({k: to(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(dev))

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = to(D.weights())
        seq = D.tokens(75).to(dev)
        got, _ = M.forward(D.CFG, p, {"tokens": seq[None]})
        want = D.REF.logits(D.cfg_dict(), p, seq)
        assert D.rel_err(got[0], want) < D.REL_TOL
        trace.reset("decode_graph.captures", "decode_graph.replays")
        eng = ServingEngine(D.CFG, p, slots=3, max_seq=96, device=dev)
        reqs = [Request(rid=i, prompt=D.tokens(n, seed=10 + i).numpy(),
                        max_new=m)
                for i, (n, m) in enumerate([(40, 9), (7, 14), (33, 5),
                                            (20, 8), (1, 6)])]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=100)
        tot = trace.totals()
        assert tot.counter("decode_graph.captures") == 1
        assert tot.counter("decode_graph.replays") > 10
        for r in reqs:
            seq = list(r.prompt) + r.out[:-1]
            ref = D.REF.logits(D.cfg_dict(), p, torch.as_tensor(seq),
                               range(len(r.prompt) - 1, len(seq)))
            best = ref.max(-1).values
            chosen = ref.gather(1, torch.as_tensor(r.out, device=dev)[:, None])
            assert float((best - chosen[:, 0]).max()) <= \
                D.REL_TOL * float(ref.abs().max()), r.rid
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_kv_quantizer_on_card_bit_equal_cpu(dev):
    msg = torch_card.kv_quant_mismatch(M, dev)
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


def replay_golden(name: str, cfg, params, dev) -> None:
    """``replay_trace`` of the golden through ``params`` with a cold
    full-width granite-8b planner reproduces it, through the kernel."""
    fixture = golden(name)
    before = scans()
    got = replay_trace(fixture, cfg, params,
                       OffloadPlanner(ARCHS["granite-8b"], device=dev),
                       device=dev)
    assert scans() > before
    assert json.loads(json.dumps(got)) == fixture


def disagg_golden(cfg, params, dev) -> None:
    """The disaggregated cells, each under its own backend scope, with a
    cold full-width planner, reproduce ``disagg_trace.json``."""
    fixture = golden("disagg_trace")
    before = scans()
    got = run_scenario(
        ScenarioSpec.from_record(fixture["scenario"]), cfg, params,
        OffloadPlanner(ARCHS["granite-8b"], device=dev),
        policy=fixture["policy"], fence=fixture["fence"],
        disagg=DisaggConfig.from_record(fixture["disagg"]["config"]),
        slo={int(r): s for r, s in fixture["disagg"]["slo"].items()},
        prefill_scope=engine.BackendScope(name="prefill"),
        decode_scope=engine.BackendScope(name="decode"), device=dev)
    assert scans() > before
    got = json.loads(json.dumps(got))
    scopes = got["disagg"].pop("scopes")
    assert got == fixture
    assert [s["rungs"] for s in scopes.values()] == [["scan"], ["scan"]]
    assert all(s["breaker"]["open"] == [] for s in scopes.values()), scopes


def chaos_golden(cfg, params, dev) -> None:
    """The golden's incident (faults at ``backend.scan`` and the planner,
    poison, scrub, eviction storms with forced re-plans, handoff
    pressure, shedding) on a fresh full-width mamba2-130m planner
    reproduces ``chaos_trace.json``, the chaos record included; the cold
    plan and the four storms go through the kernel."""
    fixture = golden("chaos_trace")
    spec = make_scenario("chaos", seed=5, slots=4, quick=True)
    horizon = max(a.step for a in spec.arrivals) + 1
    faults.reset()
    before = scans()
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
    assert scans() - before >= 5
    assert json.loads(json.dumps(got)) == fixture


@pytest.mark.parametrize("name", ["serve_trace", "spec_decode_trace",
                                  "disagg_trace"])
def test_replay_golden_on_card_with_a_cold_planner(dev, name):
    replay_golden(name, *_smoke_granite(dev), dev)


def test_disagg_golden_through_scoped_cells_on_card(dev):
    """The smoke model: the trace holds no token."""
    disagg_golden(*_smoke_granite(dev), dev)


def test_chaos_golden_on_card_with_a_fresh_planner(dev):
    chaos_golden(*_smoke_granite(dev), dev)


@pytest.fixture(scope="class")
def granite_36():
    """granite-8b at all 36 layers, its float32 weights (33 GB) drawn on
    the card from seed 0, held while the class's tests run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _full_f32()
    dev = torch.device("cuda", 0)
    cfg = ARCHS["granite-8b"]
    held = dict(cfg=cfg, params=M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    yield held
    held.clear()
    gc.collect()
    torch.cuda.empty_cache()


class TestServedAt36Layers:
    """Serving through the 36-layer float32 granite-8b on the card."""

    @pytest.mark.parametrize("name", ["serve_trace", "spec_decode_trace",
                                      "disagg_trace"])
    def test_replay_golden(self, dev, granite_36, name):
        replay_golden(name, granite_36["cfg"], granite_36["params"], dev)

    def test_disagg_golden_through_scoped_cells(self, dev, granite_36):
        disagg_golden(granite_36["cfg"], granite_36["params"], dev)

    def test_chaos_golden(self, dev, granite_36):
        chaos_golden(granite_36["cfg"], granite_36["params"], dev)

    def test_batched_streams_and_forward(self, dev, granite_36):
        """Three requests served together give each one's stream alone;
        ``forward`` of a prompt and its tokens gives the logits of
        ``prefill`` and ``decode_step`` within 1e-3 x max |logit|."""
        cfg, params = granite_36["cfg"], granite_36["params"]
        rng = np.random.default_rng(5)
        shapes = ((5, 6), (9, 4), (3, 7))
        prompts = [rng.integers(0, cfg.vocab, size=n) for n, _m in shapes]

        def serve(idx: list[int]) -> list[list[int]]:
            eng = ServingEngine(cfg, params, slots=len(idx), max_seq=32,
                                device=dev)
            reqs = [Request(rid=i, prompt=prompts[i], max_new=shapes[i][1])
                    for i in idx]
            for r in reqs:
                eng.submit(r)
            eng.run()
            return [r.out for r in reqs]

        together = serve([0, 1, 2])
        assert together == [serve([i])[0] for i in range(3)]
        seq = np.concatenate([prompts[1], np.asarray(together[1][:-1])])
        cache = M.init_cache(cfg, 1, 32, torch.float32, device=dev)
        logits, cache = M.prefill(cfg, params, {"tokens": torch.as_tensor(
            prompts[1][None].astype(np.int32), device=dev)}, cache)
        for j, tok in enumerate(together[1][:-1]):
            logits, cache = M.decode_step(
                cfg, params, cache,
                torch.tensor([[tok]], dtype=torch.int32, device=dev),
                torch.tensor(len(prompts[1]) + j, dtype=torch.int32,
                             device=dev))
        fwd, _ = M.forward(cfg, params, {"tokens": torch.as_tensor(
            seq[None].astype(np.int32), device=dev)})
        scale = float(fwd[0, -1].abs().max())
        err = float((fwd[0, -1] - logits[0]).abs().max())
        assert err <= 1e-3 * scale, (err, scale)

    def test_daemon_scenario_mode_and_drain_under_faults(self, dev,
                                                         granite_36):
        """``ServeDaemon`` in scenario mode gives ``run_scenario(disagg=,
        autoscale=)``'s trace; a drain under handoff and ``backend.scan``
        faults ends with nothing in flight and every arrival accounted
        for."""
        from repro_torch.serving.daemon import ServeDaemon

        cfg, params = granite_36["cfg"], granite_36["params"]
        planner = OffloadPlanner(cfg, device=dev)
        faults.reset()
        spec = make_scenario("bursty", seed=3, slots=4, quick=True)
        kw = dict(policy="hysteresis",
                  disagg=DisaggConfig(prefill_budget=2, handoff_bound=3,
                                      starvation_age=4),
                  slo=assign_slo(spec),
                  autoscale=AutoscaleConfig(min_slots=1))
        want = run_scenario(spec, cfg, params, planner, device=dev, **kw)
        daemon = ServeDaemon(cfg, params, planner, scenario=spec, device=dev,
                             **kw)
        daemon.run()
        assert (json.dumps(daemon.trace(), sort_keys=True)
                == json.dumps(want, sort_keys=True))
        inj = faults.FaultInjector()
        holder = {}

        def on_tick(t, eng):
            faults.set_tick(t)
            if t == 4:
                holder["d"].drain()
            if t in (5, 7):
                inj.arm("handoff", count=1)
            if t == 6:
                inj.arm("backend.scan", count=1)
                engine.lane_cache_clear()
                eng.controller.replan(1, refresh=True)

        drained = ServeDaemon(cfg, params, planner, scenario=spec,
                              disagg=kw["disagg"], on_tick=on_tick,
                              device=dev)
        holder["d"] = drained
        try:
            with faults.fault_scope(inj), \
                    faults.retry_scope(retries=2, clock=faults.VirtualClock()):
                drain = drained.run()
        finally:
            faults.set_tick(None)
            faults.reset()
        acct = drain["accounting"]
        assert drain["draining"] and acct["in_flight"] == 0, drain
        assert acct["ingested"] == acct["completed"] + acct["shed"], acct
        assert acct["dropped"] + acct["ingested"] == len(spec.arrivals)
        assert inj.injected >= 3

    def test_serve_trace_under_a_lane_mesh(self, dev, granite_36):
        """``serve_trace.json`` replayed with ``mesh=4`` (four shards of
        the card): the golden, every shard launching the kernel, and no
        mesh scope left behind."""
        cfg, params = granite_36["cfg"], granite_36["params"]
        shards = [f"engine.mesh_launches.{k}" for k in range(4)]
        trace.reset(*shards)
        fixture = golden("serve_trace")
        got = replay_trace(fixture, cfg, params,
                           OffloadPlanner(cfg, device=dev), mesh=4,
                           device=dev)
        assert engine.lane_mesh() is None
        assert json.loads(json.dumps(got)) == fixture
        assert all(trace.totals().counter(k) > 0 for k in shards)


def _lane_cache_row_and_ttfb(text: str) -> tuple[dict, float]:
    ttfb = re.search(r"^serve/time_to_first_batch,([0-9.]+)$", text, re.M)
    assert ttfb is not None, f"no time_to_first_batch row:\n{text}"
    return torch_card.lane_cache_row(text), float(ttfb.group(1))


def test_warm_start_round_trip_in_fresh_processes(dev, tmp_path):
    """The launcher twice on one cache directory: the second process
    loads every lane the first saved, resolves none, and reaches its
    first batch no later."""
    argv = ["--scenario", "bursty", "--policy", "hysteresis", "--quick",
            "--cache-dir", str(tmp_path)]
    cold, _ = torch_card.run_launcher(argv)
    warm, _ = torch_card.run_launcher(argv)
    saved = int(cold.split("warm start: saved ")[1].split()[0])
    (cold_row, cold_ttfb), (warm_row, warm_ttfb) = (
        _lane_cache_row_and_ttfb(cold), _lane_cache_row_and_ttfb(warm))
    assert saved > 0 and cold_row["misses"] > 0
    assert f"{saved} lanes loaded" in warm
    assert warm_row["misses"] == 0 and warm_row["hits"] > 0
    assert warm_ttfb <= cold_ttfb


def test_serve_launcher_monolithic_in_a_fresh_process(dev):
    text, _ = torch_card.run_launcher(["--requests", "8"])
    assert "served 8 requests (monolithic engine)" in text, text


def test_serve_launcher_daemon_mode_in_a_fresh_process(dev, tmp_path):
    """``--daemon --autoscale --chaos --trace-out F --quick``: nothing
    unhandled or in flight, requests completed, and the streamed trace
    loads with one batch a tick and the autoscaler's limits."""
    from repro_torch.serving.daemon import TraceWriter

    path = tmp_path / "trace.jsonl"
    text, _ = torch_card.run_launcher(["--daemon", "--autoscale", "--chaos",
                                       "--trace-out", str(path), "--quick"])
    row = re.search(r"^serve/daemon,(.*)$", text, re.M)
    assert row is not None, text
    assert re.search(r"^serve/chaos,(.*)$", text, re.M) is not None, text
    fields = dict(kv.split("=") for kv in row.group(1).split(","))
    loaded = TraceWriter.load(path)
    assert fields["unhandled"] == "0" and fields["in_flight"] == "0"
    assert int(fields["completed"]) > 0
    assert len(loaded["per_tick_batch"]) == int(fields["ticks"])
    assert loaded["autoscale"]["limits"]


# ---------------------------------------------------------------------
# Training and the dry-run's PIM report
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", [name for name, cfg in ARCHS.items()
                                  if cfg.input_mode == "tokens"])
def test_smoke_train_step_on_card_equals_cpu(dev, arch):
    """``loss_fn``'s loss and grads and one trainer step on the card ==
    on the CPU within float32 noise, every token-input arch."""
    msg, _ = torch_card.train_smoke_mismatch(smoke_config(ARCHS[arch]), dev)
    assert msg is None, msg


def test_train_fixture_on_card(dev):
    """``tests/golden/torch_train_steps.json``: four JAX ``Trainer``
    steps of granite-8b at its published widths cut to 2 layers, held to
    the fixture's tolerances (``torch_card.train_mismatch``)."""
    _full_f32()
    fx = golden("torch_train_steps")
    cfg = dataclasses.replace(ARCHS[fx["arch"]], n_layers=fx["n_layers"])
    params = params_from_numpy(draw_numpy_params(cfg, fx["seed"]), dev)
    got = torch_card.port_train_run(fx, cfg, params, dev)
    msg, _worst = torch_card.train_mismatch(fx, got)
    assert msg is None, msg


@pytest.mark.parametrize("size", ["smoke", "8_layers"])
def test_checkpoint_round_trip_on_card(dev, tmp_path, size):
    """A trainer on the card checkpoints at step 2; a fresh one restores
    the tree bit-equal and its step 3 gives the first one's loss.
    ``smoke``: the trainer's own periodic save.  ``8_layers``: granite-8b
    at its published widths cut to 8 of 36 layers (2.15 B parameters,
    ~50 GB on the card), batch 8 x 512, two microbatches, int8
    compression, recomputed blocks; one checkpoint written by
    ``checkpoint.save`` (a 25.8 GB tree), the first trainer's losses
    finite through step 6, step 3's loss within 1e-5."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.grad_compress import CompressionConfig
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.trainer import TrainConfig, Trainer

    if size == "smoke":
        cfg = smoke_config(ARCHS["granite-8b"])
        tcfg = TrainConfig(lr=3e-3, warmup=1, total_steps=10, microbatches=2,
                           ckpt_every=2, ckpt_dir=str(tmp_path))
        batch, seq, rel, steps = 4, 16, 1e-6, 3
    else:
        cfg = dataclasses.replace(ARCHS["granite-8b"], n_layers=8)
        tcfg = TrainConfig(lr=3e-4, warmup=2, total_steps=6, microbatches=2,
                           compression=CompressionConfig("int8"),
                           ckpt_every=1 << 30, ckpt_dir=str(tmp_path),
                           remat=True)
        batch, seq, rel, steps = 8, 512, 1e-5, 6
    src = SyntheticLM(cfg.vocab, seed=0)
    batches = [to_device(src.batch(s, batch, seq), dev)
               for s in range(steps)]
    a = Trainer(cfg, tcfg, generator=torch.Generator(dev).manual_seed(0))
    a.train(iter(batches[:2]), 2, log_every=1 << 30)
    saved = tree_map(lambda t: t.detach().to("cpu", copy=True),
                     (a.params, a.opt))
    if size != "smoke":
        CKPT.save(str(tmp_path), a.step, saved)
    hist = a.train(iter(batches[2:]), steps - 2, log_every=1 << 30)
    assert len(hist) == steps                   # the trainer's whole history
    assert all(math.isfinite(h["loss"]) for h in hist)
    la = hist[2]["loss"]                        # step 3
    del a
    gc.collect()
    torch.cuda.empty_cache()
    b = Trainer(cfg, tcfg, generator=torch.Generator(dev).manual_seed(1))
    assert b.restore_latest() and b.step == 2
    for want, got in zip(tree_leaves(saved), tree_leaves((b.params, b.opt))):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    del saved
    lb = b.train(iter(batches[2:3]), 1, log_every=1 << 30)[-1]["loss"]
    assert abs(la - lb) <= rel * abs(la)


@pytest.mark.parametrize("cmd,want", [
    (["-m", "repro_torch.launch.train", "--smoke", "--steps", "20",
      "--microbatches", "2", "--compression", "int8", "--simulate-failure",
      "--ckpt-dir", "{tmp}"], "done:"),
    (["examples/torch_train_small.py", "--steps", "40"], "loss "),
    (["examples/torch_quickstart.py"], "== numpy GEMV? True")],
    ids=["train_launcher", "torch_train_small", "torch_quickstart"])
def test_training_entry_points_in_fresh_processes(dev, tmp_path, cmd, want):
    """The train launcher (a simulated failure and its restart) ends with
    a finite ``done:`` loss; the examples print what they promise."""
    module = cmd[0] == "-m"
    args = [a.format(tmp=tmp_path) for a in cmd[module:]]
    if not module:
        args[0] = str(ROOT / args[0])
    text, _ = torch_card.run_module(args, module=module)
    assert want in text, text[-2000:]
    if module:
        done = [ln for ln in text.splitlines() if ln.startswith("done:")]
        assert math.isfinite(float(done[-1].split("=")[-1])), done


def test_pim_report_golden_on_card(dev, monkeypatch, tmp_path):
    """granite-8b's report (bursty x hysteresis, disaggregated) on the
    card == ``tests/golden/torch_pim_report.json``, through the kernel."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    before = scans()
    rec = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                    policy="hysteresis", disagg=True,
                                    device=dev)
    assert scans() > before
    assert json.loads(json.dumps(rec)) == golden("torch_pim_report")


def test_pim_report_on_card_equals_cpu(dev, monkeypatch, tmp_path):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "ARCHS",
                        {"granite-8b": smoke_config(ARCHS["granite-8b"])})
    before = scans()
    card = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                     policy="hysteresis", disagg=True,
                                     device=dev)
    assert scans() > before
    engine.lane_cache_reset()
    cpu = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                    policy="hysteresis", disagg=True,
                                    device="cpu")
    assert json.loads(json.dumps(card)) == json.loads(json.dumps(cpu))


def test_dryrun_pim_all_in_a_fresh_process(dev):
    """``python -m repro_torch.launch.dryrun --pim --all`` exits 0 and
    reports every arch."""
    text, _ = torch_card.run_module(["repro_torch.launch.dryrun", "--pim",
                                     "--all"], timeout=400)
    reported = set(re.findall(r"^\[pim\] (\S+):", text, re.M))
    assert reported == set(ARCHS), sorted(reported)


# ---------------------------------------------------------------------
# The lane mesh and the cell lowering
# ---------------------------------------------------------------------

def test_lane_mesh_and_threaded_rungs_on_card(dev):
    """The granite-8b plan's lanes on four shards of the card, and on the
    threaded rung over two entries of it, equal the scan rung's, each
    shard launching the kernel on its own stream."""
    spec_pts = [(DEFAULT_SYSTEM.derive_cycles(), list(streams))
                for streams in _granite_streams()]
    solo = engine.resolve_fleet(spec_pts, device=dev)
    engine.lane_cache_reset()
    shards = [f"engine.mesh_launches.{k}" for k in range(4)]
    trace.reset(*shards)
    with engine.lane_mesh_scope(engine.build_lane_mesh(4, [dev] * 4)):
        assert engine.ladder_rungs() == ["mesh", "scan"]
        meshed = engine.resolve_fleet(spec_pts, device=dev)
    assert all(trace.totals().counter(k) > 0 for k in shards)
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
    """granite-8b's report over a lane mesh of four shards of the card ==
    the golden, every shard launching the kernel at least once, and the
    mesh scope gone after it."""
    from repro_torch.launch import dryrun
    fx = golden("torch_pim_report")
    shards = [f"engine.mesh_launches.{k}" for k in range(4)]
    trace.reset(*shards)
    with engine.lane_mesh_scope(engine.build_lane_mesh(4, [dev] * 4)):
        assert engine.ladder_rungs() == ["mesh", "scan"]
        rec = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                        policy="hysteresis", disagg=True,
                                        device=dev)
    assert engine.lane_mesh() is None
    assert json.loads(json.dumps(rec)) == fx
    assert all(trace.totals().counter(k) >= 1 for k in shards)


def test_pim_report_on_card_steps_down_from_a_failing_mesh(dev):
    """The same report with every ``backend.mesh`` launch failing: the
    ladder steps down to ``backend.scan``, which never faults and
    launches the kernel, and the report is unchanged."""
    from repro_torch.launch import dryrun
    faults.reset_events()
    inj = faults.FaultInjector()
    inj.arm("backend.mesh", count=1_000_000)
    before = scans()
    try:
        with faults.fault_scope(inj), faults.retry_scope(
                retries=1, clock=faults.VirtualClock()), \
                engine.lane_mesh_scope(engine.build_lane_mesh(4, [dev] * 4)):
            rec = dryrun.pim_offload_report("granite-8b", scenario="bursty",
                                            policy="hysteresis", disagg=True,
                                            device=dev)
        steps = [(e["site"], e["kind"]) for e in faults.events()]
    finally:
        faults.reset()          # events, injector and the tripped breaker
    assert json.loads(json.dumps(rec)) == golden("torch_pim_report")
    assert ("backend.mesh", "degrade") in steps
    assert not any(site == "backend.scan" for site, _k in steps)
    assert scans() > before


def test_dryrun_pim_under_a_lane_mesh_in_a_fresh_process(dev):
    """``dryrun --pim --mesh 4`` takes the lane mesh and writes the
    golden report."""
    text, _ = torch_card.run_module(
        ["repro_torch.launch.dryrun", "--pim", "--arch", "granite-8b",
         "--scenario", "bursty", "--policy", "hysteresis", "--disagg",
         "--mesh", "4"], timeout=300)
    assert "[pim] lane mesh: 4 shard(s)" in text, text[-2000:]
    got = json.loads((ROOT / "experiments/dryrun_torch/pim/granite-8b.json")
                     .read_text())
    assert got == golden("torch_pim_report")


@pytest.mark.parametrize("arch,shape,mesh,variant", [
    ("granite-8b", "decode_32k", "pod1", "baseline"),
    ("granite-8b", "train_4k", "pod1", "baseline"),
    ("granite-8b", "prefill_32k", "pod1", "baseline"),
    ("granite-8b", "train_4k", "pod2", "baseline"),
    ("dbrx-132b", "decode_32k", "pod1", "baseline"),
    ("granite-8b", "decode_32k", "pod1", "serve-tp-w4-kv8")])
def test_cell_lowers_on_cuda_fake_tensors(dev, arch, shape, mesh, variant):
    """The cell traced on the card's device type over the fake 512-rank
    group (nothing is allocated), with its cost extrapolation."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape, mesh == "pod2", save=False,
                          variant=variant, device=dev)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["device_type"] == "cuda"
    assert rec["chips"] == (512 if mesh == "pod2" else 256)
    assert not dist.is_initialized()

"""The port on the card: each test mirrors a phase of ``chip_smoke.py``.

Every test here is marked ``gpu`` and skips itself when no CUDA device
is present (decided inside the test, never at import).  The file imports
only torch, numpy and ``repro_torch`` — no JAX — so it also runs where
JAX is not installed; the pinned numbers come from the goldens the JAX
package wrote.  On a machine with a card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's ``conftest.py`` imports the JAX package.)
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import granite_8b
from repro_torch.core import engine
from repro_torch.core.pimsim import PimSimulator
from repro_torch.core.timing import (DEFAULT_SYSTEM, LpddrTimings, PimSpec,
                                     SystemSpec)
from repro_torch.kernels import lane_scan
from repro_torch.pimkernel.executor import (FunctionalGemv, GemvRequest,
                                            PimExecutor)
from repro_torch.pimkernel.tileconfig import ALL_DTYPES, PimDType
from repro_torch.serving.offload import OffloadPlanner

GOLDEN = pathlib.Path(__file__).parent / "golden"
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


def fuzzed(nb: int, f: int, n: int, seed: int):
    """Random timing rows (some large enough to wrap int32) and streams
    with ragged lengths, out-of-range opcodes and banks, junk tails."""
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
    return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
                 for x in (cycs, streams, lengths))


@pytest.mark.parametrize("nb", lane_scan.SUPPORTED_BANKS)
def test_kernel_matches_plain_fuzzed(dev, nb):
    kernel_equals_plain(*fuzzed(nb, 24, 128, seed=nb), nb, dev)


@pytest.mark.parametrize("bankgroups", [2, 3, 4])
def test_kernel_matches_plain_probe_lane(dev, bankgroups):
    spec = SystemSpec(timings=LpddrTimings(num_bankgroups=bankgroups))
    nb = spec.timings.num_banks
    probe = lane_scan.probe_stream(nb)[None].contiguous()
    kernel_equals_plain(engine.pack_cycles([spec.derive_cycles()]), probe,
                        torch.tensor([16], dtype=torch.int32), nb, dev)


def test_kernel_matches_plain_on_pim_streams(dev):
    planned = PimExecutor(device=dev).plan_many(
        [GemvRequest.pim(256, 2048, PimDType.W8A16, fence=True)])[0]
    kernel_equals_plain(*engine.pack_lanes([(planned.ctx.cyc, s)
                                            for s in planned.streams]),
                        16, dev)


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

"""The plain references against the program (``repro_torch``) at smoke
widths on the CPU, and the lane resolver's jump against stepping every
command."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tinyroot

from bench import judge, program
from bench.drivers import serve
from bench.reference import model as ref_model
from bench.reference import sim

SPECS = [{}, {"timings": {"data_rate_mtps": 6400, "tRCD": 21.0, "tRP": 21.0,
                          "tRAS": 48.0, "tRC": 70.0, "tRL": 18.0},
              "pim": {"mac_interval_ck": 4}, "num_channels": 2},
         {"timings": {"tRL": 27.0, "tRCD": 24.0, "tRP": 24.0},
          "fence_ns": 450.0}]


@pytest.mark.parametrize("spec", SPECS, ids=["server", "phone", "cxl"])
def test_simulated_points_equal_the_program(spec):
    from repro_torch.core.pimsim import PimSimulator
    from repro_torch.pimkernel.executor import PimExecutor
    from repro_torch.serving.offload import OffloadPlanner

    cfg = dict(tinyroot.TINY)
    planned, results = {}, {}
    real_plan, real_run = PimExecutor.plan_many, PimExecutor.run_many

    def plan_many(self, reqs):
        out = real_plan(self, reqs)
        for p in out:
            planned[(p.req.kind, p.req.H, p.req.W)] = list(p.streams)
        return out

    def run_many(self, reqs):
        out = real_run(self, reqs)
        for r, res in zip(reqs, out):
            results[(r.kind, r.H, r.W)] = res
        return out

    PimExecutor.plan_many, PimExecutor.run_many = plan_many, run_many
    try:
        planner = OffloadPlanner(program.arch(cfg),
                                 sim=PimSimulator(device="cpu"))
        decisions = planner.plan_grid([program.spec(spec)])[0]
    finally:
        PimExecutor.plan_many, PimExecutor.run_many = real_plan, real_run
    sites = {s.name: s for s in sim.decode_sites(cfg)}
    by_site = {(k, n): results[(k, s.h, s.w)] for n, s in sites.items()
               for k in ("pim", "baseline")}
    streams = {(k, n): planned[(k, s.h, s.w)] for n, s in sites.items()
               for k in ("pim", "baseline")}
    got = judge.spec_points(cfg, spec, decisions, by_site, streams, "W8A8",
                            True)
    assert got["compared"] == 2 * len(sites)
    assert (got["streams"], got["lanes"], got["points"], got["decisions"],
            got["gap"]) == (0, 0, 0, 0, 0.0)


def test_full_width_streams_equal_the_program():
    from repro_torch.pimkernel.executor import GemvRequest, PimExecutor

    spec = program.spec(SPECS[1])
    for h, w in ((4096, 4096), (1024, 4096)):
        for req in (GemvRequest.pim(h, w, "W8A8", fence=True,
                                    reshape=h < 2048, spec=spec),
                    GemvRequest.baseline(h, w, "W8A8", spec=spec)):
            p = PimExecutor(device="cpu").plan_many([req])[0]
            ref = sim.point(req.kind, h, w, "W8A8",
                            sim.spec_from_dict(SPECS[1]), True, h < 2048)
            assert all(np.array_equal(a, b)
                       for a, b in zip(p.streams, ref.streams))


@pytest.mark.parametrize("kind", ["pim", "baseline"])
def test_the_jump_equals_stepping_every_command(kind):
    spec = sim.spec_from_dict(SPECS[2])
    p = sim.point(kind, 4096, 4096, "W8A8", spec, True, False)
    for s in {id(x): x for x in p.streams}.values():
        assert sim.resolve_total(s, sim.cycles(spec), jump=False) == \
            sim.resolve_total(s, sim.cycles(spec))


def test_the_jump_on_random_repeated_blocks():
    rng = np.random.default_rng(7)
    cyc = sim.cycles(sim.Spec())
    ops = [sim.ACT, sim.PRE, sim.RD, sim.WR, sim.MAC, sim.WR_SRF,
           sim.RD_ACC, sim.FENCE, sim.PRE_MB, sim.MOV_ACC]
    for _ in range(30):
        block = np.zeros((int(rng.integers(1, 12)), 4), np.int32)
        block[:, 0] = rng.choice(ops, size=len(block))
        block[:, 1] = rng.integers(0, 16, size=len(block))
        head = np.zeros((int(rng.integers(0, 9)), 4), np.int32)
        head[:, 0] = rng.choice(ops, size=len(head))
        s = np.concatenate([head, np.tile(block, (int(rng.integers(5, 60)),
                                                  1)), head])
        assert sim.resolve_total(s, cyc, jump=False) == \
            sim.resolve_total(s, cyc)


def test_the_model_reference_equals_the_program_forward():
    from repro_torch.models import model as M

    cfg = dict(tinyroot.TINY)
    params = serve.make_weights(cfg, 2 ** 31 + 3, torch.device("cpu"))
    tokens = torch.randint(0, cfg["vocab"], (1, 40),
                           generator=torch.Generator().manual_seed(0))
    want = M.forward(program.arch(cfg), params, {"tokens": tokens},
                     remat=False)
    want = want[0] if isinstance(want, tuple) else want
    got = ref_model.logits(cfg, params, tokens[0], range(0, 40))
    torch.testing.assert_close(got, want[0].float(), rtol=1e-4, atol=1e-4)

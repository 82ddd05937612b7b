"""Result assembly of the port's executor against the JAX package's: every
``PimResult`` field of ``run_many`` over specs of 1, 2 and 4 channels, with
baseline and PIM requests, fence off and on; the counts path of the energy
model against ``gemv_energy_summary`` on streams that share arrays; and
each distinct stream array histogrammed once a call."""
import dataclasses

import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.core import energy as ref_energy
from repro.core import engine as ref_engine
from repro.core.timing import DEFAULT_SYSTEM as REF_DEFAULT
from repro.pimkernel.executor import GemvRequest as RefRequest
from repro.pimkernel.executor import PimExecutor as RefExecutor

from repro_torch.core import commands as C
from repro_torch.core import energy, engine
from repro_torch.core.timing import spec_from_dict
from repro_torch.pimkernel.executor import GemvRequest, PimExecutor

SHAPES = [(64, 512, "W8A8", False), (130, 512, "W4A8", True),
          (128, 256, "W8A16", False)]


@pytest.fixture(autouse=True)
def fresh_caches():
    for eng in (engine, ref_engine):
        eng.lane_cache_reset()
    yield
    for eng in (engine, ref_engine):
        eng.lane_cache_reset()


def _requests(channels: int, fence: bool):
    ref_spec = dataclasses.replace(REF_DEFAULT, num_channels=channels)
    spec = spec_from_dict(dataclasses.asdict(ref_spec))
    reqs, ref_reqs = [], []
    for h, w, dt, reshape in SHAPES:
        reqs.append(GemvRequest.pim(h, w, dt, fence=fence, reshape=reshape,
                                    spec=spec))
        ref_reqs.append(RefRequest.pim(h, w, dt, fence=fence,
                                       reshape=reshape, spec=ref_spec))
        reqs.append(GemvRequest.baseline(h, w, dt, spec=spec))
        ref_reqs.append(RefRequest.baseline(h, w, dt, spec=ref_spec))
    return reqs, ref_reqs


@pytest.mark.parametrize("fence", [False, True])
@pytest.mark.parametrize("channels", [1, 2, 4])
def test_run_many_results_match_reference(channels, fence):
    reqs, ref_reqs = _requests(channels, fence)
    got = PimExecutor(device="cpu").run_many(reqs)
    want = RefExecutor().run_many(ref_reqs)
    assert len(got) == len(want) == 2 * len(SHAPES)
    for g, w in zip(got, want):
        assert (g.cycles, g.ns, g.flops, g.weight_bytes, g.utilization,
                g.split, g.meta) == (w.cycles, w.ns, w.flops,
                                     w.weight_bytes, w.utilization,
                                     w.split, w.meta)
        assert g.energy == w.energy
        assert len(g.energy["channels"]) == channels
        np.testing.assert_array_equal(g.counts, w.counts)
        assert g.counts.dtype == np.int64


def test_counts_energy_equals_streams_energy_on_shared_arrays():
    rng = np.random.default_rng(5)
    spec = spec_from_dict(dataclasses.asdict(REF_DEFAULT))
    a, b = (rng.integers(0, C.NUM_OPCODES, size=(n, 4)).astype(np.int32)
            for n in (300, 77))
    streams = [a, b, a, a]               # one array held by three channels
    totals = rng.integers(1, 10_000, size=4).astype(np.int32)
    hist = {id(s): C.op_counts(s) for s in streams}
    for banks in (1, 7, 16):
        got = energy.counts_energy_summary([hist[id(s)] for s in streams],
                                           totals, spec, 4321,
                                           active_banks=banks)
        assert got == energy.gemv_energy_summary(streams, totals, spec,
                                                 4321, active_banks=banks)
        assert got == ref_energy.gemv_energy_summary(streams, totals,
                                                     REF_DEFAULT, 4321,
                                                     active_banks=banks)


def test_each_distinct_stream_array_is_counted_once(monkeypatch):
    reqs, _ = _requests(4, True)
    ex = PimExecutor(device="cpu")
    planned = ex.plan_many(reqs)
    distinct = {id(s): s for p in planned for s in p.streams}
    assert len(distinct) < sum(len(p.streams) for p in planned)
    seen: list[int] = []
    real = C.op_counts

    def op_counts(stream):
        seen.append(id(stream))
        return real(stream)

    monkeypatch.setattr(C, "op_counts", op_counts)
    monkeypatch.setattr(ex, "plan_many", lambda _reqs: planned)
    got = ex.run_many(reqs)
    assert sorted(seen) == sorted(distinct)
    for p, res in zip(planned, got):
        want = sum(real(s) for s in p.streams)
        np.testing.assert_array_equal(res.counts, want)

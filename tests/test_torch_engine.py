"""The port's engine layer vs the JAX package's: dedupe, the resolved-lane
LRU (hits, misses, evictions, touch, integrity-tag rejection), the
fleet / streams entry points, and the executor over heterogeneous specs.

Each scenario runs the same calls against both packages and compares
the results AND the LRU counters after every step."""
import dataclasses

import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.core import engine as ref_engine
from repro.core.timing import DEFAULT_SYSTEM as REF_DEFAULT
from repro.pimkernel.executor import GemvRequest as RefRequest
from repro.pimkernel.executor import PimExecutor as RefExecutor
from repro.pimkernel.tileconfig import PimDType as RefDType

from repro_torch.core import engine
from repro_torch.core.timing import cycles_from_dict, spec_from_dict
from repro_torch.kernels import lane_scan
from repro_torch.pimkernel.executor import GemvRequest, PimExecutor
from repro_torch.pimkernel.tileconfig import PimDType

from test_conformance import FACADE_SHAPES, FACADE_SPECS, make_spec
from test_engine import build_valid_stream, random_op_tuples


@pytest.fixture(autouse=True)
def fresh_caches():
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()
    yield
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()


def port_cyc(ref_cyc):
    return cycles_from_dict(dataclasses.asdict(ref_cyc))


class Twin:
    """The same lanes in both packages (port cycles beside the
    reference's); every call checks results and LRU counters agree."""

    def __init__(self, lanes):
        self.ref_lanes = lanes
        self.lanes = [(port_cyc(c), s) for c, s in lanes]

    def resolve(self, idx, keys=None, need_issue=True):
        want = ref_engine.resolve_lanes([self.ref_lanes[i] for i in idx],
                                        keys=keys, need_issue=need_issue)
        got = engine.resolve_lanes([self.lanes[i] for i in idx],
                                   keys=keys, need_issue=need_issue,
                                   device="cpu")
        for (gi, gt), (wi, wt) in zip(got, want):
            assert gt == wt
            if need_issue:
                np.testing.assert_array_equal(gi, wi)
                assert not gi.flags.writeable
            else:
                assert gi is None and wi is None
        assert engine.lane_cache_info() == ref_engine.lane_cache_info()
        return got


def _twin(n=6, seed=0):
    rng = np.random.default_rng(seed)
    cyc = REF_DEFAULT.derive_cycles()
    return Twin([(cyc, build_valid_stream(random_op_tuples(rng,
                                                           max_ops=12)))
                 for _ in range(n)])


def test_keyed_and_byte_equal_lanes_dedupe_alike():
    tw = _twin()
    # a byte-equal copy of lane 0 as a distinct unkeyed array
    tw.ref_lanes.append((tw.ref_lanes[0][0], tw.ref_lanes[0][1].copy()))
    tw.lanes.append((tw.lanes[0][0], tw.lanes[0][1].copy()))
    got = tw.resolve([0, 1, 0, 2, 6], keys=["k0", "k1", "k0", None, None])
    assert got[0][0] is got[2][0]              # shared read-only result
    tw.resolve([0, 1, 2, 6])                   # unkeyed: byte hash path
    tw.resolve([0, 1, 3], keys=["k0", "k1", "k3"])
    info = engine.lane_cache_info()
    assert info["hits"] > 0 and info["misses"] > 0


def test_totals_only_entries_miss_when_issue_is_needed():
    tw = _twin()
    keys = [f"t{i}" for i in range(4)]
    tw.resolve([0, 1, 2, 3], keys=keys, need_issue=False)
    tw.resolve([0, 1, 2, 3], keys=keys, need_issue=False)    # hits
    tw.resolve([0, 1], keys=keys[:2], need_issue=True)       # misses
    tw.resolve([0, 1, 2], keys=keys[:3], need_issue=True)


def test_evictions_and_touch_under_capacity_pressure():
    tw = _twin(n=8, seed=1)
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(3)
    keys = [f"e{i}" for i in range(8)]
    tw.resolve(range(5), keys=keys[:5])
    assert engine.lane_cache_info()["evictions"] == 2
    cyc = tw.lanes[0][0]
    ref_cyc = tw.ref_lanes[0][0]
    assert (engine.lane_cache_touch([(cyc, "e2"), (cyc, "e9")])
            == ref_engine.lane_cache_touch([(ref_cyc, "e2"),
                                            (ref_cyc, "e9")]) == 1)
    tw.resolve([5], keys=["e5"])               # evicts an untouched lane
    hits = engine.lane_cache_info()["hits"]
    tw.resolve([2], keys=["e2"])               # the touched lane survived
    assert engine.lane_cache_info()["hits"] == hits + 1
    tw.resolve([3, 4], keys=["e3", "e4"])
    for eng in (engine, ref_engine):
        eng.lane_cache_clear()
    assert engine.lane_cache_info() == ref_engine.lane_cache_info()
    tw.resolve([0], keys=["e0"])


def test_disabled_cache_counts_nothing():
    tw = _twin(n=3)
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(0)
    tw.resolve([0, 1, 2, 1], keys=["a", "b", "c", "b"])
    assert engine.lane_cache_info() == dict(size=0, maxsize=0, hits=0,
                                            misses=0, evictions=0)


def test_corrupted_entry_is_rejected_and_resolved_cold():
    tw = _twin(n=3, seed=2)
    keys = ["p0", "p1", "p2"]
    tw.resolve([0, 1, 2], keys=keys)
    for eng, cyc in ((engine, tw.lanes[1][0]),
                     (ref_engine, tw.ref_lanes[1][0])):
        ukey = (cyc, 0, "p1")
        total, issue, tag = eng._LANE_CACHE[ukey]
        eng._LANE_CACHE[ukey] = (total + 7, issue, tag)   # stale tag
    got = tw.resolve([0, 1, 2], keys=keys)      # p1: rejected, re-resolved
    info = engine.lane_cache_info()
    assert info["misses"] == 4 and info["hits"] == 2 and info["size"] == 3
    want = ref_engine.resolve_lanes([tw.ref_lanes[1]])[0][1]
    assert got[1][1] == want


def test_resolve_fleet_and_run_streams_match():
    rng = np.random.default_rng(8)
    points, ref_points = [], []
    for bg in (2, 4, 3):
        spec = make_spec(bg, 20.0, 19.0, 44.0, 2, 12, 120.0)
        nb = spec.timings.num_banks
        streams = [build_valid_stream(
            [(k, b % nb, r, n) for (k, b, r, n)
             in random_op_tuples(rng, max_ops=10)]) for _ in range(3)]
        ref_points.append((spec.derive_cycles(), streams))
        points.append((port_cyc(spec.derive_cycles()), streams))
    keys = [[("pt", i, c) for c in range(3)] for i in range(3)]
    for kk in (None, keys):
        want = ref_engine.resolve_fleet(ref_points, keys=kk)
        got = engine.resolve_fleet(points, keys=kk, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.totals, w.totals)
            assert g.totals.dtype == w.totals.dtype
            for gi, wi in zip(g.issue, w.issue):
                np.testing.assert_array_equal(gi, wi)
    cyc, streams = ref_points[0]
    ri, rt = ref_engine.run_streams(cyc, streams)
    gi, gt = engine.run_streams(port_cyc(cyc), streams, device="cpu")
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gt, rt)
    empty = engine.run_streams(port_cyc(cyc), np.zeros((0, 5, 4), np.int32),
                               device="cpu")
    assert [a.shape for a in empty] == [(0, 5), (0,)]


def test_one_launch_per_bank_count_on_a_ragged_slab(monkeypatch):
    calls = []
    real = lane_scan.lane_scan

    def spy(cycs, streams, lengths, nb, need_issue=True):
        calls.append((nb, tuple(streams.shape), lengths.tolist()))
        return real(cycs, streams, lengths, nb, need_issue=need_issue)

    monkeypatch.setattr(lane_scan, "lane_scan", spy)
    rng = np.random.default_rng(12)
    lanes = []
    for bg in (4, 2, 4, 2, 3):
        cyc = port_cyc(make_spec(bg, 18.0, 18.0, 42.0, 3, 14, 150.0)
                       .derive_cycles())
        lanes.append((cyc, build_valid_stream(
            [(k, b % cyc.num_banks, r, n) for (k, b, r, n)
             in random_op_tuples(rng, max_ops=15)])))
    engine.resolve_lanes(lanes, device="cpu")
    assert [c[0] for c in calls] == [8, 12, 16]
    for nb, shape, lengths in calls:
        assert shape == (sum(lengths), 4)        # true commands alone
        assert sorted(lengths) == sorted(s.shape[0] for c, s in lanes
                                         if c.num_banks == nb)


def test_executor_multi_spec_run_many_matches_reference():
    """Heterogeneous run_many (3 specs x 4 shapes, mixed bank counts)
    through both executors: every PimResult field agrees."""
    reqs, ref_reqs = [], []
    for sp in FACADE_SPECS:
        psp = spec_from_dict(dataclasses.asdict(sp))
        for (h, w, dt, f, r) in FACADE_SHAPES:
            reqs.append(GemvRequest.pim(h, w, PimDType[dt.name], fence=f,
                                        reshape=r, spec=psp))
            ref_reqs.append(RefRequest.pim(h, w, dt, fence=f, reshape=r,
                                           spec=sp))
        reqs.append(GemvRequest.baseline(256, 512, "W8A8", spec=psp))
        ref_reqs.append(RefRequest.baseline(256, 512, RefDType.W8A8,
                                            spec=sp))
    got = PimExecutor(device="cpu").run_many(reqs)
    want = RefExecutor().run_many(ref_reqs)
    for g, w in zip(got, want):
        assert (g.cycles, g.ns, g.flops, g.weight_bytes, g.utilization,
                g.split, g.energy) == (w.cycles, w.ns, w.flops,
                                       w.weight_bytes, w.utilization,
                                       w.split, w.energy)
        np.testing.assert_array_equal(g.counts, w.counts)
    assert engine.lane_cache_info()["misses"] > 0


def test_touch_many_pins_planned_lanes():
    ex = PimExecutor(device="cpu")
    reqs = [GemvRequest.pim(64, 512, "W8A8"),
            GemvRequest.baseline(64, 512, "W8A8")]
    assert ex.touch_many(reqs) == 0
    ex.run_many(reqs)
    before = engine.lane_cache_info()
    assert ex.touch_many(reqs) > 0
    assert engine.lane_cache_info() == before

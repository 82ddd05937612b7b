"""The port's lane mesh and threaded rungs, held to the JAX engine.

The port of ``tests/test_mesh.py``.  A lane mesh is a 1-D list of torch
devices; here ``["cpu"] * m``, the way the JAX package forces host
devices, so every rung runs the plain lane resolver (~0.7 ms a command)
and the fleets stay tiny.  Checked: the mesh, threaded and scan rungs
give the JAX engine's issue arrays and totals bit for bit; the mesh
width is the reference's; padded lanes never reach results or the LRU;
a fleet wider than one slab; ``lane_devices`` follows reconfiguration;
``configure_lane_mesh`` validates and its scope restores; the LRU's
counters and eviction order under a mesh are the reference's
single-device run's; and a ``backend.mesh`` fault steps down to
``backend.scan`` with the same results and the reference's event text.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:        # collection must never hard-fail
    HAVE_HYPOTHESIS = False

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.core import engine as ref_engine
from repro.core import faults as ref_faults
from repro.core.timing import DEFAULT_SYSTEM as REF_DEFAULT

from repro_torch.core import engine, faults
from repro_torch.core.timing import cycles_from_dict
from repro_torch.launch import mesh as LM

from test_conformance import fleet_from_seed
from test_engine import build_valid_stream, random_op_tuples

CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def _clean():
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()
        eng.reset_backend_scopes()
    yield
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()
        eng.reset_backend_scopes()


@contextlib.contextmanager
def one_torch_thread():
    """One intra-op thread for the block: the plain lane resolver's small
    ops run fastest so, and the suite's worker processes share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def rung_runs(monkeypatch) -> list:
    """The ``backend.<rung>`` (and other) retry sites whose call ran to
    its end, in order: ``faults.retry_call`` recorded on its way back
    for the rest of the test."""
    ran = []
    real = faults.retry_call

    def spy(fn, site, *args, **kwargs):
        out = real(fn, site, *args, **kwargs)
        ran.append(site)
        return out
    monkeypatch.setattr(faults, "retry_call", spy)
    return ran


def backend_rungs(ran) -> set:
    return {site for site in ran if site.startswith("backend.")}


def port_cyc(ref_cyc):
    return cycles_from_dict(dataclasses.asdict(ref_cyc))


def _points(ref_points):
    """(reference points, port points) of a (spec, streams) fleet."""
    ref = [(sp.derive_cycles(), streams) for sp, streams in ref_points]
    return ref, [(port_cyc(c), s) for c, s in ref]


def _assert_same(fleet_a, fleet_b):
    for a, b in zip(fleet_a, fleet_b):
        np.testing.assert_array_equal(a.totals, b.totals)
        for ia, ib in zip(a.issue, b.issue):
            np.testing.assert_array_equal(ia, ib)


def assert_rungs_match_reference(points, m: int = 3):
    """One fleet resolved on the mesh, threaded and scan rungs of the
    port and by the JAX engine: bit-identical."""
    ref_pts, pts = _points(points)
    want = ref_engine.resolve_fleet(ref_pts)
    with engine.lane_mesh_scope(["cpu"] * m):
        assert engine.ladder_rungs() == ["mesh", "scan"]
        meshed = engine.resolve_fleet(pts, device="cpu")
    engine.lane_cache_clear()
    engine.configure_lane_devices(["cpu"] * m)
    assert engine.ladder_rungs() == ["threaded", "scan"]
    threaded = engine.resolve_fleet(pts, device="cpu")
    engine.configure_lane_devices(None)
    engine.lane_cache_clear()
    assert engine.ladder_rungs() == ["scan"]
    solo = engine.resolve_fleet(pts, device="cpu")
    for got in (meshed, threaded, solo):
        _assert_same(want, got)


if HAVE_HYPOTHESIS:
    from test_conformance import _point_strategy

    @settings(max_examples=4, deadline=None,
              suppress_health_check=[HealthCheck.too_slow,
                                     HealthCheck.data_too_large])
    @given(st.lists(_point_strategy(), min_size=1, max_size=2))
    def test_fuzzed_mesh_parity(points):
        assert_rungs_match_reference(points)
else:                      # deterministic fallback when hypothesis absent
    @pytest.mark.parametrize("seed", range(3))
    def test_fuzzed_mesh_parity(seed):
        assert_rungs_match_reference(fleet_from_seed(seed, n_points=2),
                                     m=2 + seed)


def test_mesh_width_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 700))
        m = int(rng.integers(1, 9))
        assert engine._mesh_width(n, m) == ref_engine._mesh_width(n, m)
        assert engine._fleet_bucket(n) == ref_engine._fleet_bucket(n)
    assert engine._MAX_WIDTH == ref_engine._MAX_WIDTH


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 5, 7, 12, 19])
def test_padded_lanes_are_masked(n_lanes):
    rng = np.random.default_rng(100 + n_lanes)
    cyc = REF_DEFAULT.derive_cycles()
    ref_lanes = [(cyc, build_valid_stream(random_op_tuples(rng, max_ops=8)))
                 for _ in range(n_lanes)]
    lanes = [(port_cyc(c), s) for c, s in ref_lanes]
    keys = [("pad", n_lanes, i) for i in range(n_lanes)]
    want = ref_engine.resolve_lanes(ref_lanes, keys=keys)
    with engine.lane_mesh_scope(CPU4):
        got = engine.resolve_lanes(lanes, keys=keys, device="cpu")
    assert engine.lane_cache_info()["size"] <= n_lanes
    for (wi, wt), (gi, gt) in zip(want, got):
        assert wt == gt
        np.testing.assert_array_equal(wi, gi)


def test_mesh_handles_width_beyond_one_slab():
    """> _MAX_WIDTH x m lanes split into several chunks of m shards."""
    rng = np.random.default_rng(7)
    cyc = REF_DEFAULT.derive_cycles()
    base = build_valid_stream(random_op_tuples(rng, max_ops=3))
    ref_lanes = []
    for i in range(engine._MAX_WIDTH * 2 + 9):
        s = base.copy()
        s[:, 3] = i                     # timing-inert: distinct bytes
        ref_lanes.append((cyc, s))
    want = ref_engine.resolve_lanes(ref_lanes, need_issue=False)
    with engine.lane_mesh_scope(["cpu", "cpu"]):
        got = engine.resolve_lanes([(port_cyc(c), s) for c, s in ref_lanes],
                                   need_issue=False, device="cpu")
    assert [t for _i, t in got] == [t for _i, t in want]


def test_lane_devices_tracks_reconfiguration(monkeypatch):
    monkeypatch.delenv("REPRO_LANE_DEVICES", raising=False)
    visible = engine.visible_devices()
    assert engine.lane_devices() == visible
    engine.configure_lane_devices(1)
    assert engine.lane_devices() == visible[:1]
    engine.configure_lane_devices(CPU4)
    assert [str(d) for d in engine.lane_devices()] == CPU4
    assert engine.default_backend_scope().describe()["devices"] == 4
    engine.configure_lane_devices(None)
    assert engine.lane_devices() == visible, \
        "configure_lane_devices(None) stuck"
    monkeypatch.setenv("REPRO_LANE_DEVICES", "1")
    assert engine.lane_devices() == visible[:1]


def test_configure_lane_mesh_validation_and_scope():
    with pytest.raises(ValueError, match="lane mesh size"):
        engine.build_lane_mesh(0, CPU4)
    with pytest.raises(ValueError, match="lane mesh size"):
        engine.build_lane_mesh(5, CPU4)
    with pytest.raises(ValueError, match="1-D"):
        engine.configure_lane_mesh([["cpu"], ["cpu"]])
    assert LM.make_lane_mesh(3, CPU4) == engine.build_lane_mesh(3, CPU4)
    assert engine.lane_mesh() is None
    with pytest.raises(RuntimeError, match="boom"):
        with engine.lane_mesh_scope(CPU4):
            assert len(engine.lane_mesh()) == 4
            assert engine.default_backend_scope().describe()["mesh"] == 4
            raise RuntimeError("boom")
    assert engine.lane_mesh() is None
    with engine.lane_mesh_scope(CPU4[:2]):
        outer = engine.lane_mesh()
        with engine.lane_mesh_scope(None):
            assert engine.lane_mesh() is None
        assert engine.lane_mesh() is outer
    scope = engine.BackendScope(mesh=["cpu"] * 2, name="cell")
    assert scope.describe()["mesh"] == 2
    assert engine.ladder_rungs(scope) == ["mesh", "scan"]
    assert engine.lane_mesh_on(3, "cpu") == [engine.torch.device("cpu")] * 3


def test_lru_order_under_mesh_matches_reference():
    """Under capacity pressure the mesh rung's insertion order (groups
    by bank count and length bucket, then row order) evicts exactly what
    the reference's single-device run evicts."""
    points = fleet_from_seed(11, n_points=2)
    ref_pts, pts = _points(points)
    flat_ref = [(c, s) for c, ss in ref_pts for s in ss]
    flat = [(c, s) for c, ss in pts for s in ss]
    keys = [("lru", i) for i in range(len(flat))]
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(3)
    want = ref_engine.resolve_lanes(flat_ref, keys=keys)
    with engine.lane_mesh_scope(CPU4[:3]):
        got = engine.resolve_lanes(flat, keys=keys, device="cpu")
    for (wi, wt), (gi, gt) in zip(want, got):
        assert wt == gt
        np.testing.assert_array_equal(wi, gi)
    assert engine.lane_cache_info() == ref_engine.lane_cache_info()
    assert ([k[2] for k, *_ in engine.lane_cache_export()]
            == [k[2] for k, *_ in ref_engine.lane_cache_export()])


def test_mesh_fault_steps_down_to_scan():
    """A persistent ``backend.mesh`` fault is retried, then the resolve
    steps down to ``backend.scan``: same bytes, the reference's events."""
    points = fleet_from_seed(3, n_points=2)
    ref_pts, pts = _points(points)
    want = ref_engine.resolve_fleet(ref_pts)
    events = []
    for eng, flt, mesh, kw, p in (
            (engine, faults, CPU4[:2], dict(device="cpu"), pts),
            (ref_engine, ref_faults, 1, {}, ref_pts)):
        flt.reset_events()
        eng.lane_cache_reset()
        inj = flt.FaultInjector()
        inj.arm("backend.mesh", count=10)
        with flt.fault_scope(inj), \
                flt.retry_scope(retries=1, clock=flt.VirtualClock()), \
                eng.lane_mesh_scope(mesh):
            got = eng.resolve_fleet(p, **kw)
        _assert_same(want, got)
        events.append([(e["site"], e["kind"], e["detail"])
                       for e in flt.events()])
    assert events[0] == events[1]
    assert ("backend.mesh", "degrade") in [e[:2] for e in events[0]]

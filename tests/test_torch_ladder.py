"""The port's degradation ladder and backend scopes, held to the JAX
package's.

``resolve_lanes`` walks its scope's ladder through ``faults.retry_call``
at ``backend.<rung>`` and the scope's circuit breaker in both packages,
so the same armed faults give the same ``inject`` / ``fault`` / ``retry``
/ ``degrade`` / ``trip`` / ``skip`` events, the same injector counts and
the same totals.  On one device both ladders are ``["scan"]``; the
two-rung walks stand ``_ladder_rungs`` in with ``["threaded", "scan"]``
in both packages (the port's threaded rung is not built yet, so a fault
armed there is what exercises the walk).
"""
import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.core import engine as ref_engine
from repro.core import faults as ref_faults
from repro.core.timing import DEFAULT_SYSTEM as REF_DEFAULT

from repro_torch.core import engine, faults
from repro_torch.core.timing import DEFAULT_SYSTEM

from test_engine import build_valid_stream, random_op_tuples

PORT = (faults, engine, DEFAULT_SYSTEM, dict(device="cpu"))
REF = (ref_faults, ref_engine, REF_DEFAULT, {})


@pytest.fixture(autouse=True)
def fresh_state():
    for flt, eng, _, _ in (PORT, REF):
        eng.reset_backend_scopes()
        flt.reset()
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()
    yield
    for flt, eng, _, _ in (PORT, REF):
        eng.reset_backend_scopes()
        flt.reset()
        eng.lane_cache_reset()


def streams(seed: int, n: int, max_ops: int = 30):
    rng = np.random.default_rng(seed)
    return [build_valid_stream(random_op_tuples(rng, max_ops=max_ops))
            for _ in range(n)]


def resolve(pkg, ss, scope=None) -> list[int]:
    _flt, eng, system, kw = pkg
    eng.lane_cache_clear()
    cyc = system.derive_cycles()
    return [t for _, t in eng.resolve_lanes([(cyc, s) for s in ss],
                                            need_issue=False, scope=scope,
                                            **kw)]


def two_rungs(monkeypatch, only=None):
    """Both packages' ladders become ``["threaded", "scan"]`` (for the
    scope named ``only`` alone, when given)."""
    for eng in (engine, ref_engine):
        def rungs(scope=None, _eng=eng):
            scope = _eng.active_backend_scope() if scope is None else scope
            if only is None or scope.name == only:
                return ["threaded", "scan"]
            return ["scan"]
        monkeypatch.setattr(eng, "_ladder_rungs", rungs)


def test_backend_scan_fault_seam_equal():
    """One 4-command lane under a fault armed once at ``backend.scan``:
    the port records the reference's events and injector count."""
    ss = streams(0, 1, max_ops=4)
    runs = []
    for pkg in (PORT, REF):
        flt = pkg[0]
        inj = flt.FaultInjector()
        inj.arm("backend.scan", count=1)
        clock = flt.VirtualClock()
        with flt.fault_scope(inj), flt.retry_scope(clock=clock):
            totals = resolve(pkg, ss)
        runs.append((totals, inj.injected, flt.events(), clock.sleeps,
                     flt.backend_breaker().info()))
    assert runs[0] == runs[1]
    totals, injected, events, sleeps, _ = runs[0]
    assert injected == 1 and sleeps == [0.02]
    assert [(e["kind"], e["site"]) for e in events] == [
        ("inject", "backend.scan"), ("fault", "backend.scan"),
        ("retry", "backend.scan")]


def test_terminal_scan_failure_propagates_alike():
    ss = streams(3, 2)
    runs = []
    for pkg in (PORT, REF):
        flt, eng = pkg[0], pkg[1]
        assert eng.ladder_rungs() == ["scan"]
        inj = flt.FaultInjector()
        inj.arm("backend.scan", count=-1)
        with flt.fault_scope(inj), \
                flt.retry_scope(clock=flt.VirtualClock()):
            with pytest.raises(flt.InjectedFault):
                resolve(pkg, ss)
        runs.append((inj.injected, flt.events(),
                     flt.backend_breaker().info()))
    assert runs[0] == runs[1]
    assert runs[0][2]["failures"] == {"backend.scan": 1}


def test_real_failure_on_scan_raises(monkeypatch):
    """A build or launch error in the lane scan is retried once, then
    raised: the ladder has no rung below ``scan`` to hide it in."""
    from repro_torch.kernels import lane_scan

    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise RuntimeError("lane_scan: launch failed")

    monkeypatch.setattr(lane_scan, "lane_scan", broken)
    with faults.retry_scope(clock=faults.VirtualClock()):
        with pytest.raises(RuntimeError, match="launch failed"):
            resolve(PORT, streams(4, 2))
    assert len(calls) == 2
    assert [e["kind"] for e in faults.events()] == ["fault", "retry",
                                                    "fault"]


@pytest.mark.parametrize("count", [1, -1])
def test_two_rung_walk_equal(monkeypatch, count):
    """A transient (count 1) or persistent (count -1) fault at
    ``backend.threaded`` with breaker threshold 2 over three resolves:
    retried, stepped down, tripped, then skipped — the same events,
    breaker and totals in both packages."""
    two_rungs(monkeypatch)
    ss = streams(2, 5)
    healthy = resolve(PORT, ss)
    assert healthy == resolve(REF, ss)
    runs = []
    for pkg in (PORT, REF):
        flt, eng = pkg[0], pkg[1]
        assert eng.ladder_rungs() == ["threaded", "scan"]
        flt.configure_breaker(2)
        inj = flt.FaultInjector()
        inj.arm("backend.threaded", count=count)
        clock = flt.VirtualClock()
        with flt.fault_scope(inj), flt.retry_scope(clock=clock):
            got = [resolve(pkg, ss) for _ in range(3)]
        runs.append((got, inj.injected, flt.events(), clock.sleeps,
                     flt.backend_breaker().info()))
    assert runs[0] == runs[1]
    got, _injected, events, _sleeps, breaker = runs[0]
    assert got == [healthy] * 3
    kinds = [e["kind"] for e in events]
    if count == -1:
        assert {"fault", "retry", "degrade", "trip", "skip"} <= set(kinds)
        assert breaker["open"] == ["backend.threaded"]
    else:
        assert "degrade" not in kinds and breaker["open"] == []


def test_scope_fault_isolation_equal(monkeypatch):
    """Persistent faults on the prefill scope's top rung trip the prefill
    breaker only: the decode scope's ladder, backend, breaker and totals
    and the process breaker stay as they were, in both packages alike."""
    two_rungs(monkeypatch, only="prefill")
    ss = streams(0, 4)
    runs = []
    for pkg in (PORT, REF):
        flt, eng = pkg[0], pkg[1]
        healthy = resolve(pkg, ss)
        prefill = eng.BackendScope(name="prefill")
        decode = eng.BackendScope(name="decode")
        assert eng.ladder_rungs(prefill) == ["threaded", "scan"]
        decode_before = (eng.ladder_rungs(decode),
                         eng.resolved_lane_backend(decode))
        inj = flt.FaultInjector()
        inj.arm("backend.threaded", count=-1, message="prefill-side chaos")
        with flt.fault_scope(inj), \
                flt.retry_scope(retries=0, clock=flt.VirtualClock()):
            for _ in range(3):
                assert resolve(pkg, ss, scope=prefill) == healthy
            with eng.backend_scope(decode):
                assert resolve(pkg, ss) == healthy
        assert prefill.scope_breaker().tripped("backend.threaded")
        assert (eng.ladder_rungs(decode),
                eng.resolved_lane_backend(decode)) == decode_before
        assert decode.scope_breaker().info()["open"] == []
        assert flt.backend_breaker().info()["open"] == []
        assert eng.ladder_rungs() == ["scan"]
        runs.append((healthy, flt.events(), prefill.describe(),
                     decode.describe()))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("backend", [None, "scan", "pallas", "auto"])
def test_describe_and_rungs_equal(backend):
    """On one device the port describes a scope as the JAX package does
    where no Pallas kernel runs: ``pallas`` and ``auto`` resolve to
    ``scan``."""
    descs = []
    for eng in (engine, ref_engine):
        scope = eng.BackendScope(backend=backend, name="cell")
        descs.append((scope.describe(), eng.ladder_rungs(scope),
                      eng.BackendScope(breaker=None).describe()))
    port, ref = descs
    ref_pallas = ref_engine.resolved_lane_backend(
        ref_engine.BackendScope(backend="pallas"))
    if backend in (None, "scan") or ref_pallas == "scan":
        assert port == ref
    assert port[0]["resolved"] == "scan" and port[1] == ["scan"]
    assert port[0]["backend"] == (backend or "scan")
    assert port[0]["devices"] == 1 and port[0]["mesh"] is None


def test_default_scope_configuration_equal():
    for eng in (engine, ref_engine):
        assert eng.active_backend_scope() is eng.default_backend_scope()
        assert eng.configure_lane_backend("PALLAS") == "pallas"
        assert eng.lane_backend() == "pallas"
        with eng.lane_backend_scope("auto") as name:
            assert name == "auto" and eng.lane_backend() == "auto"
        assert eng.lane_backend() == "pallas"
        assert eng.configure_lane_backend(None) == "scan"
        with pytest.raises(ValueError, match="lane backend"):
            eng.configure_lane_backend("threaded")
        with pytest.raises(ValueError, match="lane backend"):
            eng.BackendScope(backend="mesh")
        s1 = eng.BackendScope(name="s1")
        with eng.backend_scope(s1):
            assert eng.active_backend_scope() is s1
            with eng.backend_scope(eng.BackendScope(name="s2")) as s2:
                assert eng.active_backend_scope() is s2
            assert eng.active_backend_scope() is s1
        assert eng.active_backend_scope() is eng.default_backend_scope()
        with eng.backend_scope(s1):
            eng.reset_backend_scopes()
            assert eng.active_backend_scope() is eng.default_backend_scope()


def test_default_scope_breaker_is_the_process_breaker():
    for flt, eng in ((faults, engine), (ref_faults, ref_engine)):
        default = eng.default_backend_scope()
        assert default.scope_breaker() is flt.backend_breaker()
        flt.configure_breaker(5)
        assert default.describe()["breaker"]["threshold"] == 5
        own = eng.BackendScope(name="own")
        assert own.scope_breaker() is not flt.backend_breaker()

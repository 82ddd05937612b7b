"""The port's warm start: the lane-LRU snapshot and the build cache.

The behaviours of ``tests/test_warmstart.py`` on the port: a saved lane
LRU loaded into a fresh process replays ``resolve_lanes`` with zero
resolves; saves are atomic (an injected crash or a hard kill mid-write
leaves the previous snapshot); a missing, truncated, garbage, wrong-
version, wrong-fingerprint or malformed snapshot, and one written by the
JAX package, gives a cold cache and a ``warmstart`` ``detect`` event;
import respects the capacity and a disabled cache.  Beside them, parity:
after the same work, the port's ``lane_cache_export`` equals the
reference's in keys, totals and issue arrays, and an exported
reference LRU imports into the port (``port_key`` maps its keys).
"""
import dataclasses
import enum
import importlib
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke
from repro.core import engine as ref_engine
from repro.core import warmstart as ref_warmstart
from repro.serving.offload import OffloadPlanner as RefPlanner

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import engine, faults, warmstart
from repro_torch.core.timing import DEFAULT_SYSTEM
from repro_torch.kernels import build
from repro_torch.serving.offload import OffloadPlanner

from test_engine import build_valid_stream, random_op_tuples

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))


def port_key(x):
    """A reference lane-cache key (or any part of one) as the port's:
    dataclasses and enums of ``repro.*`` become the same-named ones of
    ``repro_torch.*``; tuples and frozensets map element-wise."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = _port_class(x)
        return cls(**{f.name: port_key(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
    if isinstance(x, enum.Enum):
        return _port_class(x)[x.name]
    if isinstance(x, (tuple, frozenset)):
        return type(x)(port_key(v) for v in x)
    return x


def _port_class(x):
    mod = type(x).__module__
    assert mod.startswith("repro."), mod
    return getattr(importlib.import_module("repro_torch" + mod[5:]),
                   type(x).__name__)


def port_entries(ref_entries):
    """``ref_engine.lane_cache_export()`` entries with port keys."""
    return [(port_key(k), total, issue) for k, total, issue in ref_entries]


def _lanes(seed: int, n: int = 5):
    rng = np.random.default_rng(seed)
    cyc = DEFAULT_SYSTEM.derive_cycles()
    return [(cyc, build_valid_stream(random_op_tuples(rng, max_ops=30)))
            for _ in range(n)]


def _keys(n: int = 5):
    return [("warm", i) for i in range(n)]


def _resolve(lanes, keys=None):
    return engine.resolve_lanes(lanes, keys=keys or _keys(len(lanes)),
                                need_issue=False, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_lane_cache():
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()
    faults.reset()
    yield
    for eng in (engine, ref_engine):
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()
    faults.reset()


def _child(code: str, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, TESTS] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                        else []))
    return subprocess.run([sys.executable, "-c", code, *args],
                          capture_output=True, text=True, env=env)


# ---------------------------------------------------------------------
# Round trip: save -> (fresh state) -> load -> replay with zero resolves
# ---------------------------------------------------------------------

def test_snapshot_round_trip_zero_misses(tmp_path):
    lanes = _lanes(0)
    want = _resolve(lanes)
    assert warmstart.save_lane_snapshot(str(tmp_path)) == 5
    engine.lane_cache_reset()
    assert warmstart.load_lane_snapshot(str(tmp_path)) == 5
    info = engine.lane_cache_info()
    assert info["misses"] == 0 and info["hits"] == 0   # import is silent
    got = _resolve(lanes)
    info = engine.lane_cache_info()
    assert info["misses"] == 0 and info["hits"] == 5
    assert [t for _, t in want] == [t for _, t in got]


def test_snapshot_round_trip_fresh_process(tmp_path):
    lanes = _lanes(7)
    want = _resolve(lanes)
    warmstart.save_lane_snapshot(str(tmp_path))
    out = _child(
        "import json, sys\n"
        "import numpy as np\n"
        "from repro_torch.core import engine, warmstart\n"
        "from repro_torch.core.timing import DEFAULT_SYSTEM\n"
        "from test_engine import build_valid_stream, random_op_tuples\n"
        "n = warmstart.load_lane_snapshot(sys.argv[1])\n"
        "rng = np.random.default_rng(7)\n"
        "cyc = DEFAULT_SYSTEM.derive_cycles()\n"
        "lanes = [(cyc, build_valid_stream(random_op_tuples(rng,"
        " max_ops=30))) for _ in range(5)]\n"
        "res = engine.resolve_lanes(lanes, keys=[('warm', i) for i in"
        " range(5)], need_issue=False, device='cpu')\n"
        "print(json.dumps(dict(n=n, totals=[int(t) for _, t in res],"
        " misses=engine.lane_cache_info()['misses'])))\n", str(tmp_path))
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep == dict(n=5, totals=[int(t) for _, t in want], misses=0)


def test_snapshot_save_is_atomic_and_empty_cache_saves(tmp_path):
    assert warmstart.save_lane_snapshot(str(tmp_path)) == 0
    assert warmstart.load_lane_snapshot(str(tmp_path)) == 0
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


# ---------------------------------------------------------------------
# Corruption / version tolerance: cold start, never a crash
# ---------------------------------------------------------------------

def _saved_snapshot(tmp_path):
    _resolve(_lanes(1))
    warmstart.save_lane_snapshot(str(tmp_path))
    engine.lane_cache_reset()
    faults.reset_events()
    return warmstart.lane_snapshot_path(str(tmp_path))


def _assert_cold(tmp_path, reason: str):
    assert warmstart.load_lane_snapshot(str(tmp_path)) == 0
    assert engine.lane_cache_info()["size"] == 0
    evs = [e for e in faults.events()
           if e["site"] == "warmstart" and e["kind"] == "detect"]
    assert len(evs) == 1 and "cold start" in evs[0]["detail"]
    assert reason in evs[0]["detail"]


def test_missing_snapshot_is_cold(tmp_path):
    assert warmstart.load_lane_snapshot(str(tmp_path / "nowhere")) == 0
    assert not faults.events()


def _rewrite(path, fn):
    payload = pickle.load(open(path, "rb"))
    with open(path, "wb") as f:
        pickle.dump(fn(payload), f)


@pytest.mark.parametrize("damage,reason", [
    ("truncate", "Error"), ("garbage", "Error"),
    ("version", "version"), ("fingerprint", "fingerprint"),
    ("magic", "bad magic"), ("not_dict", "not dict"),
    ("entries", "not a list")])
def test_damaged_snapshot_is_cold_with_a_detect_event(tmp_path, damage,
                                                      reason):
    path = _saved_snapshot(tmp_path)
    if damage == "truncate":
        data = open(path, "rb").read()
        open(path, "wb").write(data[: len(data) // 2])
    elif damage == "garbage":
        open(path, "wb").write(b"not a pickle at all")
    elif damage == "version":
        _rewrite(path, lambda p: dict(p, version=p["version"] + 1))
    elif damage == "fingerprint":
        _rewrite(path, lambda p: dict(p, fingerprint="0" * 32))
    elif damage == "magic":
        _rewrite(path, lambda p: dict(p, magic=b"wrong"))
    elif damage == "not_dict":
        _rewrite(path, lambda p: ["a", "list"])
    else:
        _rewrite(path, lambda p: dict(p, entries="not-a-list"))
    _assert_cold(tmp_path, reason)


def test_snapshot_written_by_the_jax_package_is_cold(tmp_path):
    """The reference's snapshot (its magic, its fingerprint, its key
    classes) never loads into the port, and vice versa."""
    rng = np.random.default_rng(2)
    from repro.core.timing import DEFAULT_SYSTEM as REF_DEFAULT
    ref_engine.resolve_lanes(
        [(REF_DEFAULT.derive_cycles(),
          build_valid_stream(random_op_tuples(rng, max_ops=30)))],
        keys=[("jax", 0)], need_issue=False)
    assert ref_warmstart.save_lane_snapshot(str(tmp_path)) == 1
    assert warmstart.snapshot_fingerprint() != \
        ref_warmstart.snapshot_fingerprint()
    _assert_cold(tmp_path, "bad magic")

    _resolve(_lanes(3))
    warmstart.save_lane_snapshot(str(tmp_path))
    ref_engine.lane_cache_reset()
    assert ref_warmstart.load_lane_snapshot(str(tmp_path)) == 0


# ---------------------------------------------------------------------
# Crash mid-write: the previous snapshot survives a dying writer
# ---------------------------------------------------------------------

def test_injected_crash_mid_write_preserves_previous_snapshot(tmp_path):
    _resolve(_lanes(8))
    assert warmstart.save_lane_snapshot(str(tmp_path)) == 5
    _resolve(_lanes(9), keys=[("v2", i) for i in range(5)])
    inj = faults.FaultInjector()
    inj.arm("warmstart", count=1, message="crash mid-write")
    with faults.fault_scope(inj):
        with pytest.raises(faults.InjectedFault):
            warmstart.save_lane_snapshot(str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    engine.lane_cache_reset()
    assert warmstart.load_lane_snapshot(str(tmp_path)) == 5  # v1 intact


def test_hard_kill_mid_write_preserves_previous_snapshot(tmp_path):
    _resolve(_lanes(10))
    assert warmstart.save_lane_snapshot(str(tmp_path)) == 5
    want = engine.lane_cache_export()
    out = _child(
        "import os, sys\n"
        "import numpy as np\n"
        "from repro_torch.core import engine, faults, warmstart\n"
        "from repro_torch.core.timing import DEFAULT_SYSTEM\n"
        "from test_engine import build_valid_stream, random_op_tuples\n"
        "rng = np.random.default_rng(11)\n"
        "cyc = DEFAULT_SYSTEM.derive_cycles()\n"
        "lanes = [(cyc, build_valid_stream(random_op_tuples(rng,"
        " max_ops=30))) for _ in range(3)]\n"
        "engine.resolve_lanes(lanes, keys=[('kill', i) for i in"
        " range(3)], need_issue=False, device='cpu')\n"
        "warmstart.faults.maybe_fail = lambda site: os._exit(9)\n"
        "warmstart.save_lane_snapshot(sys.argv[1])\n", str(tmp_path))
    assert out.returncode == 9, out.stderr
    engine.lane_cache_reset()
    assert warmstart.load_lane_snapshot(str(tmp_path)) == 5
    assert engine.lane_cache_export() == want


def test_save_warm_start_absorbs_failure(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    inj = faults.FaultInjector()
    inj.arm("warmstart", count=1)
    with faults.fault_scope(inj):
        assert warmstart.save_warm_start() == -1
    evs = [e for e in faults.events()
           if e["site"] == "warmstart" and e["kind"] == "fault"]
    assert evs and "snapshot save failed" in evs[0]["detail"]


# ---------------------------------------------------------------------
# enable/save_warm_start wiring, env knob, capacity
# ---------------------------------------------------------------------

def test_enable_warm_start_no_dir_is_noop(monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    before = build.BUILD_DIR
    assert warmstart.enable_warm_start() == {
        "cache_dir": None, "compile_cache": False, "lanes": 0}
    assert warmstart.save_warm_start() == -1
    assert build.BUILD_DIR == before


def test_env_cache_dir_round_trip_and_build_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    _resolve(_lanes(2))
    assert warmstart.save_warm_start() == 5
    engine.lane_cache_reset()
    rep = warmstart.enable_warm_start()
    assert rep == {"cache_dir": str(tmp_path), "compile_cache": True,
                   "lanes": 5}
    assert build.BUILD_DIR == tmp_path / "nvcc"


def test_import_respects_capacity(tmp_path):
    _resolve(_lanes(3))
    warmstart.save_lane_snapshot(str(tmp_path))
    newest = engine.lane_cache_export()[-2:]
    engine.configure_lane_cache(2)            # shrink (clears)
    assert warmstart.load_lane_snapshot(str(tmp_path)) == 2
    info = engine.lane_cache_info()
    assert info["size"] == 2 and info["evictions"] == 0
    assert engine.lane_cache_export() == newest


def test_import_disabled_cache_keeps_nothing(tmp_path):
    _resolve(_lanes(4))
    warmstart.save_lane_snapshot(str(tmp_path))
    engine.configure_lane_cache(0)
    assert warmstart.load_lane_snapshot(str(tmp_path)) == 0
    assert engine.lane_cache_info()["size"] == 0


def test_import_recomputes_tags_and_keeps_mru_order():
    _resolve(_lanes(5))
    entries = engine.lane_cache_export()
    engine.lane_cache_reset()
    # an entry already present moves to the MRU end with its new value
    _resolve(_lanes(5)[:1])
    assert engine.lane_cache_import(entries[::-1]) == 5
    assert [k for k, _t, _i in engine.lane_cache_export()] == \
        [k for k, _t, _i in entries[::-1]]
    assert engine.lane_cache_verify() == 0
    assert not faults.events()


# ---------------------------------------------------------------------
# Parity with the reference's LRU
# ---------------------------------------------------------------------

def _twin_planners():
    return (OffloadPlanner(smoke_config(ARCHS["granite-8b"]), device="cpu"),
            RefPlanner(ref_smoke(REF_ARCHS["granite-8b"])))


def test_export_equals_reference_after_the_same_planning():
    port, ref = _twin_planners()
    for p in (port, ref):
        p.plan(fence=True)
        p.plan_draft(fence=True)
        p.plan(fence=False)
    got, want = engine.lane_cache_export(), ref_engine.lane_cache_export()
    assert len(got) == len(want) > 0
    for (gk, gt, gi), (wk, wt, wi) in zip(got, port_entries(want)):
        assert gk == wk and gt == wt
        assert (gi is None) == (wi is None)
        if gi is not None:
            assert np.array_equal(gi, wi) and not gi.flags.writeable


def test_reference_export_imports_and_replans_without_resolves():
    port, ref = _twin_planners()
    want = ref.plan(fence=True)
    assert engine.lane_cache_import(
        port_entries(ref_engine.lane_cache_export())) > 0
    got = port.plan(fence=True)
    assert engine.lane_cache_info()["misses"] == 0
    assert [(d.pim_ns, d.host_ns, d.offload_below_batch) for d in got] == \
        [(d.pim_ns, d.host_ns, d.offload_below_batch) for d in want]

"""The port's chaos harness, serve daemon and the launcher's other modes,
held to the JAX package.

``tests/golden/chaos_trace.json`` is reproduced exactly, every key of it
(the incident record's events, breaker and backoff sleeps included),
through the port's cells, controller, lane LRU, poison / scrub / storm
actions and degradation ladder, on a fresh full-width mamba2-130m
planner as the golden was recorded.  The port's plain lane resolver
takes about 0.7 ms a command on the CPU, and the golden's eviction
storms re-resolve the plan's 1.65 M commands four times, so here the
plain resolver is stood in by :class:`LaneTable`: the JAX package's own
totals for the same streams, recorded while it planned the same arch,
and every lookup must hit.  On the card (``chip_smoke.py`` phase 10,
``tests/test_torch_gpu.py``) the lane-scan kernel resolves them.

The daemon runs on the smoke granite-8b with the smoke planner: its
scenario mode gives ``run_scenario``'s trace (and the JAX package's),
drain under chaos leaves nothing unhandled, hard shutdown accounts for
every request, and ``TraceWriter`` streams reassemble the in-memory
trace while corrupt streams are refused as the JAX package refuses them.
"""
import dataclasses
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (first: the reference's import order)
import jax
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke
from repro.core import engine as ref_engine
from repro.core import faults as ref_faults
from repro.models import model as RM
from repro.serving import chaos as ref_chaos
from repro.serving import daemon as ref_daemon
from repro.serving import scenarios as ref_scen
from repro.serving.offload import OffloadPlanner as RefPlanner

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import engine, faults
from repro_torch.kernels import lane_scan
from repro_torch.launch import serve as launcher
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import chaos, scenarios as scen
from repro_torch.serving.daemon import ServeDaemon, TraceWriter
from repro_torch.serving.offload import OffloadPlanner

from test_torch_lane_mesh import backend_rungs, one_torch_thread, rung_runs

GOLDEN = pathlib.Path(__file__).parent / "golden" / "chaos_trace.json"
GOLDEN_SCENARIO = dict(name="chaos", seed=5, slots=4, quick=True)
SCENARIO = dict(name="bursty", seed=3, slots=4, quick=True)
BOTH = ((faults, engine), (ref_faults, ref_engine))


def roundtrip(x):
    return json.loads(json.dumps(x))


def canonical(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.fixture(autouse=True)
def fresh_state():
    for flt, eng in BOTH:
        eng.reset_backend_scopes()
        flt.reset()
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()
    yield
    for flt, eng in BOTH:
        eng.reset_backend_scopes()
        flt.reset()
        eng.lane_cache_reset()


class LaneTable:
    """The JAX package's lane totals keyed by (timing row, stream bytes),
    standing in for the port's plain lane resolver: ``scan`` has
    ``lane_scan_plain``'s signature, answers totals only, and raises on a
    lane it does not hold."""

    def __init__(self):
        self.totals: dict = {}
        self.lookups = 0

    @staticmethod
    def key(row, stream: np.ndarray):
        s = np.ascontiguousarray(stream, dtype=np.int32)
        return (tuple(int(v) for v in row),
                hashlib.blake2b(s.tobytes(), digest_size=16).digest())

    def record(self, lanes, resolved) -> None:
        for (cyc, s), (_issue, total) in zip(lanes, resolved):
            row = [getattr(cyc, f) for f in lane_scan.CYC_FIELDS]
            self.totals[self.key(row, s)] = int(total)

    def scan(self, cycs, streams, lengths, num_banks, need_issue=True):
        assert not need_issue, "the table holds totals only"
        out = []
        for f in range(streams.shape[0]):
            n = int(lengths[f])
            self.lookups += 1
            out.append(self.totals[self.key(cycs[f].tolist(),
                                            streams[f, :n].numpy())])
        return None, torch.tensor(out, dtype=torch.int32)


@pytest.fixture(scope="module")
def mamba_table():
    """The JAX package's full-width mamba2-130m plan (fenced W8A8, as the
    chaos golden plans), its lanes' totals recorded into a table
    (~11 s on the CPU)."""
    table = LaneTable()
    real = ref_engine.resolve_lanes

    def recording(lanes, keys=None, need_issue=True, scope=None):
        lanes = list(lanes)
        out = real(lanes, keys=keys, need_issue=need_issue, scope=scope)
        table.record(lanes, out)
        return out

    ref_engine.lane_cache_reset()
    ref_engine.resolve_lanes = recording
    try:
        RefPlanner(REF_ARCHS["mamba2-130m"]).plan(fence=True)
    finally:
        ref_engine.resolve_lanes = real
        ref_engine.lane_cache_reset()
    assert len(table.totals) == 7
    return table


@pytest.fixture
def table_resolver(mamba_table, monkeypatch):
    monkeypatch.setattr(lane_scan, "lane_scan_plain", mamba_table.scan)
    before = mamba_table.lookups
    yield mamba_table
    assert mamba_table.lookups > before, "the table was never asked"


@pytest.fixture(scope="module")
def small_lm():
    """(ref cfg, port cfg, JAX params, the same weights as port tensors)."""
    rcfg = ref_smoke(REF_ARCHS["granite-8b"])
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, smoke_config(ARCHS["granite-8b"]), rparams, params


def smoke_planner():
    return OffloadPlanner(smoke_config(ARCHS["granite-8b"]), device="cpu")


# ---------------------------------------------------------------------
# The chaos golden and timelines
# ---------------------------------------------------------------------

def test_golden_chaos_trace_exact(small_lm, table_resolver):
    """The seeded incident — cache storms, forced replans, handoff
    pressure, admission shedding, faults at ``backend.scan`` and the
    planner — through the port's cells on a fresh full-width planner,
    every key of the golden equal after a JSON round trip."""
    _rcfg, cfg, _rparams, params = small_lm
    lookups = table_resolver.lookups
    fixture = json.loads(GOLDEN.read_text())
    spec = scen.make_scenario(**GOLDEN_SCENARIO)
    horizon = max(a.step for a in spec.arrivals) + 1
    tl = chaos.make_chaos_timeline(GOLDEN_SCENARIO["seed"],
                                   horizon=max(horizon, 8), rungs=["scan"],
                                   scheduling=True)
    dcfg = scen.DisaggConfig(prefill_budget=2, handoff_bound=3,
                             starvation_age=4, admission_capacity=6)
    got = roundtrip(chaos.run_chaos_scenario(
        cfg, params, OffloadPlanner(ARCHS["mamba2-130m"], device="cpu"),
        scenario=spec, timeline=tl, disagg=dcfg,
        slo=scen.assign_slo(spec, 0.6), device="cpu"))
    assert set(got) == set(fixture)
    for key in fixture:
        assert got[key] == fixture[key], f"golden chaos drift at {key}"
    # cold plan + four storm re-plans, each through the table
    assert table_resolver.lookups - lookups >= 5 * 7
    assert engine.lane_cache_info()["misses"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_chaos_timelines_equal(seed):
    for horizon in (1, 8, 30, 97):
        for rungs in (["scan"], ["threaded", "scan"], None):
            for scheduling in (True, False):
                got = chaos.make_chaos_timeline(seed, horizon, rungs,
                                                scheduling)
                want = ref_chaos.make_chaos_timeline(
                    seed, horizon, rungs if rungs else ["scan"],
                    scheduling)
                assert [a.to_record() for a in got] == \
                    [a.to_record() for a in want]
                assert [a.to_record() for a in chaos.baseline_timeline(
                    got)] == [a.to_record()
                              for a in ref_chaos.baseline_timeline(want)]
                assert all(chaos.ChaosAction.from_record(a.to_record())
                           == a for a in got)
    assert chaos.CHAOS_SITES == ref_chaos.CHAOS_SITES
    assert chaos.NEUTRAL_ACTIONS == ref_chaos.NEUTRAL_ACTIONS
    with pytest.raises(ValueError, match="unknown chaos action"):
        chaos.apply_action(chaos.ChaosAction(0, "warp"),
                           faults.FaultInjector())


def test_chaos_run_equals_healthy_baseline_on_two_rungs(small_lm,
                                                        monkeypatch):
    """With a second rung above ``scan`` (``_ladder_rungs`` stood in), a
    fault schedule that trips the breaker and steps the ladder down
    gives the trace of a healthy run driven by the fault-free shadow
    timeline."""
    _rcfg, cfg, _rparams, params = small_lm
    monkeypatch.setattr(engine, "_ladder_rungs",
                        lambda scope=None: ["threaded", "scan"])
    spec = scen.make_scenario("chaos", seed=2, slots=4, quick=True)
    horizon = max(a.step for a in spec.arrivals) + 1
    tl = chaos.make_chaos_timeline(2, horizon=max(horizon, 8),
                                   scheduling=False)
    assert any(a.action == "backend.threaded" and a.count < 0 for a in tl)
    faulted = chaos.run_chaos_scenario(cfg, params, smoke_planner(),
                                       scenario=spec, timeline=tl,
                                       device="cpu")
    kinds = {e["kind"] for e in faulted["chaos"]["events"]}
    assert {"inject", "fault", "retry", "degrade", "trip", "skip",
            "detect"} <= kinds
    assert faulted["chaos"]["breaker"]["open"] == ["backend.threaded"]
    assert faulted["chaos"]["backoff_sleeps"]
    faults.reset()
    engine.lane_cache_reset()
    baseline = chaos.run_chaos_scenario(
        cfg, params, smoke_planner(), scenario=spec,
        timeline=chaos.baseline_timeline(tl), device="cpu")
    assert not baseline["chaos"]["injected"]
    strip = [canonical({k: v for k, v in t.items() if k != "chaos"})
             for t in (faulted, baseline)]
    assert strip[0] == strip[1]


def test_scoped_chaos_records_scope_breakers(small_lm, monkeypatch):
    _rcfg, cfg, _rparams, params = small_lm
    spec = scen.ScenarioSpec(name="chaos", seed=0, slots=2, arrivals=())
    pre = engine.BackendScope(name="prefill")
    dec = engine.BackendScope(name="decode")
    trace = chaos.run_chaos_scenario(cfg, params, smoke_planner(),
                                     scenario=spec, disagg=True,
                                     prefill_scope=pre, decode_scope=dec,
                                     device="cpu")
    assert trace["steps"] == 0 and trace["per_tick_batch"] == []
    assert trace["chaos"]["timeline"]
    assert set(trace["chaos"]["scope_breakers"]) == {"prefill", "decode"}
    assert trace["disagg"]["scopes"]["decode"]["rungs"] == ["scan"]
    # the quick chaos scenario's first six requests under a lane mesh
    # (cold caches both): the lanes resolve on the mesh rung, the
    # timeline is armed against the mesh rung's site, and the rest of
    # the trace is the run's without a mesh
    quick = scen.make_scenario("chaos", seed=0, quick=True)
    spec = dataclasses.replace(quick, arrivals=quick.arrivals[:6])
    with one_torch_thread():
        ran = rung_runs(monkeypatch)
        runs = []
        for mesh in (None, 2):
            engine.lane_cache_reset()
            faults.reset()
            ran.clear()
            runs.append(roundtrip(chaos.run_chaos_scenario(
                cfg, params, smoke_planner(), scenario=spec, mesh=mesh,
                device="cpu")))
            # (the timeline's faults step the mesh down to the scan rung)
            assert backend_rungs(ran) == ({"backend.mesh", "backend.scan"}
                                          if mesh else {"backend.scan"})
    plain, meshed = runs
    assert engine.lane_mesh() is None, "the mesh scope must not leak"
    assert plain["steps"] > 0
    assert {k: v for k, v in meshed.items() if k != "chaos"} == \
        {k: v for k, v in plain.items() if k != "chaos"}
    sites = {a["action"] for a in meshed["chaos"]["timeline"]
             if a["action"].startswith("backend.")}
    assert "backend.mesh" in sites and sites <= {"backend.mesh",
                                                 "backend.scan"}


# ---------------------------------------------------------------------
# The serve daemon
# ---------------------------------------------------------------------

BOUNDED = dict(prefill_budget=2, handoff_bound=3, starvation_age=4)


@pytest.fixture(scope="module")
def autoscaled_reference(small_lm):
    """The JAX package's bounded, SLO-mixed, autoscaled disagg run of
    the bursty scenario on its smoke planner."""
    rcfg, _cfg, rparams, _params = small_lm
    spec = ref_scen.make_scenario(**SCENARIO)
    return roundtrip(ref_scen.run_scenario(
        spec, rcfg, rparams, RefPlanner(ref_smoke(REF_ARCHS["granite-8b"])),
        policy="hysteresis", disagg=ref_scen.DisaggConfig(**BOUNDED),
        slo=ref_scen.assign_slo(spec),
        autoscale=ref_scen.AutoscaleConfig(min_slots=1)))


def test_daemon_scenario_mode_equals_run_scenario(small_lm,
                                                  autoscaled_reference):
    """A pure-scenario daemon run is the scenario driver: its trace is
    ``run_scenario(disagg=, autoscale=)``'s, which is the JAX
    package's."""
    _rcfg, cfg, _rparams, params = small_lm
    spec = scen.make_scenario(**SCENARIO)
    kw = dict(policy="hysteresis", disagg=scen.DisaggConfig(**BOUNDED),
              slo=scen.assign_slo(spec),
              autoscale=scen.AutoscaleConfig(min_slots=1))
    ref = roundtrip(scen.run_scenario(spec, cfg, params, smoke_planner(),
                                      device="cpu", **kw))
    assert ref == autoscaled_reference
    d = ServeDaemon(cfg, params, smoke_planner(), scenario=spec,
                    device="cpu", **kw)
    rep = d.run()
    assert canonical(d.trace()) == canonical(ref)
    acct = rep["accounting"]
    assert acct["ingested"] == len(spec.arrivals) == acct["completed"]
    assert acct["in_flight"] == acct["dropped"] == 0
    assert rep["autoscale"] == ref["autoscale"]


def test_daemon_drain_under_chaos_unhandled_zero(small_lm):
    """Faults fire mid-drain and the daemon still drains clean: every
    ingested request completes, dropped arrivals are accounted, and no
    exception escapes."""
    _rcfg, cfg, _rparams, params = small_lm
    spec = scen.make_scenario(**SCENARIO)
    inj = faults.FaultInjector()
    holder = {}

    def on_tick(t, eng):
        faults.set_tick(t)
        if t == 4:
            holder["d"].drain()
        if t in (5, 7):
            inj.arm("handoff", count=1)

    d = ServeDaemon(cfg, params, smoke_planner(), scenario=spec,
                    disagg=scen.DisaggConfig(**BOUNDED), on_tick=on_tick,
                    device="cpu")
    holder["d"] = d
    try:
        with faults.fault_scope(inj), \
                faults.retry_scope(retries=2, clock=faults.VirtualClock()):
            rep = d.run()
    finally:
        faults.set_tick(None)
    assert rep["draining"] and not rep["stopped"]
    acct = rep["accounting"]
    assert acct["dropped"] > 0
    assert acct["ingested"] == acct["completed"] + acct["shed"]
    assert acct["in_flight"] == 0
    assert acct["dropped"] + acct["ingested"] == len(spec.arrivals)
    assert inj.injected > 0
    stalls = [e for e in faults.events()
              if e["site"] == "handoff" and e["kind"] == "stall"]
    assert stalls and all(e["tick"] >= 5 for e in stalls)
    with pytest.raises(ValueError, match="draining"):
        d.inject(prompt_len=4, max_new=2)


def test_daemon_shutdown_injection_and_idle(small_lm):
    """Hard shutdown conserves every request; an injection-only daemon
    auto-drains at ``max_requests``; idle ticks wait on the virtual
    clock; an empty scenario reports neutral telemetry."""
    _rcfg, cfg, _rparams, params = small_lm
    spec = scen.make_scenario(**SCENARIO)
    d = ServeDaemon(cfg, params, smoke_planner(), scenario=spec,
                    device="cpu")
    for _ in range(6):
        d.step()
    rid = d.inject(prompt_len=5, max_new=3, slo=scen.SLO_THROUGHPUT)
    d.step()
    d.shutdown()
    with pytest.raises(ValueError):
        d.inject(4, 2)
    rep = d.run()
    assert rep["stopped"]
    acct = rep["accounting"]
    assert acct["ingested"] == (acct["completed"] + acct["shed"]
                                + acct["in_flight"])
    assert acct["in_flight"] > 0 and rid in d.slo

    d = ServeDaemon(cfg, params, smoke_planner(), max_seq=64,
                    max_requests=2, device="cpu")
    for k in range(3):
        d.inject(prompt_len=4 + k, max_new=3)
    rep = d.run()
    assert rep["draining"]
    assert rep["accounting"]["completed"] >= 2
    assert rep["accounting"]["ingested"] == rep["accounting"]["completed"]

    clk = faults.VirtualClock()
    d = ServeDaemon(cfg, params, smoke_planner(), max_seq=64, clock=clk,
                    idle_wait=0.25, device="cpu")
    for _ in range(3):
        d.step()
    assert d.idle_ticks == 3 and clk.sleeps == [0.25, 0.25, 0.25]

    empty = scen.ScenarioSpec(name="empty", seed=0, slots=2, arrivals=())
    d = ServeDaemon(cfg, params, smoke_planner(), scenario=empty,
                    device="cpu")
    rep = d.run()
    assert rep["accounting"] == dict(ingested=0, completed=0, shed=0,
                                     in_flight=0, dropped=0,
                                     queued_inbox=0)
    assert rep["handoff_wait"] == dict(pops=0, mean_wait=0.0, max_wait=0)
    assert d.trace()["per_tick_batch"] == []


def test_daemon_concurrent_injections_all_served(small_lm):
    """Eight threads inject while the serving thread ticks (the interpreter
    switching threads every 10 µs): every injection gets its own rid and
    is served, and the accounting balances."""
    import sys
    import threading

    _rcfg, cfg, _rparams, params = small_lm
    d = ServeDaemon(cfg, params, smoke_planner(), max_seq=32, device="cpu")
    rids: list[int] = []
    lock = threading.Lock()

    def producer(k: int) -> None:
        for j in range(5):
            rid = d.inject(prompt_len=2 + (k + j) % 4, max_new=1 + j % 2)
            with lock:
                rids.append(rid)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=producer, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            d.step()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    d.drain()
    rep = d.run(max_ticks=2_000)
    assert sorted(rids) == list(range(40))
    acct = rep["accounting"]
    assert acct["ingested"] == acct["completed"] == 40
    assert acct["in_flight"] == acct["queued_inbox"] == 0
    assert sorted(d.eng.completions) == sorted(rids)


def test_streamed_trace_reassembles_in_memory_trace(small_lm, tmp_path):
    _rcfg, cfg, _rparams, params = small_lm
    spec = scen.make_scenario(**SCENARIO)
    d_mem = ServeDaemon(cfg, params, smoke_planner(), scenario=spec,
                        policy="hysteresis", device="cpu")
    d_mem.run()
    path = tmp_path / "trace.jsonl"
    writer = TraceWriter(path, chunk_records=8)
    d_str = ServeDaemon(cfg, params, smoke_planner(), scenario=spec,
                        policy="hysteresis", writer=writer, device="cpu")
    d_str.run()
    assert writer.flushes >= 5
    loaded = TraceWriter.load(path)
    assert canonical(loaded) == canonical(d_mem.trace())
    assert scen.replay_batches(loaded) == loaded["per_tick_batch"]
    assert ref_daemon.TraceWriter.load(path) == loaded
    with pytest.raises(ValueError, match="streaming"):
        d_str.trace()


def test_trace_writer_equal(tmp_path):
    """Both packages' writers give the same stream for the same records
    and refuse the same corrupt streams and misordered ticks."""
    texts = []
    for i, cls in enumerate((TraceWriter, ref_daemon.TraceWriter)):
        path = tmp_path / f"t{i}.jsonl"
        with cls(path, chunk_records=4) as w:
            w.write_meta(policy="per-step", fence=True)
            for t in range(10):
                w.write_tick(t, t % 3)
                assert len(w._buf) < 4
            w.write_summary(dict(steps=10, tokens=20))
            with pytest.raises(ValueError, match="tick-ordered"):
                w.write_tick(12, 1)
        assert (w.records, w.flushes) == (12, 3)
        texts.append(path.read_text())
        assert cls.load(path) == dict(policy="per-step", fence=True,
                                      per_tick_batch=[t % 3
                                                      for t in range(10)],
                                      steps=10, tokens=20)
        with pytest.raises(ValueError):
            cls(path, chunk_records=0)
        bad = tmp_path / f"bad{i}.jsonl"
        bad.write_text(json.dumps(dict(kind="tick", tick=5, batch=1)) + "\n")
        with pytest.raises(ValueError, match="out of order"):
            cls.load(bad)
        bad.write_text(json.dumps(dict(kind="nope")) + "\n")
        with pytest.raises(ValueError, match="unknown trace record kind"):
            cls.load(bad)
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------
# The launcher's disagg, chaos and daemon modes (mamba2-130m at full
# width through the table, the smoke model on the CPU)
# ---------------------------------------------------------------------

def _launch(argv, capsys) -> str:
    launcher.main(["--arch", "mamba2-130m", "--device", "cpu", *argv])
    return capsys.readouterr().out


def test_launcher_daemon_autoscale_chaos_streams(table_resolver, tmp_path,
                                                 capsys):
    out = tmp_path / "daemon.jsonl"
    text = _launch(["--daemon", "--autoscale", "--chaos", "--trace-out",
                    str(out), "--quick"], capsys)
    assert "daemon scenario chaos (seed=0" in text
    assert "serve/chaos,injected=" in text and "unhandled=0" in text
    row = text.split("serve/daemon,")[1].split()[0]
    fields = dict(kv.split("=") for kv in row.split(","))
    assert fields["unhandled"] == "0" and fields["in_flight"] == "0"
    assert int(fields["completed"]) > 0
    trace = TraceWriter.load(out)
    assert trace["scenario"]["name"] == "chaos"
    assert len(trace["per_tick_batch"]) == int(fields["ticks"])
    limits = trace["autoscale"]["limits"]
    assert len(limits) == len(trace["per_tick_batch"])
    assert all(1 <= lim <= trace["scenario"]["slots"] for lim in limits)
    assert trace["disagg"]["requests"]["completion_ticks"]


def test_launcher_disagg_and_chaos_modes(table_resolver, capsys):
    text = _launch(["--scenario", "bursty", "--quick", "--disagg", "--slo",
                    "0.5", "--prefill-budget", "2", "--handoff-bound", "3",
                    "--admission-capacity", "4"], capsys)
    assert "disagg cells) under policy per-step" in text
    assert "KV handoff queue" in text and "SLO throughput" in text
    text = _launch(["--chaos", "--quick", "--faults", "3",
                    "--lane-backend", "pallas"], capsys)
    assert "scenario chaos (seed=0" in text and "monolithic" in text
    assert "serve/chaos,injected=" in text and ",unhandled=0" in text
    text = _launch(["--disagg", "--requests", "4", "--slo", "0.5"], capsys)
    assert "served 4 requests (disagg cells)" in text
    for bad in (["--slo", "0.5", "--requests", "2"],
                ["--autoscale", "--scenario", "bursty"],
                ["--trace-out", "x.jsonl", "--scenario", "bursty"],
                ["--daemon"], ["--mesh", "0"]):
        with pytest.raises(SystemExit):
            _launch(bad, capsys)

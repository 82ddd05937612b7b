"""Serving without a model, the port against the JAX package.

Scenarios, the model-free mirrors (``simulate_batches``,
``simulate_spec_decode``, ``simulate_disagg``), the offload policies and
their controller, and the planner's speculative and occupancy telemetry
go through both packages on the same seeds, and every output is compared
exactly (``==``).  The three serving goldens are held two ways: their
scheduling is re-derived by the port's mirrors, and their ``controller``
report and ``per_step`` list by the port's controller fed the JAX
package's full-width granite-8b decisions through a stub planner (the
card run, ``chip_smoke.py`` phase 8, derives those decisions with the
port's own planner and kernel).

The controller degrades to host-only serving only on an injected
planner fault; any other planner error propagates after its retries,
where the JAX package degrades on every exception.

Serving with a model: the port's ``ServingEngine`` on the smoke
granite-8b (weights from the JAX package's ``init_params``) gives the
JAX engine's token streams and ``summary()``, vanilla and speculative;
the port's ``replay_trace`` reproduces ``serve_trace.json``,
``spec_decode_trace.json`` and ``disagg_trace.json`` (the disaggregated
cells) exactly through a full-width port planner
whose lane LRU holds the JAX package's resolved lanes
(``lane_cache_import``), so no lane is resolved on the CPU; the serve
launcher runs both modes and warm-starts from its cache directory.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
import jax
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke
from repro.core import engine as ref_engine
from repro.core import faults as ref_faults
from repro.serving import policy as ref_policy
from repro.serving import scenarios as ref_scen
from repro.serving.offload import GemvSite as RefSite
from repro.serving.offload import OffloadDecision as RefDecision
from repro.serving.offload import OffloadPlanner as RefPlanner

from repro.models import model as RM
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import engine, faults
from repro_torch.kernels import build, lane_scan
from repro_torch.launch import serve as launcher
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import policy, scenarios as scen
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import (GemvSite, OffloadDecision,
                                         OffloadPlanner)

from test_torch_lane_mesh import backend_rungs, one_torch_thread, rung_runs
from test_torch_warmstart import port_entries

GOLDEN = pathlib.Path(__file__).parent / "golden"
GOLDENS = ("serve_trace", "disagg_trace", "spec_decode_trace")
POLICY_NAMES = ("per-step", "hysteresis", "sticky")
BOTH = ((faults, engine), (ref_faults, ref_engine))


def roundtrip(x):
    return json.loads(json.dumps(x))


def golden(name: str) -> dict:
    return json.loads((GOLDEN / f"{name}.json").read_text())


@pytest.fixture(autouse=True)
def fresh_state():
    for flt, eng in BOTH:
        flt.reset()
        eng.configure_lane_cache(4096)
        eng.lane_cache_reset()
    yield
    for flt, eng in BOTH:
        flt.reset()
        eng.lane_cache_reset()


class StubPlanner:
    """A planner that answers with fixed decisions (either package's)."""

    def __init__(self, decisions, fail=None):
        self.decisions = list(decisions)
        self.fail = fail
        self.plans = 0

    def plan(self, fence=True, spec=None):
        self.plans += 1
        if self.fail is not None:
            raise self.fail
        return list(self.decisions)

    def invalidate(self):
        pass


def port_decisions(ref_decisions) -> list:
    return [OffloadDecision(site=GemvSite(**dataclasses.asdict(d.site)),
                            pim_ns=d.pim_ns, host_ns=d.host_ns,
                            reshape=d.reshape,
                            offload_below_batch=d.offload_below_batch)
            for d in ref_decisions]


def controller_record(c) -> dict:
    return roundtrip(dict(report=c.report(),
                          per_step=[r.to_record() for r in c.trace],
                          sets=[sorted(s) for s in c.set_log]))


# ---------------------------------------------------------------------
# Scenarios and the model-free mirrors
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ref_scen.SCENARIOS))
def test_scenarios_and_mirrors_equal(name):
    assert list(scen.SCENARIOS) == list(ref_scen.SCENARIOS)
    sd = scen.SpecDecodeConfig(draft_len=3, acceptance=0.6, seed=2)
    ref_sd = ref_scen.SpecDecodeConfig(draft_len=3, acceptance=0.6, seed=2)
    for seed, slots, quick in ((0, 8, False), (1, 3, True), (5, 4, False)):
        spec = scen.make_scenario(name, seed=seed, slots=slots, quick=quick)
        ref = ref_scen.make_scenario(name, seed=seed, slots=slots,
                                     quick=quick)
        assert spec.to_record() == ref.to_record()
        assert scen.ScenarioSpec.from_record(ref.to_record()) == spec
        assert scen.simulate_batches(spec) == ref_scen.simulate_batches(ref)
        assert scen.occupancy_trace(spec) == ref_scen.occupancy_trace(ref)
        assert (scen.simulate_spec_decode(spec, sd)
                == ref_scen.simulate_spec_decode(ref, ref_sd))
        assert (scen.simulate_spec_decode(spec)
                == ref_scen.simulate_spec_decode(ref))
        slo = scen.assign_slo(spec, 0.4)
        assert slo == ref_scen.assign_slo(ref, 0.4)
        for kw, ref_kw in (
                (dict(), dict()),
                (dict(disagg=scen.DisaggConfig(prefill_budget=2,
                                               handoff_bound=3,
                                               starvation_age=4), slo=slo),
                 dict(disagg=ref_scen.DisaggConfig(prefill_budget=2,
                                                   handoff_bound=3,
                                                   starvation_age=4),
                      slo=slo)),
                (dict(disagg=scen.DisaggConfig(admission_capacity=3),
                      slo=slo, spec_decode=sd),
                 dict(disagg=ref_scen.DisaggConfig(admission_capacity=3),
                      slo=slo, spec_decode=ref_sd)),
                (dict(slo=slo, autoscale=scen.AutoscaleConfig(
                    max_slots=slots, idle_ticks=2)),
                 dict(slo=slo, autoscale=ref_scen.AutoscaleConfig(
                     max_slots=slots, idle_ticks=2)))):
            assert (scen.simulate_disagg(spec, **kw)
                    == ref_scen.simulate_disagg(ref, **ref_kw))


def test_registries_and_records_equal():
    for mod in (scen, ref_scen):
        assert mod.resolve_scenario("spec_decode") == "spec-decode"
        assert mod.resolve_scenario("drain-refill") == "drain-refill"
    msgs = []
    for mod in (scen, ref_scen):
        with pytest.raises(ValueError) as e:
            mod.resolve_scenario("warp")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    msgs = []
    for pol in (policy, ref_policy):
        assert pol.resolve_policy("per_step") == "per-step"
        assert list(pol.POLICIES) == list(ref_policy.POLICIES)
        with pytest.raises(ValueError) as e:
            pol.resolve_policy("greedy")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert scen.SLO_CLASSES == ref_scen.SLO_CLASSES
    for cfg, ref in ((scen.DisaggConfig(handoff_bound=2),
                      ref_scen.DisaggConfig(handoff_bound=2)),
                     (scen.DisaggConfig(admission_capacity=5),
                      ref_scen.DisaggConfig(admission_capacity=5)),
                     (scen.AutoscaleConfig(max_slots=4),
                      ref_scen.AutoscaleConfig(max_slots=4)),
                     (scen.SpecDecodeConfig(acceptance=0.2),
                      ref_scen.SpecDecodeConfig(acceptance=0.2))):
        assert cfg.to_record() == ref.to_record()
        assert type(cfg).from_record(ref.to_record()) == cfg
    for bad in (dict(prefill_budget=0), dict(starvation_age=-1)):
        with pytest.raises(ValueError):
            scen.DisaggConfig(**bad)
    with pytest.raises(ValueError):
        scen.SpecDecodeConfig(acceptance=1.5)


def test_admission_and_shed_picks_equal():
    rng = np.random.default_rng(4)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        waiting = [(int(rng.integers(0, 20)), i, i,
                    scen.SLO_CLASSES[int(rng.integers(0, 2))])
                   for i in range(n)]
        t, age = int(rng.integers(0, 30)), int(rng.integers(0, 10))
        assert (scen._admission_pick(waiting, t, age)
                == ref_scen._admission_pick(waiting, t, age))
        assert (scen._shed_pick(waiting, t, age)
                == ref_scen._shed_pick(waiting, t, age))


def test_drain_error_equal():
    spec = scen.make_scenario("bursty", seed=0, quick=True)
    ref = ref_scen.make_scenario("bursty", seed=0, quick=True)
    msgs = []
    for mod, sp in ((scen, spec), (ref_scen, ref)):
        with pytest.raises(mod.ScenarioDrainError) as e:
            mod.simulate_batches(sp, max_ticks=5)
        msgs.append((str(e.value), e.value.queues, e.value.last_batch))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_scheduling_replays_without_model(name):
    """The goldens' ``per_tick_batch`` (and the disagg record) come out
    of the port's mirrors, as they do out of the JAX package's."""
    fixture = golden(name)
    if name == "disagg_trace":
        spec = scen.ScenarioSpec.from_record(fixture["scenario"])
        rec = fixture["disagg"]
        slo = {int(r): s for r, s in rec["slo"].items()}
        dcfg = scen.DisaggConfig.from_record(rec["config"])
        sim = scen.simulate_disagg(spec, dcfg, slo)
        ref_sim = ref_scen.simulate_disagg(
            ref_scen.ScenarioSpec.from_record(fixture["scenario"]),
            ref_scen.DisaggConfig.from_record(rec["config"]), slo)
        assert sim == ref_sim
        assert sim["per_tick_batch"] == fixture["per_tick_batch"]
        for key in ("prefill_ticks", "admit_ticks", "completion_ticks"):
            assert rec["requests"][key] == {str(r): t for r, t
                                            in sim[key].items()}, key
        assert rec["handoff"]["max_depth"] == sim["max_handoff_depth"]
    else:
        got = scen.replay_batches(fixture)
        assert got == ref_scen.replay_batches(fixture)
        assert got == fixture["per_tick_batch"]


# ---------------------------------------------------------------------
# The goldens' controller, fed the JAX package's full-width decisions
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_width_plan():
    """The JAX package's granite-8b W8A8 plan at full width, fenced, as
    the goldens were recorded, with its speculative draft plan; and its
    resolved lanes as port lane-cache entries (computed once: ~45 s on
    the CPU)."""
    ref_engine.lane_cache_reset()
    planner = RefPlanner(REF_ARCHS["granite-8b"])
    decisions = planner.plan(fence=True)
    planner.plan_draft(fence=True)
    entries = port_entries(ref_engine.lane_cache_export())
    ref_engine.lane_cache_reset()
    return decisions, entries


@pytest.fixture(scope="module")
def full_width_decisions(full_width_plan):
    return full_width_plan[0]


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_controller_from_full_width_decisions(name,
                                                     full_width_decisions):
    fixture = golden(name)
    points = json.loads((GOLDEN / "torch_port_points.json").read_text())
    assert [d.site.name for d in full_width_decisions] \
        == [d["site"] for d in points["granite_8b_plan"]]
    runs = []
    for mod, decisions in ((scen, port_decisions(full_width_decisions)),
                           (ref_scen, full_width_decisions)):
        c = mod.run_policy_over_trace(StubPlanner(decisions),
                                      fixture["policy"],
                                      fixture["per_tick_batch"],
                                      fence=fixture["fence"])
        runs.append(controller_record(c))
    assert runs[0] == runs[1]
    assert runs[0]["report"] == fixture["controller"]
    assert runs[0]["per_step"] == fixture["per_step"]


# ---------------------------------------------------------------------
# Policies over the port's planner (granite-8b smoke config, CPU)
# ---------------------------------------------------------------------

def planners():
    return (OffloadPlanner(smoke_config(ARCHS["granite-8b"]), device="cpu"),
            RefPlanner(ref_smoke(REF_ARCHS["granite-8b"])))


@pytest.mark.parametrize("name", sorted(ref_scen.SCENARIOS))
def test_policy_battery_reports_equal(name):
    """Every policy over every scenario (seed 0, not quick) on one shared
    planner per package, as the reference battery runs: reports, per-step
    records and offload sets equal, and the battery's assertions hold."""
    port, ref = planners()
    trace = scen.occupancy_trace(scen.make_scenario(name, seed=0))
    assert trace == ref_scen.occupancy_trace(
        ref_scen.make_scenario(name, seed=0))
    for pol in POLICY_NAMES:
        got = controller_record(scen.run_policy_over_trace(port, pol, trace))
        want = controller_record(ref_scen.run_policy_over_trace(ref, pol,
                                                                trace))
        assert got == want, (name, pol)
        rep = got["report"]
        assert rep["steps"] == len(trace)
        if pol == "per-step":
            assert rep["efficiency"] == 1.0
            assert rep["planner_queries"] == rep["steps"]
        else:
            assert rep["efficiency"] >= 0.95
            assert rep["realized_speedup"] <= rep["oracle_speedup"] + 1e-12
            assert rep["planner_queries"] < rep["steps"]
        assert engine.lane_cache_info() == ref_engine.lane_cache_info()


@pytest.mark.parametrize("every", [4, 9])
def test_sticky_cold_replans_equal(every):
    """Clearing the lane LRU mid-run makes the next re-derivation miss:
    the sticky policy's cold re-plans (``refresh=True``) fire on the same
    steps in both packages, with the same LRU counters."""
    port, ref = planners()
    trace = scen.occupancy_trace(scen.make_scenario("diurnal", seed=3))
    ctrls = [policy.OffloadController(port, policy="sticky"),
             ref_policy.OffloadController(ref, policy="sticky")]
    for i, b in enumerate(trace):
        if i and i % every == 0:
            engine.lane_cache_clear()
            ref_engine.lane_cache_clear()
        recs = [c.observe(b).to_record() for c in ctrls]
        assert recs[0] == recs[1]
        assert engine.lane_cache_info() == ref_engine.lane_cache_info()
    got, want = (controller_record(c) for c in ctrls)
    assert got == want
    assert got["report"]["replans"] > len(trace) // every // 2


def test_speculative_and_occupancy_telemetry_equal():
    port, ref = planners()
    for fence in (True, False):
        for shrink in (2, 4):
            got = port.plan_draft(fence=fence, shrink=shrink)
            want = ref.plan_draft(fence=fence, shrink=shrink)
            assert ([dataclasses.asdict(d) for d in got]
                    == [dataclasses.asdict(d) for d in want])
            assert (port.touch_draft(fence=fence, shrink=shrink)
                    == ref.touch_draft(fence=fence, shrink=shrink))
    for batch in (1, 3, 8):
        assert (port.spec_decode_speedup(batch=batch)
                == ref.spec_decode_speedup(batch=batch))
    assert (port.spec_decode_speedup(batch=2, draft_len=6, acceptance=0.4,
                                     fence=False)
            == ref.spec_decode_speedup(batch=2, draft_len=6,
                                       acceptance=0.4, fence=False))
    occ = {1: 5, 2: 3, 4: 7, 9: 1}
    assert (port.occupancy_weighted_speedup(occ)
            == ref.occupancy_weighted_speedup(occ))
    assert port.occupancy_weighted_speedup({}) \
        == ref.occupancy_weighted_speedup({})
    port.invalidate()
    ref.invalidate()
    assert port.touch_draft() == ref.touch_draft()
    assert engine.lane_cache_info() == ref_engine.lane_cache_info()


@pytest.mark.parametrize("seed", range(4))
def test_policies_equal_on_fuzzed_decisions(seed):
    """Random crossovers, traces and knobs through stub planners."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    ref_decisions = [RefDecision(
        site=RefSite(f"s{i}", 64, 64, int(rng.integers(1, 5))),
        pim_ns=float(rng.uniform(50, 500)),
        host_ns=float(rng.uniform(50, 4000)), reshape=False,
        offload_below_batch=1) for i in range(n)]
    trace = [int(b) for b in rng.integers(1, 12, size=60)]
    kws = [("per-step", {}),
           ("hysteresis", dict(k=int(rng.integers(1, 5)),
                               band=float(rng.uniform(1.0, 2.0)))),
           ("sticky", dict(drift=float(rng.uniform(0.2, 2.0)),
                           min_epoch=int(rng.integers(1, 5)),
                           jump=float(rng.uniform(1.0, 4.0))))]
    for pol, kw in kws:
        got = scen.run_policy_over_trace(
            StubPlanner(port_decisions(ref_decisions)), pol, trace,
            policy_kw=kw)
        want = ref_scen.run_policy_over_trace(StubPlanner(ref_decisions),
                                              pol, trace, policy_kw=kw)
        assert controller_record(got) == controller_record(want), pol
        assert got.switch_log == want.switch_log


# ---------------------------------------------------------------------
# The degrade rule
# ---------------------------------------------------------------------

def test_real_planner_error_propagates_where_reference_degrades():
    """A planner that raises anything but an injected fault: the port
    retries and then raises; the JAX package degrades to host-only."""
    runs = []
    for flt, pol in ((faults, policy), (ref_faults, ref_policy)):
        clock = flt.VirtualClock()
        c = pol.OffloadController(StubPlanner(
            [], fail=RuntimeError("CUDA error: launch failed")))
        with flt.retry_scope(retries=2, clock=clock):
            try:
                c.observe(3)
                runs.append(("served", c.report(), flt.events()))
            except RuntimeError as e:
                runs.append(("raised", str(e), flt.events()))
        assert c.planner.plans == 3 and clock.sleeps == [0.02, 0.04]
    (port_kind, port_msg, port_events), (ref_kind, ref_rep, ref_events) = runs
    assert port_kind == "raised" and port_msg == "CUDA error: launch failed"
    assert ref_kind == "served" and ref_rep["planner_degraded"] is True
    # Up to the degrade, the events are the same.
    assert port_events == ref_events[:-1]
    assert ref_events[-1]["kind"] == "degrade"
    assert [e["kind"] for e in port_events] == ["fault", "retry", "fault",
                                                "retry", "fault"]


def test_injected_planner_fault_degrades_alike():
    runs = []
    for flt, pol, mod in ((faults, policy, scen),
                          (ref_faults, ref_policy, ref_scen)):
        inj = flt.FaultInjector()
        inj.arm("planner", count=2)
        with flt.fault_scope(inj), \
                flt.retry_scope(clock=flt.VirtualClock()):
            c = pol.OffloadController(StubPlanner([]), policy="sticky")
            for b in (1, 2, 5, 2):
                c.observe(b)
        assert c.planner_degraded and c.planner.plans == 0
        runs.append((controller_record(c), flt.events()))
    assert runs[0] == runs[1]
    assert runs[0][0]["report"]["planner_degraded"] is True
    assert [e["kind"] for e in runs[0][1]] == [
        "inject", "fault", "retry", "inject", "fault", "degrade"]


def test_transient_injected_fault_absorbed_alike():
    runs = []
    for flt, pol in ((faults, policy), (ref_faults, ref_policy)):
        inj = flt.FaultInjector()
        inj.arm("planner", count=1)
        decisions = [OffloadDecision(GemvSite("a", 64, 64, 2), 100.0,
                                     350.0, False, 3)]
        with flt.fault_scope(inj), \
                flt.retry_scope(clock=flt.VirtualClock()):
            c = pol.OffloadController(StubPlanner(decisions))
            for b in (1, 4, 2):
                c.observe(b)
        runs.append((controller_record(c), flt.events()))
    assert runs[0] == runs[1]
    assert "planner_degraded" not in runs[0][0]["report"]


def test_lane_scan_failure_while_planning_ends_the_run(monkeypatch):
    """A build or launch error inside the lane scan, hit while the
    controller plans through the real planner, is raised: it never
    becomes a host-only offload set."""
    def broken(*args, **kw):
        raise RuntimeError("lane_scan: nvcc failed to build the kernel")

    monkeypatch.setattr(lane_scan, "lane_scan", broken)
    port, _ref = planners()
    c = policy.OffloadController(port, policy="hysteresis")
    with faults.retry_scope(clock=faults.VirtualClock()):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            c.observe(2)
    assert not c.planner_degraded
    assert "degrade" not in [e["kind"] for e in faults.events()]


# ---------------------------------------------------------------------
# Serving with a model (the smoke granite-8b, on the CPU)
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    """(ref cfg, port cfg, JAX params, the same weights as port tensors)."""
    rcfg = ref_smoke(REF_ARCHS["granite-8b"])
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, smoke_config(ARCHS["granite-8b"]), rparams, params


def _requests(cls, vocab: int):
    rng = np.random.default_rng(9)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=3 + (5 * i) % 9),
                max_new=2 + (3 * i) % 7) for i in range(9)]


@pytest.mark.parametrize("speculative", [False, True])
def test_engine_streams_and_summary_equal(smoke_model, speculative):
    rcfg, cfg, rparams, params = smoke_model
    port, ref = planners()
    runs = []
    for eng_cls, req_cls, mod, model, planner, kw in (
            (ServingEngine, Request, scen, (cfg, params), port,
             dict(device="cpu")),
            (RefServingEngine, RefRequest, ref_scen, (rcfg, rparams), ref,
             {})):
        sd = (mod.SpecDecodeConfig(draft_len=3, acceptance=0.6, seed=2)
              if speculative else None)
        eng = eng_cls(*model, slots=4, max_seq=40, planner=planner,
                      step_telemetry=True, spec_decode=sd, **kw)
        reqs = _requests(req_cls, rcfg.vocab)
        for i, r in enumerate(reqs):
            if i < 5:
                eng.submit(r)
        for _ in range(3):
            eng.step()
        for r in reqs[5:]:
            eng.submit(r)
        summary = eng.run(max_steps=500)
        runs.append(roundtrip(dict(
            outs=[r.out for r in reqs], done=[r.done for r in reqs],
            summary=summary, spec=eng.spec_report(),
            admit=eng.admit_ticks, completions=eng.completions,
            steps=eng.step_batches)))
    assert runs[0] == runs[1]
    assert all(runs[0]["done"])
    assert runs[0]["spec"]["rounds"] > 0 if speculative else \
        runs[0]["spec"]["rounds"] == 0


@pytest.mark.parametrize("name", ["serve_trace", "spec_decode_trace",
                                  "disagg_trace"])
def test_replay_golden_through_the_port_model(name, smoke_model,
                                              full_width_plan):
    _rcfg, cfg, _rparams, params = smoke_model
    assert engine.lane_cache_import(full_width_plan[1]) > 0
    planner = OffloadPlanner(ARCHS["granite-8b"], device="cpu")
    fixture = golden(name)
    got = scen.replay_trace(fixture, cfg, params, planner, device="cpu")
    assert roundtrip(got) == fixture
    assert engine.lane_cache_info()["misses"] == 0


def _launch(argv, capsys) -> str:
    launcher.main(argv)
    return capsys.readouterr().out


def test_launcher_modes_and_warm_start(full_width_plan, tmp_path, capsys,
                                       monkeypatch):
    """Both modes of ``main`` on the CPU (the smoke model, the full-width
    plan from imported lanes); a second scenario run warm-starts from the
    first one's snapshot."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    engine.lane_cache_import(full_width_plan[1])
    argv = ["--scenario", "bursty", "--policy", "hysteresis", "--quick",
            "--device", "cpu", "--cache-dir", str(tmp_path)]
    first = _launch(argv, capsys)
    saved = int(first.split("warm start: saved ")[1].split()[0])
    assert saved > 0 and "serve/time_to_first_batch," in first
    assert "scenario bursty (seed=0" in first and "monolithic" in first
    assert build.BUILD_DIR == tmp_path / "nvcc"
    engine.lane_cache_reset()
    second = _launch(argv, capsys)
    assert f"{saved} lanes loaded" in second
    assert "serve/lane_cache,hits=" in second and ",misses=0," in second
    assert first.split("tokens in")[0].split(": ")[-1] == \
        second.split("tokens in")[0].split(": ")[-1]

    spec = _launch(["--scenario", "spec_decode", "--quick", "--device",
                    "cpu", "--draft-len", "3"], capsys)
    assert "serve/spec_decode,rounds=" in spec

    mono = _launch(["--requests", "8", "--device", "cpu"], capsys)
    assert "served 8 requests (monolithic engine)" in mono
    assert "speedup" in mono and ",misses=0," in mono


def test_unported_serving_modes_raise(smoke_model, full_width_plan,
                                      capsys, monkeypatch):
    """The lane mesh in serving: ``run_scenario`` of the autoscaled
    cells on a cold smoke-size planner resolves its lanes on the mesh
    rung under ``mesh=2`` and gives the trace it gives on the scan rung
    without one; ``serve_trace.json`` replays unchanged through
    ``replay_trace(..., mesh=2)`` on the full-width plan's imported lanes
    (as the JAX package's
    ``test_golden_trace_replays_bit_identically_on_mesh``; the cells'
    and chaos's meshes are in ``tests/test_torch_{cells,chaos_daemon}
    .py``), and the launcher's ``--mesh 2`` serves; no mesh scope
    outlives its run."""
    _rcfg, cfg, _rparams, params = smoke_model
    spec = scen.make_scenario("bursty", seed=0, quick=True)
    kw = dict(disagg=scen.DisaggConfig(), autoscale=scen.AutoscaleConfig())
    with one_torch_thread():
        ran = rung_runs(monkeypatch)
        want = roundtrip(scen.run_scenario(spec, cfg, params, planners()[0],
                                           device="cpu", **kw))
        assert backend_rungs(ran) == {"backend.scan"}
        engine.lane_cache_reset()
        ran.clear()
        got = roundtrip(scen.run_scenario(spec, cfg, params, planners()[0],
                                          device="cpu", mesh=2, **kw))
        assert backend_rungs(ran) == {"backend.mesh"}
        assert got == want
    assert engine.lane_mesh() is None
    engine.lane_cache_import(full_width_plan[1])
    full = OffloadPlanner(ARCHS["granite-8b"], device="cpu")
    fixture = golden("serve_trace")
    got = roundtrip(scen.replay_trace(fixture, cfg, params, full, mesh=2,
                                      device="cpu"))
    assert engine.lane_mesh() is None, "mesh scope must not leak"
    assert set(got) == set(fixture)
    for key in fixture:
        assert got[key] == fixture[key], f"mesh replay drift at {key}"
    out = _launch(["--requests", "4", "--mesh", "2", "--device", "cpu"],
                  capsys)
    assert "lane mesh: 2 shard(s) of cpu" in out
    assert "served 4 requests (monolithic engine)" in out
    assert engine.lane_mesh() is None

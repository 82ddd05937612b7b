"""The port's disaggregated serving cells, held to the JAX package's.

The smoke granite-8b (weights from the JAX package's ``init_params``)
serves through both packages' ``DisaggServingEngine`` on their smoke
planners, and everything is compared exactly: the admission and handoff
queues' orders, token streams, ``summary()``, the speculative record,
per-request ticks and queue telemetry, vanilla, speculative and with the
int8 KV cache.  The int8 KV cache's prefill-time scales come from each
package's own matmuls, an ulp apart, which can move an entry across a
rounding tie, so there each port decode step starts from the cache the
JAX package's step started from (as ``tests/test_torch_models.py`` holds
the monolithic engine).  ``run_scenario`` traces through the cells —
bounded, shedding, SLO-mixed, speculative, autoscaled, scoped — equal
the JAX package's and replay from their own records; an autoscaled trace
replays through ``simulate_disagg``.  ``tests/golden/disagg_trace.json``
is replayed at full granite-8b width in ``tests/test_torch_serving.py``,
beside the other serving goldens.
"""
import json

import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
import jax
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke
from repro.core import engine as ref_engine
from repro.core import faults as ref_faults
from repro.models import model as RM
from repro.serving import cells as ref_cells
from repro.serving import scenarios as ref_scen
from repro.serving.engine import Request as RefRequest
from repro.serving.offload import OffloadPlanner as RefPlanner

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import engine, faults
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import cells, scenarios as scen
from repro_torch.serving.engine import Request
from repro_torch.serving.offload import OffloadPlanner

from test_torch_lane_mesh import backend_rungs, one_torch_thread, rung_runs

BOTH = ((faults, engine), (ref_faults, ref_engine))


def roundtrip(x):
    return json.loads(json.dumps(x))


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
    for mod in (M, RM):
        mod.KV_QUANT = False


@pytest.fixture(scope="module")
def small_lm():
    """(ref cfg, port cfg, JAX params, the same weights as port tensors)."""
    rcfg = ref_smoke(REF_ARCHS["granite-8b"])
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, smoke_config(ARCHS["granite-8b"]), rparams, params


def planners():
    return (OffloadPlanner(smoke_config(ARCHS["granite-8b"]), device="cpu"),
            RefPlanner(ref_smoke(REF_ARCHS["granite-8b"])))


# ---------------------------------------------------------------------
# The queues
# ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_admission_queue_orders_equal(seed):
    """Random pushes, pops and sheds over both classes and ages: the same
    picks, in the same order, as the JAX package's queue and the
    simulator's pick specs."""
    rng = np.random.default_rng(seed)
    age = int(rng.integers(1, 6))
    port = cells.AdmissionQueue(age)
    ref = ref_cells.AdmissionQueue(age)
    for t in range(300):
        op = rng.random()
        if op < 0.5 or not len(port):
            slo = scen.SLO_CLASSES[int(rng.integers(0, 2))]
            port.push(Request(rid=t, prompt=np.zeros(2)), slo, t // 3)
            ref.push(RefRequest(rid=t, prompt=np.zeros(2)), slo, t // 3)
        else:
            now = t // 3 + int(rng.integers(0, 8))
            waiting = [(enq, seq, req.rid, slo)
                       for enq, seq, req, slo in port._entries]
            if op < 0.8:
                want = scen._admission_pick(waiting, now, age)
                got, ref_got = port.pop(now), ref.pop(now)
            else:
                want = scen._shed_pick(waiting, now, age)
                got, ref_got = port.shed(now), ref.shed(now)
            assert (got[0].rid, *got[1:]) == (ref_got[0].rid, *ref_got[1:])
            assert got[0].rid == waiting[want][2]
        assert port.wait_entries() == ref.wait_entries()
        assert port.rids() == [e[2].rid for e in ref._entries]
    with pytest.raises(ValueError, match="unknown SLO class"):
        port.push(Request(rid=-1, prompt=np.zeros(2)), "gold", 0)


def test_handoff_queue_equal():
    """Bound, FIFO order, wait telemetry, injected pressure (a stall, not
    an overrun) and the overrun error, alike."""
    runs = []
    for flt, mod, req_cls in ((faults, cells, Request),
                              (ref_faults, ref_cells, RefRequest)):
        q = mod.KVHandoffQueue(bound=2)
        log = [q.wait_report()]
        inj = flt.FaultInjector()
        inj.arm("handoff", count=1)
        with flt.fault_scope(inj):
            log.append(q.room())               # pressure: reported full
            for rid in range(2):
                q.push(mod.KVHandoff(req=req_cls(rid=rid,
                                                 prompt=np.zeros(2)),
                                     cache=None, pos=2, slo="latency",
                                     prefill_tick=rid))
            log.append(q.room())
            with pytest.raises(RuntimeError, match="overrun"):
                q.push(mod.KVHandoff(req=req_cls(rid=9, prompt=np.zeros(2)),
                                     cache=None, pos=2, slo="latency",
                                     prefill_tick=0))
        log.append([q.pop(5).req.rid, q.pop().req.rid])
        log += [q.report(), q.wait_report(), flt.events()]
        runs.append(log)
    assert runs[0] == runs[1]
    assert runs[0][1] is False


# ---------------------------------------------------------------------
# The cell pair with a model
# ---------------------------------------------------------------------

def _requests(cls, vocab: int):
    rng = np.random.default_rng(9)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=3 + (5 * i) % 9),
                max_new=2 + (3 * i) % 7) for i in range(10)]


def _sync_decode(port_cell, ref_cell):
    """Start every port decode step from the cache the JAX package's
    step started from: the reference's step records it, the port's takes
    it (the reference ticks first)."""
    seen = []
    ref_decode = ref_cell._decode

    def recording(p, c, t, pos):
        seen.append(jax.tree.map(np.asarray, c))
        return ref_decode(p, c, t, pos)

    port_decode = port_cell._decode

    def synced(tokens):
        port_cell.cache = params_from_numpy(seen.pop(0), "cpu")
        return port_decode(tokens)

    ref_cell._decode = recording
    port_cell._decode = synced
    return seen


@pytest.mark.parametrize("mode", ["vanilla", "speculative", "kv8"])
def test_cells_streams_and_summary_equal(small_lm, mode):
    """Both cell pairs driven tick by tick on the same submissions (a
    bounded, shedding, SLO-mixed config with per-step telemetry): token
    streams, summaries, speculative and queue telemetry equal."""
    rcfg, cfg, rparams, params = small_lm
    for mod in (M, RM):
        mod.KV_QUANT = mode == "kv8"
    port_planner, ref_planner = planners()
    engines, all_reqs = [], []
    for mod, eng_mod, req_cls, model, planner, kw in (
            (scen, cells, Request, (cfg, params), port_planner,
             dict(device="cpu")),
            (ref_scen, ref_cells, RefRequest, (rcfg, rparams), ref_planner,
             {})):
        sd = (mod.SpecDecodeConfig(draft_len=3, acceptance=0.6, seed=2)
              if mode == "speculative" else None)
        dcfg = mod.DisaggConfig(prefill_budget=2, handoff_bound=2,
                                starvation_age=3, admission_capacity=3)
        engines.append(eng_mod.DisaggServingEngine(
            *model, slots=3, max_seq=40, disagg=dcfg, planner=planner,
            step_telemetry=True, spec_decode=sd, **kw))
        all_reqs.append(_requests(req_cls, rcfg.vocab))
    port, ref = engines
    if mode == "kv8":
        seen = _sync_decode(port.decode_cell, ref.decode_cell)
    for t in range(500):
        for i in range(10):
            if (i < 5 and i == t) or (t == 3 and i >= 5):
                slo = scen.SLO_CLASSES[i % 2]
                for eng, reqs in zip(engines, all_reqs):
                    eng.submit(reqs[i], slo=slo)
        if t > 3 and not (any(ref.active) or ref.waiting):
            break
        assert ref.step() == port.step()
        assert port.wait_telemetry() == ref.wait_telemetry()
    if mode == "kv8":
        assert not seen
    runs = [roundtrip(dict(
        outs=[r.out for r in reqs], done=[r.done for r in reqs],
        summary=eng.summary(), spec=eng.spec_report(),
        ticks=eng.request_ticks(), steps=eng.step_batches,
        shed=eng.shed, wait=eng.handoff.wait_report(),
        limit=eng.decode_cell.limit, free=eng.decode_cell.free_slots()))
        for eng, reqs in zip(engines, all_reqs)]
    assert runs[0] == runs[1]
    got = runs[0]
    assert got["shed"] and sum(got["done"]) + len(got["shed"]) == 10
    assert got["summary"]["disagg"]["handoff"]["max_depth"] == 2
    assert (got["spec"]["rounds"] > 0) == (mode == "speculative")


@pytest.fixture(scope="module")
def reference_traces(small_lm):
    """The JAX package's disagg traces for the scenario cases below."""
    rcfg, _cfg, rparams, _params = small_lm
    out = {}
    for case, kw in CASES.items():
        spec = ref_scen.make_scenario(**kw["scenario"])
        out[case] = roundtrip(ref_scen.run_scenario(
            spec, rcfg, rparams, planners()[1], **kw["run"](ref_scen,
                                                            ref_engine,
                                                            spec)))
    return out


CASES = {
    # bounded, shedding, SLO-mixed, speculative, sticky
    "shed_speculative": dict(
        scenario=dict(name="chaos", seed=1, slots=4, quick=True),
        run=lambda mod, _eng, spec: dict(
            policy="sticky",
            disagg=mod.DisaggConfig(prefill_budget=2, handoff_bound=3,
                                    starvation_age=4,
                                    admission_capacity=5),
            slo=mod.assign_slo(spec, 0.5),
            spec_decode=mod.SpecDecodeConfig(draft_len=3, acceptance=0.6,
                                             seed=1))),
    # the mirror config with per-cell scopes
    "scoped_mirror": dict(
        scenario=dict(name="bursty", seed=3, slots=4, quick=True),
        run=lambda mod, eng, spec: dict(
            policy="hysteresis", disagg=True,
            prefill_scope=eng.BackendScope(name="prefill"),
            decode_scope=eng.BackendScope(name="decode"))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_disagg_scenario_traces_equal(small_lm, reference_traces, case):
    _rcfg, cfg, _rparams, params = small_lm
    spec = scen.make_scenario(**CASES[case]["scenario"])
    kw = CASES[case]["run"](scen, engine, spec)
    got = roundtrip(scen.run_scenario(spec, cfg, params, planners()[0],
                                      device="cpu", **kw))
    assert got == reference_traces[case]
    if case == "scoped_mirror":
        scopes = got["disagg"].pop("scopes")
        assert scopes["prefill"]["name"] == "prefill"
        assert scopes["decode"]["rungs"] == ["scan"]
        plain = scen.run_scenario(spec, cfg, params, planners()[0],
                                  policy="hysteresis", disagg=True,
                                  device="cpu")
        assert roundtrip(plain) == got
    else:
        assert got["disagg"]["shed"] and got["spec_decode"]["rounds"] > 0
        replayed = scen.replay_trace(got, cfg, params, planners()[0],
                                     device="cpu")
        assert roundtrip(replayed) == got


def test_autoscaled_trace_replays_through_simulator(small_lm):
    """The autoscaled cells' limit trace, batches and request ticks are
    ``simulate_disagg``'s, the rule grew and shrank, and the trace
    replays from its own record."""
    _rcfg, cfg, _rparams, params = small_lm
    spec = scen.make_scenario("bursty", seed=3, slots=4, quick=True)
    slo = scen.assign_slo(spec)
    dcfg = scen.DisaggConfig(prefill_budget=2, handoff_bound=3,
                             starvation_age=4)
    auto = scen.AutoscaleConfig(min_slots=1)
    trace = roundtrip(scen.run_scenario(spec, cfg, params, planners()[0],
                                        policy="hysteresis", disagg=dcfg,
                                        slo=slo, autoscale=auto,
                                        device="cpu"))
    sim = scen.simulate_disagg(spec, disagg=dcfg, slo=slo, autoscale=auto)
    assert trace["autoscale"]["limits"] == sim["limits"]
    assert trace["per_tick_batch"] == sim["per_tick_batch"]
    for key in ("prefill_ticks", "admit_ticks", "completion_ticks"):
        assert trace["disagg"]["requests"][key] == {
            str(r): t for r, t in sim[key].items()}
    assert trace["autoscale"]["grows"] > 0
    assert trace["autoscale"]["shrinks"] > 0
    replayed = scen.replay_trace(trace, cfg, params, planners()[0],
                                 device="cpu")
    assert roundtrip(replayed) == trace


def test_scenario_errors_equal(small_lm, monkeypatch):
    """Scopes or autoscaling without the cells raise ``ValueError`` as in
    the JAX package; the cells under a lane mesh resolve their lanes on
    the mesh rung and give the trace they give on the scan rung."""
    rcfg, cfg, rparams, params = small_lm
    msgs = []
    for mod, eng, model, planner, kw in (
            (scen, engine, (cfg, params), planners()[0],
             dict(device="cpu")),
            (ref_scen, ref_engine, (rcfg, rparams), planners()[1], {})):
        spec = mod.make_scenario("bursty", seed=3, slots=4, quick=True)
        for bad in (dict(prefill_scope=eng.BackendScope(name="p")),
                    dict(autoscale=mod.AutoscaleConfig())):
            with pytest.raises(ValueError) as e:
                mod.run_scenario(spec, *model, planner, **bad, **kw)
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]
    with one_torch_thread():
        ran = rung_runs(monkeypatch)
        engine.lane_cache_reset()
        plain = roundtrip(scen.run_scenario(spec, cfg, params, planners()[0],
                                            disagg=True, device="cpu"))
        assert backend_rungs(ran) == {"backend.scan"}
        engine.lane_cache_reset()
        ran.clear()
        meshed = roundtrip(scen.run_scenario(spec, cfg, params, planners()[0],
                                             mesh=2, disagg=True, device="cpu"))
        assert backend_rungs(ran) == {"backend.mesh"}
    assert meshed == plain
    assert engine.lane_mesh() is None, "the mesh scope must not leak"


@pytest.mark.parametrize("disagg", [False, True])
def test_zero_request_runs_are_neutral(small_lm, disagg):
    _rcfg, cfg, _rparams, params = small_lm
    spec = scen.ScenarioSpec(name="steady", seed=0, slots=2, arrivals=())
    trace = scen.run_scenario(spec, cfg, params, planners()[0],
                              policy="hysteresis", disagg=disagg,
                              device="cpu")
    assert trace["steps"] == 0 and trace["per_tick_batch"] == []
    assert trace["controller"]["efficiency"] == 1.0
    eng = cells.DisaggServingEngine(cfg, params, slots=2, max_seq=32,
                                    planner=planners()[0], device="cpu")
    assert eng.step() is False
    out = eng.run(max_steps=3)
    assert out["tokens_per_step"] == 0.0 and out["in_flight"] == 0
    for per in out["disagg"]["per_class"].values():
        assert per == dict(submitted=0, completed=0, mean_admit_wait=0.0,
                           mean_completion_ticks=0.0)


def test_warm_handoff_does_zero_lane_reresolves(small_lm):
    """Both cells share the lane LRU: once the planner has planned, a
    whole disaggregated serve adds no lane-cache miss."""
    _rcfg, cfg, _rparams, params = small_lm
    planner = planners()[0]
    planner.plan()
    before = engine.lane_cache_info()["misses"]
    assert before > 0
    spec = scen.make_scenario("bursty", seed=1, slots=3, quick=True)
    trace = scen.run_scenario(
        spec, cfg, params, planner, policy="hysteresis",
        disagg=scen.DisaggConfig(prefill_budget=2, handoff_bound=3,
                                 starvation_age=4),
        slo=scen.assign_slo(spec, 0.5), device="cpu")
    assert engine.lane_cache_info()["misses"] == before
    assert trace["controller"]["efficiency"] >= 0.95

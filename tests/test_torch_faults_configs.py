"""The port's oracle, fault primitives, lane-cache integrity hooks and
config registry, held to the JAX package's.

The same seeded inputs go through both packages and every output is
compared exactly: ``RefEngine`` issue arrays and totals on the
``tests/test_engine.py`` streams, the injector's firing schedule, the
breaker's trips, ``retry_call``'s events and ``VirtualClock`` sleeps,
the poison / verify / poisoned-hit counters and event records, the
timing cycles of every spec family, and every ``ArchConfig`` with its
smoke config and shapes.
"""
import dataclasses

import numpy as np
import pytest

import repro.core  # noqa: F401  (first: the reference's import order)
from repro import configs as ref_configs
from repro.core import engine as ref_engine
from repro.core import faults as ref_faults
from repro.core.engine_ref import RefEngine as RefOracle
from repro.core.timing import DEFAULT_SYSTEM as REF_DEFAULT
from repro.pimkernel.executor import PimExecutor as RefExecutor
from repro.pimkernel.tileconfig import PimDType as RefDType

from repro_torch import configs
from repro_torch.core import commands as C
from repro_torch.core import engine, faults
from repro_torch.core.engine_ref import RefEngine
from repro_torch.core.timing import DEFAULT_SYSTEM, cycles_from_dict

from test_engine import build_valid_stream, random_op_tuples
from test_torch_gpu import every_opcode_stream

BOTH = ((faults, engine), (ref_faults, ref_engine))


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


# ---------------------------------------------------------------------
# Configs: spec families, the arch registry, shapes
# ---------------------------------------------------------------------

@pytest.mark.parametrize("family", ["default", *ref_configs.SPEC_FAMILIES])
def test_derive_cycles_equal(family):
    if family == "default":
        port, ref = DEFAULT_SYSTEM, REF_DEFAULT
    else:
        port = configs.SPEC_FAMILIES[family]
        ref = ref_configs.SPEC_FAMILIES[family]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(port.derive_cycles())
            == dataclasses.asdict(ref.derive_cycles()))


def test_registry_order_and_families():
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)
    assert ([n for n, _ in configs.family_specs()]
            == [n for n, _ in ref_configs.family_specs()])
    assert configs.__all__ == ref_configs.__all__
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_configs.SHAPES.items()})


# Fields the port's config types have and the reference's lack (layers
# of two kinds, the muP scalars, the expert share and shared expert, the
# gated norm's order), each with the default that is the reference's
# model.
PORT_ONLY = {None: {"layer_types": (), "position_embedding_type": "rope",
                    "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
                    "attention_multiplier": None, "logits_scaling": 1.0,
                    "first_k_dense_replace": 0, "q_lora_rank": 0,
                    "kv_lora_rank": 0, "qk_nope_head_dim": 0,
                    "qk_rope_head_dim": 0, "v_head_dim": 0,
                    "rope_interleave": False, "rope_scaling": None,
                    "total_layers": 0},
             "moe": {"router_experts": None, "first_expert": 0,
                     "shared_d_ff": 0, "expert_d_ff": 0,
                     "scoring_func": "softmax", "n_group": 1,
                     "topk_group": 1, "norm_topk_prob": True,
                     "routed_scaling_factor": 1.0},
             "ssm": {"gate_before_norm": False, "norm_eps": 1e-6}}


def reference_fields(cfg) -> dict:
    """``asdict(cfg)`` with the port-only fields taken out, each checked
    to hold its default."""
    d = dataclasses.asdict(cfg)
    for group, fields in PORT_ONLY.items():
        sub = d if group is None else d[group]
        for name, default in fields.items():
            if sub is not None:
                assert sub.pop(name) == default, (cfg.name, group, name)
    return d


@pytest.mark.parametrize("arch", list(ref_configs.ARCHS))
def test_arch_config_smoke_and_shapes_equal(arch):
    port, ref = configs.ARCHS[arch], ref_configs.ARCHS[arch]
    assert reference_fields(port) == dataclasses.asdict(ref)
    assert (reference_fields(configs.smoke_config(port))
            == dataclasses.asdict(ref_configs.smoke_config(ref)))
    assert configs.shapes_for(port) == ref_configs.shapes_for(ref)
    for cfg, rcfg in ((port, ref), (configs.smoke_config(port),
                                    ref_configs.smoke_config(ref))):
        assert cfg.param_count() == rcfg.param_count()
        assert cfg.active_param_count() == rcfg.active_param_count()


# ---------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------

def simple_sb_stream() -> np.ndarray:
    """``test_engine.test_simple_sb_stream``'s stream."""
    b = C.StreamBuilder()
    b.emit(C.ACT, 0, 3)
    b.emit_repeat(C.RD, 16, a=0, b=3)
    b.emit(C.ACT, 5, 9)
    b.emit_repeat(C.WR, 4, a=5, b=9)
    b.emit(C.PRE, 0)
    b.emit(C.PREA)
    b.emit(C.REFAB)
    return b.build()


def engine_streams() -> list[np.ndarray]:
    """The streams ``tests/test_engine.py`` holds the engine to: the
    simple SB stream, the W8A16 256x2048 PIM channels, and seeded
    random valid streams."""
    ex = RefExecutor(REF_DEFAULT)
    layout, program = ex.plan(256, 2048, RefDType.W8A16)
    pim = list(ex.build_streams(layout, program, fence=True).streams)
    rng = np.random.default_rng(0)
    rand = [build_valid_stream(random_op_tuples(rng)) for _ in range(12)]
    return [simple_sb_stream(), *pim, *rand]


@pytest.mark.parametrize("validate", [False, True])
def test_ref_engine_equals_reference_oracle(validate):
    ref_cyc = REF_DEFAULT.derive_cycles()
    cyc = cycles_from_dict(dataclasses.asdict(ref_cyc))
    streams = engine_streams()
    assert len(streams) > 12
    for s in streams:
        iss, tot = RefEngine(cyc, validate=validate).run(s)
        iss_ref, tot_ref = RefOracle(ref_cyc, validate=validate).run(s)
        assert iss.dtype == iss_ref.dtype
        np.testing.assert_array_equal(iss, iss_ref)
        assert tot == tot_ref


def test_ref_engine_matches_plain_resolver_on_every_opcode():
    """The port's oracle against its own plain resolver (the kernel's
    CPU stand-in) on valid streams of every opcode."""
    cyc = DEFAULT_SYSTEM.derive_cycles()
    rng = np.random.default_rng(3)
    lanes = [(cyc, every_opcode_stream(rng, cyc.num_banks))
             for _ in range(4)]
    assert set(np.concatenate([s[:, 0] for _c, s in lanes])) \
        == set(range(C.NUM_OPCODES))
    got = engine.resolve_lanes(lanes, device="cpu")
    for (c, s), (iss, tot) in zip(lanes, got):
        iss_ref, tot_ref = RefEngine(c).run(s)
        np.testing.assert_array_equal(iss.astype(np.int64), iss_ref)
        assert tot == tot_ref


# ---------------------------------------------------------------------
# Fault primitives
# ---------------------------------------------------------------------

def test_fault_sites_and_event_records_equal():
    assert faults.FAULT_SITES == ref_faults.FAULT_SITES
    for flt in (faults, ref_faults):
        flt.record_event("planner", "fault", "x")
        flt.set_tick(7)
        flt.record_event("lane_cache", "detect")
        flt.record_event("admission", "shed", "y", tick=3)
        flt.set_tick(None)
        flt.record_event("handoff", "stall")
    assert faults.events() == ref_faults.events()
    assert [e.get("tick") for e in faults.events()] == [None, 7, 3, None]


@pytest.mark.parametrize("seed", range(3))
def test_injector_firing_schedule_equal(seed):
    """Armed specs (windows, persistent, re-armed mid-run) fire on the
    same calls in both packages, through ``maybe_fail`` and its scope."""
    rng = np.random.default_rng(seed)
    sites = list(faults.FAULT_SITES)
    specs = [(sites[int(rng.integers(len(sites)))], int(rng.integers(0, 6)),
              int(rng.integers(-1, 4))) for _ in range(5)]
    calls = [sites[int(i)] for i in rng.integers(0, len(sites), size=80)]
    rearm = {int(i): sites[int(rng.integers(len(sites)))]
             for i in rng.integers(0, 80, size=3)}
    runs = []
    for flt in (faults, ref_faults):
        inj = flt.FaultInjector([flt.FaultSpec(site=s, start=st, count=n,
                                               message=f"m{k}")
                                 for k, (s, st, n) in enumerate(specs)])
        fired = []
        with flt.fault_scope(inj) as active:
            assert active is inj and flt.injector() is inj
            for i, site in enumerate(calls):
                if i in rearm:
                    inj.arm(rearm[i], count=2)
                try:
                    flt.maybe_fail(site)
                    fired.append(None)
                except flt.InjectedFault as e:
                    fired.append((e.site, str(e)))
        assert flt.injector() is None
        flt.maybe_fail("planner")            # no injector: a no-op
        runs.append((fired, dict(inj.calls), inj.injected,
                     [dataclasses.astuple(s) for s in inj.specs],
                     flt.events()))
    assert runs[0] == runs[1]
    assert any(f is not None for f in runs[0][0])


@pytest.mark.parametrize("threshold", [1, 3])
def test_breaker_trips_equal(threshold):
    rng = np.random.default_rng(threshold)
    ops = [(bool(rng.random() < 0.7), f"backend.{k}")
           for k in rng.choice(["scan", "mesh", "pallas"], size=40)]
    runs = []
    for flt in (faults, ref_faults):
        named = flt.CircuitBreaker(threshold, name="decode")
        anon = flt.configure_breaker(threshold)
        assert flt.backend_breaker() is anon
        out = []
        for fail, key in ops:
            for br in (named, anon):
                if fail:
                    out.append(br.record_failure(key))
                else:
                    br.record_success(key)
                out.append(br.tripped(key))
        runs.append((out, named.info(), anon.info(), flt.events()))
    assert runs[0] == runs[1]
    assert any(e["kind"] == "trip" for e in runs[0][3])
    with pytest.raises(ValueError):
        faults.CircuitBreaker(0)


@pytest.mark.parametrize("retries", [0, 1, 3])
def test_retry_call_events_and_sleeps_equal(retries):
    """Transient failures (raised and injected) are retried with the same
    backoff on a ``VirtualClock``; the last failure propagates alike."""
    runs = []
    for flt in (faults, ref_faults):
        clock = flt.VirtualClock(start=1.5)
        out = []
        for fails in range(retries + 3):
            left = [fails]

            def flaky():
                if left[0] > 0:
                    left[0] -= 1
                    raise ValueError(f"flaky {left[0]}")
                return "ok"

            inj = flt.FaultInjector()
            inj.arm("planner", count=fails % 2)
            with flt.fault_scope(inj), \
                    flt.retry_scope(retries=retries, backoff=0.25,
                                    clock=clock):
                try:
                    out.append(flt.retry_call(flaky, "planner"))
                except (ValueError, flt.InjectedFault) as e:
                    out.append(f"{type(e).__name__}: {e}")
        out.append(flt.configure_retry())
        runs.append((out, clock.sleeps, clock.now(), clock(), flt.events()))
    port, ref = runs
    assert port[0][:-1] == ref[0][:-1]
    assert port[0][-1]["retries"] == ref[0][-1]["retries"] == 1
    assert port[1:] == ref[1:]
    assert bool(port[1]) == (retries > 0)    # backoffs were slept
    with pytest.raises(ValueError):
        faults.configure_retry(retries=-1)


def test_reset_restores_boot_state():
    for flt in (faults, ref_faults):
        flt.install_injector(flt.FaultInjector())
        flt.set_tick(4)
        flt.record_event("planner", "fault")
        flt.configure_breaker(7)
        flt.configure_retry(retries=5, backoff=1.0,
                            clock=flt.VirtualClock())
        flt.reset()
        assert flt.injector() is None and flt.events() == []
        assert flt.backend_breaker().threshold == 3
        assert flt.configure_retry()["clock"] is flt.SYSTEM_CLOCK
        assert flt.configure_retry()["retries"] == 1


# ---------------------------------------------------------------------
# Lane-cache integrity hooks
# ---------------------------------------------------------------------

def _twin_lanes(n: int, seed: int):
    rng = np.random.default_rng(seed)
    ref_cyc = REF_DEFAULT.derive_cycles()
    cyc = cycles_from_dict(dataclasses.asdict(ref_cyc))
    streams = [build_valid_stream(random_op_tuples(rng, max_ops=10))
               for _ in range(n)]
    return ([(cyc, s) for s in streams], [(ref_cyc, s) for s in streams])


def _resolve_both(lanes, ref_lanes, keys=None):
    got = engine.resolve_lanes(lanes, keys=keys, device="cpu")
    want = ref_engine.resolve_lanes(ref_lanes, keys=keys)
    for (gi, gt), (wi, wt) in zip(got, want):
        assert gt == wt
        np.testing.assert_array_equal(gi, wi)
    assert engine.lane_cache_info() == ref_engine.lane_cache_info()
    return got


@pytest.mark.parametrize("keyed", [False, True])
def test_poison_verify_and_poisoned_hit_equal(keyed):
    lanes, ref_lanes = _twin_lanes(6, seed=11)
    keys = [f"lane{i}" for i in range(6)] if keyed else None
    clean = _resolve_both(lanes, ref_lanes, keys)
    # Poisoned hits: evicted, counted as misses, one detect each, and
    # the lanes resolve cold to the clean results.
    assert engine.lane_cache_poison(2, seed=5) \
        == ref_engine.lane_cache_poison(2, seed=5) == 2
    again = _resolve_both(lanes, ref_lanes, keys)
    assert [t for _i, t in again] == [t for _i, t in clean]
    assert faults.events() == ref_faults.events()
    assert [e["kind"] for e in faults.events()] == ["detect"] * 2
    # The scrub: the same entries found, evicted and recorded alike.
    for flt in (faults, ref_faults):
        flt.reset_events()
    assert engine.lane_cache_poison(4, seed=9) \
        == ref_engine.lane_cache_poison(4, seed=9) == 4
    assert engine.lane_cache_verify() == ref_engine.lane_cache_verify() == 4
    assert engine.lane_cache_verify() == ref_engine.lane_cache_verify() == 0
    assert faults.events() == ref_faults.events()
    assert len(faults.events()) == 4
    assert engine.lane_cache_info() == ref_engine.lane_cache_info()
    _resolve_both(lanes, ref_lanes, keys)
    # An empty cache: nothing to poison or evict.
    engine.lane_cache_clear()
    ref_engine.lane_cache_clear()
    assert engine.lane_cache_poison(3) == ref_engine.lane_cache_poison(3) \
        == 0
    assert engine.lane_cache_verify() == 0

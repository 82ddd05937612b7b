"""The port's timing path end to end, held to the JAX package.

``repro_torch`` runs here with ``device="cpu"`` (the plain lane
resolver); the reference runs on JAX's CPU backend.  The whole slice —
``GemvRequest`` -> planner -> engine -> ``PimResult`` -> ``OffloadPlanner``
— must agree exactly: the committed ``fleet_parity.json`` cycles and
energy, functional co-simulation outputs, and the offload decisions of a
granite-8b smoke config.  The rules of the port are checked here too: no
module of ``repro_torch`` (nor ``chip_smoke.py`` or
``tests/test_torch_gpu.py``) imports ``jax``, ``ml_dtypes`` or
``repro``, and an entry point given no device raises when there is no
card.

``tests/golden/torch_port_points.json`` pins the full-width numbers the
port must reproduce on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py``): the quickstart points and the granite-8b
W8A8 offload plan, both computed by the JAX package.  Regenerate it
deliberately with ``PYTHONPATH=src python tests/test_torch_slice.py``.
"""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.configs import granite_8b as ref_granite
from repro.configs.base import smoke_config as ref_smoke
from repro.core.pimsim import PimSimulator as RefSimulator
from repro.pimkernel.executor import FunctionalGemv as RefFunctional
from repro.pimkernel.executor import PimExecutor as RefExecutor
from repro.pimkernel.tileconfig import PimDType as RefDType
from repro.serving.offload import OffloadPlanner as RefPlanner

from repro_torch.configs import granite_8b
from repro_torch.configs.base import smoke_config
from repro_torch.core import engine
from repro_torch.core.pimsim import PimSimulator, default_simulator
from repro_torch.core.timing import spec_from_dict
from repro_torch.kernels import ops
from repro_torch.pimkernel.executor import (FunctionalGemv, GemvRequest,
                                            PimExecutor)
from repro_torch.pimkernel.tileconfig import PimDType
from repro_torch.serving.offload import OffloadPlanner

from test_conformance import GOLDEN, GOLDEN_SHAPES, GOLDEN_SPECS

ROOT = pathlib.Path(__file__).resolve().parents[1]
POINTS = pathlib.Path(__file__).parent / "golden" / "torch_port_points.json"

# The quickstart's points (examples/quickstart.py): the Fig-4 headline
# GEMV, its baseline, the fenced run, and reshape off/on at H=1024.
QUICKSTART = [("pim-4096x4096-W8A8", "pim", 4096, 4096, False, False),
              ("base-4096x4096-W8A8", "base", 4096, 4096, False, False),
              ("pim-4096x4096-W8A8-fence", "pim", 4096, 4096, True, False),
              ("pim-1024x4096-W8A8", "pim", 1024, 4096, False, False),
              ("pim-1024x4096-W8A8-reshape", "pim", 1024, 4096, False,
               True)]


def result_record(res) -> dict:
    """The fields a golden pins for one ``PimResult`` (either package)."""
    return dict(cycles=res.cycles, ns=res.ns, flops=res.flops,
                weight_bytes=res.weight_bytes, utilization=res.utilization,
                split=res.split, counts=[int(c) for c in res.counts],
                energy=res.energy)


def decision_record(d) -> dict:
    return dict(site=d.site.name, h=d.site.h, w=d.site.w,
                count=d.site.count, pim_ns=d.pim_ns, host_ns=d.host_ns,
                reshape=d.reshape,
                offload_below_batch=d.offload_below_batch)


def _ref_quickstart() -> dict:
    sim = RefSimulator()
    out = {}
    for label, kind, h, w, fence, reshape in QUICKSTART:
        res = (sim.gemv(h, w, RefDType.W8A8, fence=fence, reshape=reshape)
               if kind == "pim" else sim.baseline(h, w, RefDType.W8A8))
        out[label] = result_record(res)
    return json.loads(json.dumps(out))


def _ref_points() -> dict:
    """The fixture, computed by the JAX package (full width: slow)."""
    planner = RefPlanner(ref_granite.CONFIG)
    return dict(
        quickstart=_ref_quickstart(),
        granite_8b_plan=[decision_record(d) for d in planner.plan()],
        granite_8b_decode_speedup_b1=planner.decode_speedup(batch=1))


def _golden_snapshot(executor) -> dict:
    labels, reqs = [], []
    for sname, sp in GOLDEN_SPECS.items():
        port_spec = spec_from_dict(dataclasses.asdict(sp))
        for (kind, h, w, dt, f, r) in GOLDEN_SHAPES:
            labels.append(f"{sname}/{kind}-{h}x{w}-{dt.name}"
                          + ("-fence" if f else "")
                          + ("-reshape" if r else ""))
            pdt = PimDType[dt.name]
            reqs.append(GemvRequest.pim(h, w, pdt, fence=f, reshape=r,
                                        spec=port_spec)
                        if kind == "pim"
                        else GemvRequest.baseline(h, w, pdt,
                                                  spec=port_spec))
    results = executor.run_many(reqs)
    return json.loads(json.dumps({label: result_record(res) for label, res
                                  in zip(labels, results)}))


@pytest.fixture(autouse=True)
def _fresh_port_lane_cache():
    engine.configure_lane_cache(4096)
    engine.lane_cache_reset()
    yield
    engine.lane_cache_reset()


# ---------------------------------------------------------------------
# Parity on the CPU
# ---------------------------------------------------------------------

def test_fleet_parity_golden_exact_through_port():
    """``fleet_parity.json`` — cycles, counts, energy — comes out exactly
    through the port's executor and plain resolver."""
    fixture = json.loads(GOLDEN.read_text())
    current = _golden_snapshot(PimExecutor(device="cpu"))
    assert set(current) == set(fixture)
    for label in fixture:
        assert current[label] == fixture[label], f"golden drift at {label}"


def test_functional_cosim_matches_reference_and_numpy():
    """Batched HW/SW co-simulation: y equals the reference's and W @ x,
    and the timing results agree field for field."""
    rng = np.random.default_rng(5)
    items, ref_items = [], []
    for dt, lo, hi, (h, w) in ((PimDType.W8A8, -128, 128, (64, 512)),
                               (PimDType.W4A8, -8, 8, (96, 700)),
                               (PimDType.W8A16, -128, 128, (130, 300))):
        wts = rng.integers(lo, hi, size=(h, w)).astype(np.int32)
        x = rng.integers(lo, hi, size=(w,)).astype(np.int32)
        items.append(FunctionalGemv(wts, x, dt))
        ref_items.append(RefFunctional(wts, x, RefDType[dt.name]))
    got = PimSimulator(device="cpu").gemv_functional_many(items)
    ref = RefExecutor().run_functional_many(ref_items)
    for it, (y, res), (y_ref, res_ref) in zip(items, got, ref):
        np.testing.assert_array_equal(y, y_ref)
        np.testing.assert_array_equal(
            y, it.weights.astype(np.int64) @ it.x.astype(np.int64))
        assert result_record(res) == result_record(res_ref)


def test_offload_plan_smoke_granite_matches_reference():
    """Offload decisions of the granite-8b smoke config equal the JAX
    planner's, and so do the decode-speedup telemetry and frontier."""
    cfg = smoke_config(granite_8b.CONFIG)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_smoke(ref_granite.CONFIG))
    port = OffloadPlanner(cfg, device="cpu")
    ref = RefPlanner(ref_smoke(ref_granite.CONFIG))
    for fence in (True, False):
        assert ([decision_record(d) for d in port.plan(fence=fence)]
                == [decision_record(d) for d in ref.plan(fence=fence)])
    assert port.decode_speedup(batch=1) == ref.decode_speedup(batch=1)
    assert port.decode_speedup(batch=4) == ref.decode_speedup(batch=4)
    assert port.frontier() == ref.frontier()


def test_full_width_granite_sites_match_reference():
    """The full-width granite-8b GEMV shapes the card run plans."""
    from repro.serving.offload import decode_gemv_sites as ref_sites
    from repro_torch.serving.offload import decode_gemv_sites
    assert ([dataclasses.astuple(s) for s in
             decode_gemv_sites(granite_8b.CONFIG)]
            == [dataclasses.astuple(s) for s in
                ref_sites(ref_granite.CONFIG)])


def test_points_fixture_quickstart_rederived_from_reference():
    """The quickstart entries of ``torch_port_points.json`` are what the
    JAX package computes today (the granite plan entries are checked on
    the card, where the port reproduces them at full width)."""
    fixture = json.loads(POINTS.read_text())
    assert fixture["quickstart"] == _ref_quickstart()
    sites = [d["site"] for d in fixture["granite_8b_plan"]]
    assert sites[-1] == "lm_head" and len(sites) == 8


def test_sweep_matches_reference_small():
    """``PimSimulator.sweep`` surfaces at small dims, both axes."""
    sim = PimSimulator(device="cpu")
    ref = RefSimulator()
    for axis in ("activation", "output"):
        got = sim.sweep([256, 512], ["W8A8", "W4A16", "FP_W8A16"],
                        axis=axis, base_dim=256)
        want = ref.sweep([256, 512], ["W8A8", "W4A16", "FP_W8A16"],
                         axis=axis, base_dim=256)
        assert got == want


def test_default_simulator_is_one_per_device():
    """``default_simulator`` caches one simulator per resolved device,
    and its numbers are the reference's ``default_simulator``'s."""
    from repro.core.pimsim import default_simulator as ref_default
    sim = default_simulator("cpu")
    assert sim is default_simulator(torch.device("cpu"))
    assert sim.executor.device == torch.device("cpu")
    assert sim.speedup(256, 512, "W8A8") == ref_default().speedup(
        256, 512, RefDType.W8A8)


# ---------------------------------------------------------------------
# Rules of the port
# ---------------------------------------------------------------------

def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_never_imports_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"]
    names = {str(f.relative_to(ROOT / "src" / "repro_torch"))
             for f in files[:-2]}
    assert {"core/faults.py", "core/engine_ref.py", "configs/__init__.py",
            "configs/specfam.py", "configs/qwen2_72b.py",
            "serving/policy.py", "serving/scenarios.py"} <= names
    assert len(files) > 40
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), \
                f"{path.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("entry", ["simulator", "executor", "planner",
                                   "resolve_fleet", "resolve_lanes",
                                   "run_streams", "prepare_weights",
                                   "from_numpy", "default_simulator"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    """No device given and no card: raise, never drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cyc = spec_from_dict(dataclasses.asdict(
        GOLDEN_SPECS["lp5x-9600"])).derive_cycles()
    stream = np.zeros((4, 4), np.int32)
    calls = {
        "simulator": lambda: PimSimulator(),
        "executor": lambda: PimExecutor(),
        "planner": lambda: OffloadPlanner(granite_8b.CONFIG),
        "resolve_fleet": lambda: engine.resolve_fleet([(cyc, [stream])]),
        "resolve_lanes": lambda: engine.resolve_lanes([(cyc, stream)]),
        "run_streams": lambda: engine.run_streams(cyc, [stream]),
        "prepare_weights": lambda: ops.prepare_weights(
            np.ones((4, 8), np.float32), "W8A8"),
        "from_numpy": lambda: ops.QuantWeights.from_numpy(
            "W8A8", np.ones((4, 8), np.int8), np.ones(4, np.float32),
            (4, 8)),
        "default_simulator": lambda: default_simulator(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


if __name__ == "__main__":          # regenerate the committed fixture
    POINTS.write_text(json.dumps(_ref_points(), indent=1, sort_keys=True))
    print(f"wrote {POINTS}")

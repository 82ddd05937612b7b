"""The port's dry-run PIM offload report, held to the JAX package's.

``pim_offload_report`` in both packages, at smoke widths: each case puts
the arch's smoke config under its name in both packages' registries
(the port's plain lane resolver takes ~0.7 ms a command on the CPU, so
full width runs on the card).  The records must be ``==`` after a JSON
round trip, with and without ``--scenario``, ``--disagg`` and the
``spec-decode`` scenario, and the CLIs must print the same lines.  The
CLI's other modes run at smoke size: cell lowering (``--shape``,
``--mesh pod1|pod2``, ``--variant``, ``--extrap-only``, ``--all
--skip-existing``) on the fake 512-rank mesh, and ``--pim --mesh 4`` on
a lane mesh of four CPU shards, whose report equals the reference's.

``tests/golden/torch_pim_report.json`` is the JAX package's report for
granite-8b at its published widths (``bursty`` x ``hysteresis``,
``--disagg``); ``chip_smoke.py`` phase 11 reproduces it on the card.
Regenerate it deliberately with
``PYTHONPATH=src python tests/test_torch_dryrun.py`` (a few minutes).
"""
import ast
import dataclasses
import contextlib
import io
import json
import os
import pathlib
import tempfile

import pytest
import torch

import repro.core  # noqa: F401  (first: the reference's import order)
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke
from repro.core import engine as ref_engine

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.specfam import SPEC_FAMILIES
from repro_torch.core import engine, faults
from repro_torch.launch import dryrun as PD
from repro_torch.serving.offload import decode_gemv_sites

FIXTURE = pathlib.Path(__file__).parent / "golden" / "torch_pim_report.json"
FIXTURE_ARGS = dict(scenario="bursty", policy="hysteresis", disagg=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors run fastest on one intra-op thread, and the
    suite's worker processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with JAX already initialized: its
    first lines set ``XLA_FLAGS`` to 512 host devices, which is undone
    here so no later test or subprocess inherits it."""
    import jax
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


def _roundtrip(x):
    return json.loads(json.dumps(x))


@pytest.fixture
def both(monkeypatch, tmp_path):
    """(reference dryrun, port dryrun), writing under ``tmp_path``, with
    the lane caches cold."""
    rd = _reference_dryrun()
    monkeypatch.setattr(rd, "OUT_DIR", tmp_path / "ref")
    monkeypatch.setattr(PD, "OUT_DIR", tmp_path / "port")
    ref_engine.lane_cache_reset()
    engine.reset_backend_scopes()
    engine.lane_cache_reset()
    faults.reset()
    yield rd, PD
    engine.lane_cache_reset()
    ref_engine.lane_cache_reset()


_REF_REPORTS: dict = {}


def _ref_report(rd, arch: str, **kw) -> dict:
    """The reference's report at smoke width, computed once a module for
    each (arch, options): the smoke registries are the same each time."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REF_REPORTS:
        _REF_REPORTS[key] = _roundtrip(rd.pim_offload_report(arch, **kw))
    return _REF_REPORTS[key]


def _smoke_registries(monkeypatch, rd, arch):
    monkeypatch.setattr(rd, "ARCHS", {arch: ref_smoke(REF_ARCHS[arch])})
    monkeypatch.setattr(PD, "ARCHS", {arch: smoke_config(ARCHS[arch])})


CASES = [
    ("granite-8b", dict()),
    ("granite-8b", dict(scenario="bursty", policy="hysteresis",
                        disagg=True)),
    ("granite-moe-3b-a800m", dict(scenario="spec-decode")),
    ("mamba2-130m", dict(scenario="diurnal", policy="sticky")),
]


@pytest.mark.parametrize("arch,kw", CASES,
                         ids=[f"{a}-{'-'.join(map(str, k.values()))}"
                              for a, k in CASES])
def test_report_equals_reference(both, monkeypatch, tmp_path, arch, kw):
    rd, pd = both
    _smoke_registries(monkeypatch, rd, arch)
    want = _ref_report(rd, arch, **kw)
    got = pd.pim_offload_report(arch, device="cpu", **kw)
    assert _roundtrip(got) == want
    assert sorted(got) == sorted(want)
    written = json.loads((tmp_path / "port" / "pim" / f"{arch}.json")
                         .read_text())
    assert written == want


def _run_main(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as ex:
        main(argv)
    return ex.value.code, out.getvalue()


def test_cli_prints_the_reference_lines(both, monkeypatch):
    rd, pd = both
    arch = "granite-8b"
    _smoke_registries(monkeypatch, rd, arch)
    argv = ["--pim", "--arch", arch, "--scenario", "bursty", "--policy",
            "hysteresis", "--disagg"]
    monkeypatch.setattr("sys.argv", ["dryrun", *argv])
    ref_code, ref_out = _run_main(lambda _argv: rd.main(), argv)
    code, out = _run_main(pd.main, [*argv, "--device", "cpu"])
    assert (code, ref_code) == (0, 0)
    lines = [ln for ln in out.splitlines() if ln.startswith("[pim]")]
    assert lines == [ln for ln in ref_out.splitlines()
                     if ln.startswith("[pim]")]
    assert len(lines) == 3 + len(SPEC_FAMILIES)


SMALL_SHAPES = {"train_4k": ShapeConfig("train_4k", 128, 32, "train"),
                "prefill_32k": ShapeConfig("prefill_32k", 256, 32,
                                           "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 256, 32, "decode")}


@pytest.mark.parametrize("argv,names", [
    (["--arch", "granite-8b", "--shape", "decode_32k"],
     (0, "[ok] granite-8b decode_32k pod1")),
    (["--all", "--skip-existing"], (0, "[skip] granite-8b train_4k pod1")),
    (["--pim", "--arch", "granite-8b", "--mesh", "4"],
     (0, "[pim] lane mesh: 4 shard(s) of cpu")),
    (["--pim", "--all", "--mesh", "both"],
     (2, "--pim takes an integer --mesh N")),
    (["--arch", "granite-8b", "--shape", "decode_32k", "--variant",
      "serve-tp-w8"], (0, "[ok] granite-8b decode_32k pod1")),
    (["--arch", "granite-8b", "--shape", "decode_32k", "--extrap-only"],
     (0, "[extrap] granite-8b decode_32k pod1")),
    (["--arch", "granite-8b", "--shape", "decode_32k", "--mesh", "pod2"],
     (0, "[ok] granite-8b decode_32k pod2")),
])
def test_cli_refuses_cell_lowering_and_the_lane_mesh(both, monkeypatch,
                                                      tmp_path, capsys, argv,
                                                      names):
    """Every mode of the CLI runs (smoke configs, shapes cut to smoke
    size); a pod mesh with ``--pim`` is refused as the reference refuses
    it.  ``--pim --mesh 4`` gives the reference's report."""
    rd, pd = both
    _smoke_registries(monkeypatch, rd, "granite-8b")
    if argv[0] != "--pim":          # lowering: one layer is enough
        monkeypatch.setitem(pd.ARCHS, "granite-8b", dataclasses.replace(
            pd.ARCHS["granite-8b"], n_layers=1))
    for name, shp in SMALL_SHAPES.items():
        monkeypatch.setitem(pd.SHAPES, name, shp)
    monkeypatch.setitem(pd.SHAPES, "long_500k", pd.SHAPES["long_500k"])
    code_want, text = names
    if "--skip-existing" in argv:
        for arch, shape in pd.all_cells():
            path = pd._out_path(arch, shape, "pod1")
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps({"status": "ok"}))
    if "--extrap-only" in argv:
        pd.run_cell("granite-8b", "decode_32k", False, extrapolate=False,
                    device="cpu")
    with pytest.raises(SystemExit) as ex:
        pd.main([*argv, "--device", "cpu"])
    out = capsys.readouterr()
    assert ex.value.code == code_want, out
    assert text in (out.out if code_want == 0 else out.err)
    assert engine.lane_mesh() is None
    if "--variant" in argv:
        rec = json.loads(pd._out_path("granite-8b", "decode_32k", "pod1",
                                      "serve-tp-w8").read_text())
        assert rec["status"] == "ok" and rec["variant"] == "serve-tp-w8"
    if "--extrap-only" in argv:
        rec = json.loads(pd._out_path("granite-8b", "decode_32k", "pod1")
                         .read_text())
        assert rec["extrap"]["probe_layers"] == [2, 4]
    if argv[0] == "--pim" and code_want == 0:
        want = _ref_report(rd, "granite-8b")
        got = json.loads((tmp_path / "port" / "pim" / "granite-8b.json")
                         .read_text())
        assert got == want


@pytest.mark.parametrize("argv,names", [
    (["--pim"], "--pim needs --all or --arch"),
    (["--pim", "--arch", "no-such-arch"], "--pim needs --all or --arch"),
    (["--pim", "--all", "--scenario", "nope"], "nope"),
    (["--pim", "--all", "--policy", "nope"], "nope"),
])
def test_cli_argument_errors(capsys, argv, names):
    with pytest.raises(SystemExit) as ex:
        PD.main([*argv, "--device", "cpu"])
    assert ex.value.code == 2
    assert names in capsys.readouterr().err


def test_report_module_imports_no_distribution_code():
    """The dry-run imports nothing of the JAX package or JAX: its
    distribution, mesh and training code is the port's own."""
    tree = ast.parse(pathlib.Path(PD.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names and all(n.split(".")[0] != "repro" and "jax" not in n
                         for n in names)
    assert all(n.startswith("repro_torch.") for n in names
               if "distribution" in n or "launch.mesh" in n
               or "training" in n)


def test_pim_report_fixture_is_well_formed():
    fx = json.loads(FIXTURE.read_text())
    assert fx["arch"] == "granite-8b"
    assert sorted(fx["variants"]) == sorted(["lp5x-9600", "fast-core",
                                             "mac2", "srf1k"])
    sites = [(s.name, s.h, s.w, s.count)
             for s in decode_gemv_sites(ARCHS["granite-8b"])]
    for var in fx["variants"].values():
        assert [(s["name"], s["h"], s["w"], s["count"])
                for s in var["sites"]] == sites
        assert sorted(var["decode_speedup"]) == ["1", "16", "2", "4", "8"]
    assert fx["serving_policy"]["scenario"] == FIXTURE_ARGS["scenario"]
    assert fx["serving_policy"]["policy"] == FIXTURE_ARGS["policy"]
    assert fx["disagg"]["policy"] == FIXTURE_ARGS["policy"]
    assert sorted(fx["spec_families"]) == sorted(SPEC_FAMILIES)


if __name__ == "__main__":          # regenerate the committed fixture
    rd = _reference_dryrun()
    rd.OUT_DIR = pathlib.Path(tempfile.mkdtemp())
    rec = rd.pim_offload_report("granite-8b", **FIXTURE_ARGS)
    FIXTURE.write_text(json.dumps(_roundtrip(rec), indent=1,
                                  sort_keys=True))
    print(f"wrote {FIXTURE}")

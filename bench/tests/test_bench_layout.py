"""The benchmark's files: every part found by name from BENCHMARK.json,
the contract's shape, nothing of JAX or the JAX package imported, and a
new cell, mix and metric added from files and entries alone."""
from __future__ import annotations

import ast
import hashlib
import json
import pathlib
import re

import tinyroot

from bench import harness

ROOT = tinyroot.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_part_is_found_by_name():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        assert (ROOT / "bench" / "configs" / f"{cell['config']}.json").exists()
        mix = harness.load_json(ROOT / "bench" / "traffic"
                                / f"{cell['traffic']}.json")
        assert (ROOT / "bench" / "drivers" / f"{mix['driver']}.py").exists()
        reports = harness.metrics_for(BENCH, cell["name"], False)
        assert "setup_s" in {m["name"] for m in reports} and len(reports) > 1
        assert harness.metrics_for(BENCH, cell["name"], True)
    for cfg in BENCH["configs"]:
        assert (ROOT / cfg["file"]).exists()
        assert harness.load_json(ROOT / cfg["file"])["name"] == cfg["name"]
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = harness.load_module(ROOT / "bench" / "metrics"
                                     / f"{m['name']}.py")
        assert reader.UNIT == m["unit"]
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        reader = harness.load_module(ROOT / "bench" / "metrics"
                                     / f"{m['name']}.py")
        assert reader.LAYER == m["layer"] and m["moves"] in e2e


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25
               for m in BENCH["end_to_end"])


def _top_imports(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_of_jax_or_the_jax_package_is_imported():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert files
    for path in files:
        found = _top_imports(path) & {"jax", "jaxlib", "flax", "repro",
                                      "benchmarks"}
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        assert not _top_imports(path) & {"repro_torch", "repro", "jax",
                                         "bench"}, path


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    root = tinyroot.make(tmp_path)
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (root / "bench").rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "bench" / "traffic" / "sweep_tiny.json")
                     .read_text())
    mix["channel_mix"] = {"4": 2}
    (root / "bench" / "traffic" / "sweep_four.json").write_text(
        json.dumps(mix))
    (root / "bench" / "metrics" / "queries.sweep.py").write_text(
        '"""Queries the window completed."""\nUNIT = "queries"\n'
        'LAYER = "serving.offload"\n\n\ndef read(obs):\n'
        '    return obs.get("queries")\n')
    bench["workloads"].append(dict(name="tiny.sweep_four", config="tiny",
                                   traffic="sweep_four", chips=1, why="t"))
    for m in bench["end_to_end"]:
        if "tiny.sweep" in m.get("workloads", []):
            m["workloads"].append("tiny.sweep_four")
    bench["per_layer"].append(dict(
        name="queries.sweep", unit="queries", better="higher",
        source="host_clock", layer="serving.offload",
        moves="design_points_per_s", workloads=["tiny.sweep_four"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    run = tinyroot.run(root, "tiny.sweep_four", trace=True)
    line = harness.result_line(root, run)
    assert line["correct"] and line["metrics"]["queries.sweep"]["value"] > 0
    run = tinyroot.run(root, "tiny.sweep_four")
    assert "design_points_per_s" in harness.result_line(root, run)["metrics"]
    for p, digest in before.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == digest, p

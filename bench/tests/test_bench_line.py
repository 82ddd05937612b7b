"""The result line: the contract's keys and nothing else, its checks last,
and no result without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import tinyroot

from bench import harness

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinyroot.make(tmp_path_factory.mktemp("line"))


@pytest.mark.parametrize("cell", ["tiny.sweep", "tiny.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(root, cell, trace):
    run = tinyroot.run(root, cell, trace=trace)
    line = json.loads(json.dumps(harness.result_line(root, run)))
    assert set(line) <= KEYS | {"breakdown"} and KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0
    assert set(line["device"]) == DEVICE
    bench = harness.load_json(root / "BENCHMARK.json")
    want = {m["name"] for m in harness.metrics_for(bench, cell, trace)}
    assert set(line["metrics"]) <= want and line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], (int, float))
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if not trace:
        assert "setup_s" in line["metrics"]


def test_no_result_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = harness.main(tinyroot.ROOT, ["--workload",
                                        "granite-8b.sweep_cold", "--seed",
                                        "1", "--seconds", "1"], 0.0)
    assert code != 0


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copytree(tinyroot.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(tinyroot.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "granite-8b.sweep_cold", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()


def test_forbidden_names_are_compared_whole(monkeypatch):
    import repro_torch  # noqa: F401

    assert "repro" not in sys.modules
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert harness.loaded_forbidden() == ["jaxlib"]

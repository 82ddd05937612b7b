"""Run one cell of ``BENCHMARK.json`` once and print the result line.

Everything is found by name.  The cell names its configuration
(``bench/configs/<config>.json``) and its traffic mix
(``bench/traffic/<traffic>.json``); the mix names its driver
(``bench/drivers/<driver>.py``), which sets up, warms up, measures for
``--seconds`` and judges what the timed path produced against the plain
reference.  Each metric the cell reports has a reader of its own,
``bench/metrics/<metric>.py``, which takes its value from the driver's
observations and returns ``None`` when it finds nothing to read.  A new
cell, mix or metric is new files and new entries, never an edit.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    name = "bench_" + path.parent.name + "_" + path.stem.replace(".", "_") \
        .replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver is given, and what it found."""

    root: pathlib.Path
    name: str
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float
    obs: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)
    memory_peak: int = 0
    attempted: int = 0
    failed: int = 0
    profile: dict | None = None
    # what the serving controls read again: the weights and the judged
    # (prompt, served tokens)
    weights: object = None
    judged: list = dataclasses.field(default_factory=list)

    def window_opens(self) -> None:
        """Set-up ends here: everything since the process started."""
        self.obs["setup_s"] = time.perf_counter() - self.started

    def check(self, name: str, value, limit) -> None:
        """A number compared with its limit: the run is correct while
        every value is at most its limit."""
        self.checks.append((name, value, limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v is not None and v <= lim for _n, v, lim in self.checks)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, name: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: every entry whose ``workloads`` lists it, or that lists none."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def execute(root: pathlib.Path, name: str, seed: int, seconds: float,
            trace: bool, device, started: float) -> Run:
    bench = load_json(root / "BENCHMARK.json")
    cell = find_cell(bench, name)
    config = load_json(root / "bench" / "configs" / f"{cell['config']}.json")
    mix = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    driver = load_module(root / "bench" / "drivers" / f"{mix['driver']}.py")
    run = Run(root=root, name=name, cell=cell, config=config, mix=mix,
              seed=seed, seconds=seconds, trace=trace, device=device,
              started=started)
    driver.run(run)
    return run


def read_metrics(root: pathlib.Path, bench: dict, run: Run) -> dict:
    out = {}
    for m in metrics_for(bench, run.name, run.trace):
        reader = load_module(root / "bench" / "metrics" / f"{m['name']}.py")
        value = reader.read(run.obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def result_line(root: pathlib.Path, run: Run) -> dict:
    import torch

    bench = load_json(root / "BENCHMARK.json")
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": run.cell["chips"],
              "memory_peak_bytes": int(run.memory_peak)}
    if dev.type == "cuda":
        device["power"] = power_limit()
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": read_metrics(root, bench, run),
            "device": device}
    if run.trace and run.profile is not None:
        line["breakdown"] = {"device_ops": run.profile["device_ops"],
                             "idle_gaps": run.profile["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in run.checks}
    return line


def loaded_forbidden() -> list:
    """Top-level names of loaded modules the run must not hold, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(root: pathlib.Path, argv: list, started: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = load_json(root / "BENCHMARK.json")
    chips = find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    run = execute(root, args.workload, args.seed, args.seconds,
                  bool(args.trace), torch.device("cuda", 0), started)
    found = loaded_forbidden()
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    line = result_line(root, run)
    seen = {k: v for k, v in run.obs.items()
            if isinstance(v, (int, float))
            or (isinstance(v, list) and len(v) <= 400)}
    print(f"bench: observed {json.dumps(seen)}", file=sys.stderr)
    for n, v, lim in run.checks:
        print(f"check {n}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

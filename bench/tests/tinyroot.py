"""A copy of the benchmark with small cells added from files alone, for
driving whole runs on the CPU: a smoke-width dense model under each of
the two drivers, found by name like every other cell; and granite-8b's
widths at 2 layers served, for the control on the card."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(name="tiny", source="smoke widths of a dense GQA decoder",
            family="dense", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, d_head=32, d_ff=256, vocab=512, mlp="swiglu",
            rope_theta=1e6, norm_eps=1e-5, reduced=[])
CELLS = {"tiny.sweep": ("sweep_cold", "sweep_tiny",
                        dict(channel_mix={"2": 1, "4": 1})),
         "tiny.serve": ("serve_decode", "serve_tiny",
                        dict(slots=4, max_seq=128, prompt_len=[8, 64],
                             new_tokens=[4, 16], block=4,
                             warm_prompt_lens=[8, 64],
                             profile_after_steps=3, profile_steps=2))}
TWIN = {"tiny.sweep": "granite-8b.sweep_cold",
        "tiny.serve": "granite-8b.serve_decode",
        "mid.serve": "granite-8b.serve_decode"}
# granite-8b's widths at 2 of its 36 layers: the served control on the card
MID = dict(TINY, name="mid", n_layers=2, d_model=4096, n_heads=32,
           n_kv_heads=8, d_head=128, d_ff=14336, vocab=49152)


def make(tmp: pathlib.Path) -> pathlib.Path:
    """``tmp/root``: BENCHMARK.json and bench/ copied, the tiny cells
    added as new files and entries; each reports what its full-size twin
    reports."""
    root = tmp / "root"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "bench" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (root / "bench" / "configs" / "mid.json").write_text(json.dumps(MID))
    cells = dict(CELLS, **{"mid.serve": ("serve_decode", "serve_decode",
                                         {})})
    for cell, (base, mix_name, changes) in cells.items():
        if mix_name != base:
            mix = json.loads((ROOT / "bench" / "traffic" / f"{base}.json")
                             .read_text())
            mix.update(changes)
            (root / "bench" / "traffic" / f"{mix_name}.json").write_text(
                json.dumps(mix))
        bench["workloads"].append(dict(name=cell, config=cell.split(".")[0],
                                       traffic=mix_name, chips=1,
                                       why="smoke widths on the CPU"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if TWIN[cell] in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: pathlib.Path, cell: str, seed: int = 2 ** 31 + 77,
        seconds: float = 1.0, trace: bool = False):
    """One whole run of ``cell`` on the CPU, the chip check skipped."""
    import torch

    from bench import harness

    return harness.execute(root, cell, seed, seconds, trace,
                           torch.device("cpu"), time.perf_counter())

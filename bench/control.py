"""The controls: the reference put in the program's place, one precision
below what the configuration states, must come out as not correct.

* Simulated numbers (float64 ns and energy over integer cycles): the
  reference with ns and energy in float32, held to the float64 reference
  by the same comparison a run makes.
* Served tokens (float32, TF32 off): at each position of the same prompts
  and served tokens, the gap in the float32 reference of the token the
  TF32 reference puts first.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds <s>]

runs the cell's own set-up and a short window for each seed in one
process (the card holds one model at a time), then reads the program's
numbers and the control's beside them: one JSON line per seed.  The
benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "bench"]

from bench import generator, judge  # noqa: E402
from bench.reference import sim  # noqa: E402


def sim_control(cfg: dict, spec_dict: dict, dtype: str, fence: bool) -> dict:
    """The float32 reference judged as a run judges the program."""
    dec, pts = sim.plan(cfg, sim.spec_from_dict(spec_dict), dtype, fence,
                        float_bits=32)
    return judge.spec_points(cfg, spec_dict, dec, pts,
                             {k: p.streams for k, p in pts.items()},
                             dtype, fence)


def serve_control(run) -> float:
    """The widest TF32 gap over the requests the run judged."""
    from bench.reference import model as ref_model

    return max(float(ref_model.served_gaps(run.config, run.weights, p, o,
                                           use_tf32=True).max())
               for p, o in run.judged)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()

    import torch

    from bench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_json(ROOT / "bench" / "configs"
                            / f"{cell['config']}.json")
    mix = harness.load_json(ROOT / "bench" / "traffic"
                            / f"{cell['traffic']}.json")
    for seed in args.seeds:
        out = dict(workload=args.workload, seed=seed)
        if mix["driver"] == "serve":
            run = harness.execute(ROOT, args.workload, seed, args.seconds,
                                  False, torch.device("cuda", 0),
                                  time.perf_counter())
            out["program"] = {n: v for n, v, _l in run.checks}
            out["control"] = {"served_logit_gap": serve_control(run)}
            del run
            torch.cuda.empty_cache()
        else:
            space = generator.spec_space(ROOT, mix)
            q = generator.sweep_queries(mix, space, seed,
                                        mix["warm_queries"] + 1)[-1]
            spec = q[int(generator.rng_for(seed, 9).integers(len(q)))]
            got = sim_control(cfg, spec, mix["dtype"], mix["fence"])
            out["control"] = {"points_differing": got["points"],
                              "decisions_differing": got["decisions"],
                              "ns_energy_rel_gap": got["gap"]}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The controls of a ``serve_mla`` cell: the reference put in the
program's place, one precision below what the configuration states, must
come out as not correct.

* Telemetry (float64 ns over integer cycles): the reference planner
  priced in float32, its per-step telemetry at each batch the run served
  held to the float64 reference's, as the run holds the program's.
* Served tokens (float32, TF32 off): at each position of the judged
  prompts and served tokens, whether the token the TF32 reference puts
  first is the float32 reference's best; the share that is not.

    python3 bench/control_mla.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds <s>]

runs the cell's own set-up and a short window for each seed in one
process, then prints the program's checks and the controls' beside them:
one JSON line per seed.  The benchmark's runs never run it.
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

from bench.reference import deepseek_v3 as ref_model  # noqa: E402
from bench.reference import mla_sites, sim  # noqa: E402


def telemetry_control(cfg: dict, batches: list, dtype: str,
                      fence: bool) -> int:
    """Steps whose float32-priced telemetry differs from the float64
    reference's."""
    want = mla_sites.plan(cfg, sim.Spec(), dtype, fence)
    got = mla_sites.plan(cfg, sim.Spec(), dtype, fence, float_bits=32)
    return sum(sim.decode_speedup(got, b) != sim.decode_speedup(want, b)
               for b in batches)


def served_control(run) -> float:
    """The share of the judged positions whose TF32 pick is not the
    float32 reference's best."""
    off = n = 0
    for p, o in run.judged:
        g = ref_model.served_gaps(run.config, run.weights, p, o,
                                  use_tf32=True)
        off += int((g > 0).sum())
        n += len(o)
    return off / n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()

    import torch

    from bench import harness

    for seed in args.seeds:
        run = harness.execute(ROOT, args.workload, seed, args.seconds,
                              False, torch.device("cuda", 0),
                              time.perf_counter())
        out = dict(workload=args.workload, seed=seed,
                   program={n: v for n, v, _l in run.checks},
                   observed={k: run.obs.get(k) for k in (
                       "tokens_compared", "tokens_off_best",
                       "served_logit_gap", "judge_s", "steps",
                       "prefills", "tokens", "window_s")},
                   control={
                       "served_tokens_off_best": served_control(run),
                       "telemetry_steps_differing": telemetry_control(
                           run.config, run.telemetry_batches,
                           run.mix.get("dtype", "W8A8"),
                           run.mix.get("fence", True))})
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

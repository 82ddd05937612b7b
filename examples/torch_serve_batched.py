"""End-to-end example: serve a small LM with batched requests + PIM offload.

The paper's use case is on-device LLM inference: decode-phase matmuls are
GEMVs against resident weights, exactly what LP5X-PIM accelerates.  This
example (the PyTorch port's version of ``examples/serve_batched.py``)
serves a reduced granite-8b with continuous batching and reports the
simulator-predicted decode speedup of offloading each projection to the
LPDDR5X-PIM memory system.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

(On the CPU the full-width granite-8b plan resolves through the plain
torch lane resolver, which takes many minutes.)
"""
import argparse

import numpy as np

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.core.pimsim import PimSimulator
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import OffloadPlanner
from repro_torch.serving.policy import OffloadController

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()
dev = resolve_device(args.device)

full_cfg = ARCHS["granite-8b"]
cfg = smoke_config(full_cfg)
params = M.init_params(cfg, device=dev)
planner = OffloadPlanner(full_cfg, PimSimulator(device=dev))
# Adaptive offload control: the hysteresis policy damps decision flips
# near the crossover batch, so it needs one planner query for the whole
# run instead of one per decode step.
controller = OffloadController(planner, policy="hysteresis")
engine = ServingEngine(cfg, params, slots=4, max_seq=96, planner=planner,
                       controller=controller, device=dev)

rng = np.random.default_rng(0)
requests = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5 + i),
                    max_new=6) for i in range(10)]
for r in requests:
    engine.submit(r)
stats = engine.run(max_steps=500)

print(f"completed {len(requests)} requests "
      f"({stats['tokens']} generated tokens, {stats['steps']} decode "
      f"steps, continuous batching over 4 slots)")
for r in requests[:3]:
    print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")

tel = stats["pim_telemetry"]
print(f"\nLP5X-PIM offload for the full {full_cfg.name} decode step "
      f"(batch={tel['batch']}):")
print(f"  host-only GEMV time : {tel['host_ns']/1e3:9.1f} us")
print(f"  PIM-offloaded       : {tel['mixed_ns']/1e3:9.1f} us   "
      f"-> {tel['speedup']:.2f}x")
print(f"  offloaded sites: {', '.join(tel['offloaded'][:6])} ... "
      f"({len(tel['offloaded'])}/{tel['n_sites']})")

rep = stats["policy"]
print(f"\nadaptive offload control ({rep['policy']} policy):")
print(f"  realized speedup {rep['realized_speedup']:.2f}x vs oracle "
      f"{rep['oracle_speedup']:.2f}x (efficiency {rep['efficiency']:.3f})")
print(f"  {rep['switches']} decision switches, "
      f"{rep['planner_queries']} planner queries over {rep['steps']} steps")

# batch-size sweep: where does PIM stop winning?
print("\nbatch-size crossover (decode-step speedup from offload):")
for b in (1, 2, 4, 8, 16, 32):
    s = planner.decode_speedup(batch=b)["speedup"]
    print(f"  batch {b:3d}: {s:5.2f}x")

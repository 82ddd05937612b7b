"""Quickstart: simulate a GEMV on LP5X-PIM and reproduce a Fig-4 point.

The PyTorch port's version of ``examples/quickstart.py``: the full paper
pipeline — Data Mapper placement, IRF code gen, command-stream synthesis,
cycle-accurate timing (the lane-scan kernel on the card), energy — plus
the functional HW/SW co-simulation proving the command stream computes
the right answer.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

(On the CPU the lanes resolve through the plain torch resolver, which
takes minutes for these full-width GEMVs.)
"""
import argparse

import numpy as np

from repro_torch.core.pimsim import PimSimulator
from repro_torch.pimkernel.tileconfig import PimDType

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()

sim = PimSimulator(device=args.device)

# --- paper Fig. 4 headline point: 4096x4096 W8A8 ------------------------
H = W = 4096
dt = PimDType.W8A8
pim = sim.gemv(H, W, dt)
base = sim.baseline(H, W, dt)
print(f"GEMV {H}x{W} {dt.name} on LPDDR5X-9600 x4ch")
print(f"  non-PIM sequential weight read : {base.ns/1e3:8.1f} us")
print(f"  LP5X-PIM (MB-mode broadcast)   : {pim.ns/1e3:8.1f} us")
print(f"  speedup                        : {base.ns/pim.ns:8.2f}x "
      f"(paper: 6.0-6.2x)")
fenced = sim.gemv(H, W, dt, fence=True)
print(f"  with 150 ns fences             : {base.ns/fenced.ns:8.2f}x "
      f"(paper: >5x)")
print(f"  energy                         : "
      f"{pim.energy['pj_per_op']:8.2f} pJ/op vs "
      f"{base.energy['pj_per_op']:.2f} pJ/op baseline")

# --- behavioral fidelity: the command stream computes W @ x -------------
rng = np.random.default_rng(0)
Hs, Ws = 256, 2048
weights = rng.integers(-128, 128, size=(Hs, Ws)).astype(np.int32)
x = rng.integers(-128, 128, size=(Ws,)).astype(np.int32)
y, res = sim.gemv_functional(weights, x, dt)
ok = np.array_equal(y, weights.astype(np.int64) @ x.astype(np.int64))
print(f"\nHW/SW co-simulation on {Hs}x{Ws}: streams -> device model "
      f"== numpy GEMV? {ok}")
print(f"  {res.cycles} cycles, utilization {res.utilization:.0%}, "
      f"{int(res.counts.sum())} DRAM/PIM commands")

# --- batched co-simulation: many (weights, x) in one timing dispatch ----
from repro_torch.pimkernel.executor import FunctionalGemv

items = []
for hs, ws in ((128, 512), (192, 1024), (64, 2048)):
    wm = rng.integers(-8, 8, size=(hs, ws)).astype(np.int32)
    xv = rng.integers(-8, 8, size=(ws,)).astype(np.int32)
    items.append(FunctionalGemv(wm, xv, PimDType.W4A8))
all_ok = all(
    np.array_equal(y, it.weights.astype(np.int64) @ it.x.astype(np.int64))
    for it, (y, _r) in zip(items, sim.gemv_functional_many(items)))
print(f"\nBatched co-simulation ({len(items)} GEMVs, one engine "
      f"dispatch): all exact? {all_ok}")

# --- reshape optimization (paper §3.3) ----------------------------------
small_h = 1024
t0 = sim.gemv(small_h, 4096, dt, reshape=False)
t1 = sim.gemv(small_h, 4096, dt, reshape=True)
print(f"\nReshape optimization at H={small_h}: {t0.ns/t1.ns:.2f}x gain "
      f"(paper: up to 1.65x), utilization "
      f"{t0.utilization:.0%} -> {t1.utilization:.0%}")

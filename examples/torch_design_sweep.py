"""Design-space exploration: sweep PIM parameters with the simulator.

The paper positions LP5X-PIM Sim as "a robust framework for exploring PIM
architectures and software stacks"; this example sweeps two hardware knobs
(MAC interval, SRF capacity) and one software knob (reshape) and prints
the speedup surface — the kind of study the simulator exists for.

The PyTorch port's version of ``examples/design_sweep.py``.  Since the
facade is spec-vectorized, the WHOLE heterogeneous surface — 12 hardware
variants x (PIM + baseline) — is one ``run_many`` fleet call: every
stream resolves in a few batched launches of the lane-scan kernel, the
timing configuration of each lane being data of the launch.

    PYTHONPATH=src python examples/torch_design_sweep.py [--device cpu]
"""
import argparse

from repro_torch.core import trace
from repro_torch.core.pimsim import PimSimulator
from repro_torch.core.timing import PimSpec, SystemSpec
from repro_torch.pimkernel.executor import GemvRequest
from repro_torch.pimkernel.tileconfig import PimDType

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()

H = W = 4096
DT = PimDType.W8A8

mac_options = (2, 3, 4, 6)
srf_options = (256, 512, 1024)
variants = {(mac, srf): SystemSpec(pim=PimSpec(mac_interval_ck=mac,
                                               srf_bytes=srf))
            for mac in mac_options for srf in srf_options}

# One fleet call for the entire surface: every variant's PIM point and
# its host baseline ride the same resolve_fleet batch.
sim = PimSimulator(device=args.device)
launches = trace.totals().counter("lane_scan.launches")
reqs = [r for spec in variants.values()
        for r in (GemvRequest.baseline(H, W, DT, spec=spec),
                  GemvRequest.pim(H, W, DT, spec=spec))]
res = sim.run_many(reqs)
speedup = {key: base.ns / pim.ns
           for key, (base, pim) in zip(variants,
                                       zip(res[::2], res[1::2]))}

print(f"speedup surface for {H}x{W} {DT.name} "
      "(rows: MAC interval CK; cols: SRF bytes)\n")
print("          " + "".join(f"srf={s:<6}" for s in srf_options))
for mac in mac_options:
    row = "".join(f"{speedup[(mac, srf)]:<10.2f}" for srf in srf_options)
    print(f"mac={mac} CK  " + row)

print("\nlesson: the MAC interval dominates (compute-limited MB mode); "
      "doubling SRF helps only the small-tile dtypes via fewer chunk "
      "reloads.")

# The timing configuration is data of each launch, not a compile-time
# constant: the 12 spec variants above shared a handful of kernel
# launches (one per bank count and length bucket), not one each.
print(f"\nlane-scan kernel launches for the whole surface: "
      f"{trace.totals().counter('lane_scan.launches') - launches}")

print("\nsoftware knob — reshape split cap (paper caps gains ~1.65x):")
cap_specs = {cap: SystemSpec(pim=PimSpec(max_reshape_split=cap))
             for cap in (1, 2, 4)}
cap_reqs = [r for spec in cap_specs.values()
            for r in (GemvRequest.pim(1024, 4096, DT, spec=spec),
                      GemvRequest.pim(1024, 4096, DT, reshape=True,
                                      spec=spec))]
cap_res = sim.run_many(cap_reqs)
for cap, (flat, shaped) in zip(cap_specs, zip(cap_res[::2], cap_res[1::2])):
    print(f"  max_split={cap}: reshape gain {flat.ns/shaped.ns:.2f}x "
          f"at H=1024")

"""Summarize the dry-run's lowering records.

    python tools/dryrun_summary.py [DIR]

Reads ``<arch>__<shape>__<mesh>[__<variant>].json`` records (default:
``experiments/dryrun_torch``), and prints one row a cell: status, trace
seconds, per-device FLOPs, ``useful_ratio``, collective bytes a device,
the roofline terms at the H100 spec figures (the record's ``roofline``
row) and the bottleneck; error cells with their error.  Then the collective
bytes by model line summed over the ok cells, largest first.
"""
import json
import pathlib
import sys
from collections import defaultdict

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    d = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else \
        ROOT / "experiments" / "dryrun_torch"
    recs = [json.loads(p.read_text()) for p in sorted(d.glob("*__*.json"))]
    sites: dict = defaultdict(int)
    ok = 0
    print("| cell | trace s | FLOP/device | useful_ratio | collective B/device "
          "| t_compute s | t_memory s | t_collective s | bound |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in recs:
        cell = f"{r['arch']} {r['shape']} {r['mesh']}" + (
            "" if r.get("variant", "baseline") == "baseline"
            else f" {r['variant']}")
        if r["status"] != "ok":
            print(f"| {cell} | error: {r['error'][:120]} |")
            continue
        ok += 1
        row = r["roofline"]
        for site, b in r.get("collective_sites", {}).items():
            sites[site] += b
        print(f"| {cell} | {r['lower_s']} | {r['flops']:.4g} | "
              f"{row['useful_ratio']:.3f} | {r['collective']['total']:.4g} | "
              f"{row['t_compute_s']:.4g} | {row['t_memory_s']:.4g} | "
              f"{row['t_collective_s']:.4g} | {row['bottleneck']} |")
    print(f"\n{ok} of {len(recs)} cells ok")
    print("collective bytes by model line, summed over the ok cells:")
    for site, b in sorted(sites.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {site}: {b:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

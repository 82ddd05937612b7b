"""The comparisons that decide ``correct``.

Simulated numbers are exact: the program's command streams, lane totals,
each point's cycles, ns, energy and opcode counts, and each spec's
offload decisions must equal the plain reference's (limit 0).  Served
tokens are greedy: each must be the reference's best token up to the
rounding of float32 sums taken in another order, so the widest gap by
which a served token's reference logit lies below the reference's best is
held to a limit set from measured runs.
"""
from __future__ import annotations

import numpy as np

from bench.reference import sim


def _gap(a: float, b: float) -> float:
    """Relative gap of ``a`` to ``b`` (0 when equal)."""
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _energy_equal(got: dict, want: dict) -> bool:
    keys = ("total_pj", "pj_per_op", "runtime_ns")
    if any(got[k] != want[k] for k in keys):
        return False
    if len(got["channels"]) != len(want["channels"]):
        return False
    return all(g == w for g, w in zip(got["channels"], want["channels"]))


def spec_points(cfg: dict, spec_dict: dict, decisions: list, results: dict,
                streams: dict | None, dtype: str, fence: bool) -> dict:
    """Hold one spec's program answers to the reference.

    ``decisions``: the program's per-site decisions in site order;
    ``results``: ``(kind, site name) -> result`` with ``cycles``, ``ns``,
    ``flops``, ``weight_bytes``, ``utilization``, ``split``, ``energy``
    and ``counts``; ``streams``: ``(kind, site name) -> per-channel
    streams`` as planning produced them (``None``: not compared).
    Returns counts of what differs and the widest relative ns / energy
    gap."""
    ref_dec, ref_pts = sim.plan(cfg, sim.spec_from_dict(spec_dict), dtype,
                                fence)
    out = dict(streams=0, lanes=0, points=0, decisions=0, gap=0.0,
               compared=0)
    if len(ref_dec) != len(decisions):
        out["decisions"] += abs(len(ref_dec) - len(decisions)) or 1
    for got, want in zip(decisions, ref_dec):
        if ((got.site.name, got.site.h, got.site.w, got.site.count)
                != (want.site.name, want.site.h, want.site.w,
                    want.site.count)
                or got.pim_ns != want.pim_ns or got.host_ns != want.host_ns
                or bool(got.reshape) != want.reshape
                or got.offload_below_batch != want.offload_below_batch):
            out["decisions"] += 1
        for kind in ("pim", "baseline"):
            key = (kind, want.site.name)
            rp, pr = ref_pts[key], results.get(key)
            out["compared"] += 1
            if pr is None:
                out["points"] += 1
                continue
            if streams is not None:
                ps = streams.get(key)
                if ps is None or len(ps) != len(rp.streams):
                    out["streams"] += len(rp.streams)
                else:
                    out["streams"] += sum(
                        not (a.shape == b.shape and np.array_equal(a, b))
                        for a, b in zip(ps, rp.streams))
            got_ch = [c["runtime_ns"] for c in pr.energy["channels"]]
            want_ch = [c["runtime_ns"] for c in rp.energy["channels"]]
            out["lanes"] += sum(g != w for g, w in zip(got_ch, want_ch)) \
                + abs(len(got_ch) - len(want_ch))
            same = (pr.cycles == rp.cycles and pr.ns == rp.ns
                    and pr.flops == rp.flops
                    and pr.weight_bytes == rp.weight_bytes
                    and pr.utilization == rp.utilization
                    and pr.split == rp.split
                    and np.array_equal(np.asarray(pr.counts), rp.counts)
                    and _energy_equal(pr.energy, rp.energy))
            out["points"] += not same
            out["gap"] = max(out["gap"], _gap(pr.ns, rp.ns),
                             _gap(pr.energy["total_pj"],
                                  rp.energy["total_pj"]))
    return out

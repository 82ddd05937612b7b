"""PIM offload planner: which decode-phase GEMVs go to LP5X-PIM.

This is the HW/SW co-design point where the paper's simulator becomes a
*framework feature*: for every weight matrix touched by ``decode_step``
the planner queries the cycle-accurate simulator (PIM time, with mode
transitions / fences / flush-outs) against the host baseline (sequential
weight read at memory-system bandwidth) and emits an offload plan +
predicted speedup per decode batch size.

Batched decode on LP5X-PIM executes the batch as B back-to-back GEMVs
(weights are re-streamed from the banks each pass — in-bank data reuse
across a batch is not part of the LP5X-PIM execution model), while the
host baseline amortizes one weight read over the whole batch.  The
planner therefore finds the crossover batch size, which is the behavior
the PIM literature reports (PIM wins the small-batch regime).
"""
from __future__ import annotations

import dataclasses

from typing import Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pimsim import PimSimulator
from repro_torch.core.timing import SystemSpec
from repro_torch.pimkernel.executor import GemvRequest
from repro_torch.pimkernel.tileconfig import PimDType


@dataclasses.dataclass
class GemvSite:
    name: str            # e.g. "attn.wq"
    h: int               # output dim
    w: int               # input dim
    count: int           # instances per decode step (layers folded in)


def decode_gemv_sites(cfg: ArchConfig) -> list[GemvSite]:
    """Weight matrices a single-token decode multiplies against."""
    sites = []
    L = cfg.n_layers
    d = cfg.d_model
    if not cfg.attention_free:
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        sites += [GemvSite("attn.wq", hq * hd, d, L),
                  GemvSite("attn.wk", hkv * hd, d, L),
                  GemvSite("attn.wv", hkv * hd, d, L),
                  GemvSite("attn.wo", d, hq * hd, L)]
    if cfg.family == "moe":
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        n = 3 if cfg.mlp == "swiglu" else 2
        # per token only top-k experts run; router is a small GEMV too
        sites.append(GemvSite("moe.router", e, d, L))
        sites += [GemvSite(f"moe.w{i}", cfg.d_ff, d, L * k)
                  for i in range(n - 1)]
        sites.append(GemvSite("moe.wo", d, cfg.d_ff, L * k))
    elif cfg.d_ff > 0:
        n = 3 if cfg.mlp == "swiglu" else 2
        sites += [GemvSite(f"mlp.w{i}", cfg.d_ff, d, L)
                  for i in range(n - 1)]
        sites.append(GemvSite("mlp.wo", d, cfg.d_ff, L))
    if cfg.ssm is not None:
        di = cfg.d_inner
        proj = 2 * di + 2 * cfg.ssm.state_dim + cfg.n_ssm_heads
        sites += [GemvSite("ssm.in_proj", proj, d, L),
                  GemvSite("ssm.out_proj", d, di, L)]
    sites.append(GemvSite("lm_head", cfg.vocab_padded, d, 1))
    return sites


@dataclasses.dataclass
class OffloadDecision:
    site: GemvSite
    pim_ns: float          # one GEMV on LP5X-PIM
    host_ns: float         # one weight pass on the host memory system
    reshape: bool
    offload_below_batch: int   # offload when batch < this

    def speedup_at(self, batch: int) -> float:
        pim = self.pim_ns * batch
        host = max(self.host_ns, 1e-9)   # host amortizes weight reads
        return host / pim

    def offload_at(self, batch: int) -> bool:
        """Exact per-step predicate: PIM wins this site at this batch.

        The float comparison, not the truncated ``offload_below_batch``
        integer, so every consumer (planner telemetry, controller
        policies, property tests) agrees at the boundary.
        """
        return self.pim_ns * batch < self.host_ns


def offload_set(decisions: Sequence[OffloadDecision],
                batch: int) -> frozenset:
    """Site names PIM wins at this batch — the per-step oracle set."""
    return frozenset(d.site.name for d in decisions if d.offload_at(batch))


def step_cost(decisions: Sequence[OffloadDecision], batch: int,
              offload: frozenset) -> tuple[float, float]:
    """(host_ns, mixed_ns) of one decode step at ``batch`` with the
    sites in ``offload`` on PIM and everything else on the host.  This
    is the decision API the adaptive controller shares with
    ``decode_speedup`` — any offload set can be costed, not just the
    oracle one, which is how realized-vs-oracle telemetry is computed.
    """
    host_total = mixed_total = 0.0
    for d in decisions:
        host = d.host_ns * d.site.count
        host_total += host
        if d.site.name in offload:
            mixed_total += d.pim_ns * batch * d.site.count
        else:
            mixed_total += host
    return host_total, mixed_total


class OffloadPlanner:
    def __init__(self, cfg: ArchConfig, sim: PimSimulator | None = None,
                 dtype: PimDType = PimDType.W8A8, device=None):
        """``device`` builds the default simulator (see
        :class:`PimSimulator`); it is ignored when ``sim`` is given."""
        self.cfg = cfg
        self.sim = sim or PimSimulator(device=device)
        self.dtype = dtype
        self._plans: dict[tuple, list[OffloadDecision]] = {}

    def plan_grid(self, specs: Sequence[SystemSpec],
                  fence: bool = True) -> list[list[OffloadDecision]]:
        """Offload decisions for the whole (spec x site) grid at once.

        Every hardware variant's per-site PIM and host-baseline telemetry
        queries are batched into one fleet request — a single engine
        dispatch covers the entire design-space grid for this model —
        and each variant's plan is cached under its (spec, fence) key.
        Returns one decision list per spec, in input order.
        """
        specs = [sp or self.sim.spec for sp in specs]
        sites = decode_gemv_sites(self.cfg)
        reshapes = [site.h < 2048 for site in sites]   # §3.3 regime
        todo = [sp for sp in dict.fromkeys(specs)
                if (sp, fence) not in self._plans]
        reqs = []
        for sp in todo:
            for site, reshape in zip(sites, reshapes):
                reqs.append(GemvRequest.pim(site.h, site.w, self.dtype,
                                            fence=fence, reshape=reshape,
                                            spec=sp))
                reqs.append(GemvRequest.baseline(site.h, site.w,
                                                 self.dtype, spec=sp))
        res = iter(self.sim.run_many(reqs))
        for sp in todo:
            out = []
            for site, reshape in zip(sites, reshapes):
                pim, base = next(res), next(res)
                crossover = max(1, int(base.ns / pim.ns))
                out.append(OffloadDecision(site=site, pim_ns=pim.ns,
                                           host_ns=base.ns, reshape=reshape,
                                           offload_below_batch=crossover))
            self._plans[(sp, fence)] = out
        return [self._plans[(sp, fence)] for sp in specs]

    def plan(self, fence: bool = True,
             spec: SystemSpec | None = None) -> list[OffloadDecision]:
        """Offload decision per GEMV site (one spec of the grid path)."""
        return self.plan_grid([spec or self.sim.spec], fence=fence)[0]

    def frontier(self, fence: bool = True,
                 spec: SystemSpec | None = None) -> dict:
        """Per-site offload frontier of one spec: site name → the batch
        below which PIM wins it.  After :meth:`plan_grid` over a
        population this is a cache lookup — the per-population report
        the ``fleet/specfam_*`` rows print."""
        return {d.site.name: d.offload_below_batch
                for d in self.plan(fence=fence, spec=spec)}

    def invalidate(self) -> None:
        """Forget cached plans and batched simulator results so the next
        ``plan`` re-derives every offload decision through the engine.
        With a warm resolved-lane LRU that replan costs dict lookups,
        not fleet work — the property sticky-policy refreshes rely on.
        """
        self._plans.clear()
        self.sim.clear_cache()

    def decode_speedup(self, batch: int = 1, fence: bool = True,
                       spec: SystemSpec | None = None) -> dict:
        """End-to-end decode-step speedup from offloading (Amdahl over
        all GEMV sites; cached weights on host amortize over batch)."""
        decisions = self.plan(fence=fence, spec=spec)
        off = offload_set(decisions, batch)
        host_total, mixed_total = step_cost(decisions, batch, off)
        return dict(batch=batch,
                    host_ns=host_total,
                    mixed_ns=mixed_total,
                    speedup=host_total / max(mixed_total, 1e-9),
                    offloaded=[d.site.name for d in decisions
                               if d.site.name in off],
                    n_sites=len(decisions))

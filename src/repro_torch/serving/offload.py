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
from repro_torch.core import trace
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


def draft_gemv_sites(cfg: ArchConfig, shrink: int = 4) -> list[GemvSite]:
    """GEMV sites of the speculative *draft* model: the target's sites
    with both dimensions shrunk by ``shrink`` (floored at 16).

    Speculative decoding drafts with a model roughly ``shrink²`` times
    smaller; those small GEMVs are exactly the regime LPDDR-PIM wins
    hardest (LP-Spec's observation), so the draft pass routes through
    the PIM-friendly small-shape path — and its resolved lanes are the
    hot entries :meth:`OffloadPlanner.touch_draft` pins in the lane LRU.
    Deriving from the target's own sites gives every architecture
    family a consistent draft proxy without a second model config.
    """
    if shrink < 1:
        raise ValueError("shrink must be >= 1")
    return [GemvSite("draft." + s.name, max(16, s.h // shrink),
                     max(16, s.w // shrink), s.count)
            for s in decode_gemv_sites(cfg)]


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
        self._draft_plans: dict[tuple, list[OffloadDecision]] = {}
        self._draft_reqs: dict[tuple, list[GemvRequest]] = {}

    def plan_grid(self, specs: Sequence[SystemSpec],
                  fence: bool = True) -> list[list[OffloadDecision]]:
        """Offload decisions for the whole (spec x site) grid at once.

        Every hardware variant's per-site PIM and host-baseline telemetry
        queries are batched into one fleet request — a single engine
        dispatch covers the entire design-space grid for this model —
        and each variant's plan is cached under its (spec, fence) key.
        Returns one decision list per spec, in input order.
        """
        with trace.frame("offload.plan_grid"):
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
                    out.append(OffloadDecision(
                        site=site, pim_ns=pim.ns, host_ns=base.ns,
                        reshape=reshape, offload_below_batch=crossover))
                self._plans[(sp, fence)] = out
            return [self._plans[(sp, fence)] for sp in specs]

    def plan(self, fence: bool = True,
             spec: SystemSpec | None = None) -> list[OffloadDecision]:
        """Offload decision per GEMV site (one spec of the grid path)."""
        return self.plan_grid([spec or self.sim.spec], fence=fence)[0]

    def plan_draft(self, fence: bool = True,
                   spec: SystemSpec | None = None,
                   shrink: int = 4) -> list[OffloadDecision]:
        """Offload decisions for the speculative draft model's sites.

        Same batched grid path as :meth:`plan` but over
        :func:`draft_gemv_sites` — one fleet dispatch warms every draft
        lane through the engine's resolved-lane LRU, and the planned
        requests are kept so :meth:`touch_draft` can re-pin those lanes
        without re-resolving anything.
        """
        sp = spec or self.sim.spec
        key = (sp, fence, shrink)
        if key not in self._draft_plans:
            sites = draft_gemv_sites(self.cfg, shrink=shrink)
            reshapes = [site.h < 2048 for site in sites]
            reqs = []
            for site, reshape in zip(sites, reshapes):
                reqs.append(GemvRequest.pim(site.h, site.w, self.dtype,
                                            fence=fence, reshape=reshape,
                                            spec=sp))
                reqs.append(GemvRequest.baseline(site.h, site.w,
                                                 self.dtype, spec=sp))
            res = iter(self.sim.run_many(reqs))
            out = []
            for site, reshape in zip(sites, reshapes):
                pim, base = next(res), next(res)
                crossover = max(1, int(base.ns / pim.ns))
                out.append(OffloadDecision(site=site, pim_ns=pim.ns,
                                           host_ns=base.ns,
                                           reshape=reshape,
                                           offload_below_batch=crossover))
            self._draft_plans[key] = out
            self._draft_reqs[key] = reqs
        return self._draft_plans[key]

    def touch_draft(self, fence: bool = True,
                    spec: SystemSpec | None = None,
                    shrink: int = 4) -> int:
        """Pin the draft model's resolved lanes at the MRU end of the
        lane LRU (``engine.lane_cache_touch`` via the executor) so
        eviction pressure from big heterogeneous grids or replan storms
        cannot push the hot small-shape draft lanes out mid-serve.
        Plans the draft first if needed; returns lanes touched (0 when
        the cache ran cold — the next resolve re-warms them)."""
        sp = spec or self.sim.spec
        self.plan_draft(fence=fence, spec=sp, shrink=shrink)
        return self.sim.executor.touch_many(
            self._draft_reqs[(sp, fence, shrink)])

    def spec_decode_speedup(self, batch: int = 1, draft_len: int = 4,
                            acceptance: float = 0.7, fence: bool = True,
                            spec: SystemSpec | None = None,
                            shrink: int = 4) -> dict:
        """Expected per-generated-token economics of the draft/verify
        loop vs vanilla decode, pure arithmetic over the cached plans.

        One round drafts ``draft_len`` tokens on the draft model and
        verifies with one batched target pass; with leading-prefix
        acceptance it yields ``1 + Σ_{j≤L} p^j`` tokens in expectation.
        Both phases run under their own oracle offload sets at this
        batch, so the verdict is "speculation on the best hybrid vs
        vanilla on the best hybrid" — the honest comparison.
        """
        target = self.plan(fence=fence, spec=spec)
        draft = self.plan_draft(fence=fence, spec=spec, shrink=shrink)
        _, vanilla_ns = step_cost(target, batch,
                                  offload_set(target, batch))
        _, draft_ns = step_cost(draft, batch, offload_set(draft, batch))
        tokens = 1.0 + sum(acceptance ** j
                           for j in range(1, draft_len + 1))
        round_ns = draft_len * draft_ns + vanilla_ns
        per_token = round_ns / tokens
        return dict(batch=batch, draft_len=draft_len,
                    acceptance=acceptance,
                    tokens_per_round=tokens,
                    draft_step_ns=draft_ns, verify_step_ns=vanilla_ns,
                    ns_per_token=per_token,
                    vanilla_ns_per_token=vanilla_ns,
                    speedup=vanilla_ns / max(per_token, 1e-9))

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
        self._draft_plans.clear()
        self._draft_reqs.clear()
        self.sim.clear_cache()

    def decode_speedup(self, batch: int = 1, fence: bool = True,
                       spec: SystemSpec | None = None) -> dict:
        """End-to-end decode-step speedup from offloading (Amdahl over
        all GEMV sites; cached weights on host amortize over batch)."""
        with trace.span("offload.decode_speedup"):
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

    def occupancy_weighted_speedup(self, occupancy: dict[int, int],
                                   fence: bool = True,
                                   spec: SystemSpec | None = None) -> dict:
        """Decode-phase speedup under a batch-occupancy histogram.

        ``occupancy`` maps decode batch size -> number of steps observed
        at that size (``ServingEngine.batch_occupancy``).  Each step's
        offload decision is taken at its *own* batch size — crossover per
        step, not per run — and the host/mixed step times are weighted by
        the histogram.  After the first ``plan`` (one batched, lane-
        cache-accelerated fleet query) this is pure arithmetic over the
        cached decisions, so it is cheap enough to recompute every run.

        An empty histogram means "no decode steps observed": the neutral
        answer is speedup 1.0 over zero steps, not the 0/eps collapse a
        missing-trace caller would otherwise read as "PIM is infinitely
        bad".
        """
        if not occupancy:
            return dict(steps=0, host_ns=0.0, mixed_ns=0.0, speedup=1.0,
                        per_batch_speedup={})
        host_total = mixed_total = 0.0
        per_batch = {}
        steps = 0
        for b, count in sorted(occupancy.items()):
            tel = self.decode_speedup(batch=b, fence=fence, spec=spec)
            per_batch[b] = tel["speedup"]
            host_total += tel["host_ns"] * count
            mixed_total += tel["mixed_ns"] * count
            steps += count
        return dict(steps=steps, host_ns=host_total, mixed_ns=mixed_total,
                    speedup=host_total / max(mixed_total, 1e-9),
                    per_batch_speedup=per_batch)

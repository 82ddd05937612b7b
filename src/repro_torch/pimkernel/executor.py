"""PIM Executor (paper §2.2): runtime orchestration.

Glues Code Gen + PIM Control + GEMV Kernel over a Data-Mapper layout and
runs the result through the cycle engine (timing view) and optionally the
functional device model (behavioral view).

The executor speaks the *fleet request* API and is a stateless planner:
a :class:`GemvRequest` names one unit of simulator work (a PIM GEMV or
the non-PIM baseline) **including the ``SystemSpec`` it runs under**, and
:meth:`PimExecutor.run_many` plans every request eagerly, dedupes
repeats, pads all per-channel command streams into one flat fleet batch
and resolves them with a single ``engine.resolve_fleet`` call — points
with *different* specs ride the same batch, because the engine traces the
timing configuration as fleet data.  Per-spec machinery (``DataMapper``,
``GemvKernel`` geometry, ``derive_cycles``) is built once per spec in a
shared context cache, not per executor instance, so a heterogeneous
design-space grid costs no more setup than a single-spec sweep.

``run_gemv`` / ``run_baseline`` are the one-request conveniences on top;
``run_functional_many`` is the batched HW/SW co-simulation path (one
engine dispatch for all timing lanes, then the per-channel device
interpreters).

The executor resolves on one ``device`` fixed at construction: the card
by default, or ``device="cpu"`` for the plain resolver
(``engine.resolve_device``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import commands as C
from repro_torch.core import controller, device, engine, trace
from repro_torch.core.energy import EnergyParams, gemv_energy_summary
from repro_torch.core.timing import DEFAULT_SYSTEM, SystemSpec, TimingCycles
from . import codegen
from .datamapper import DataMapper, PimLayout
from .gemv import GemvKernel, GemvStreams
from .tileconfig import PimDType


@dataclasses.dataclass(frozen=True)
class SpecContext:
    """Everything derived from one ``SystemSpec``, built once and shared."""

    spec: SystemSpec
    cyc: TimingCycles
    mapper: DataMapper
    kernel: GemvKernel


@functools.lru_cache(maxsize=512)
def spec_context(spec: SystemSpec) -> SpecContext:
    """Per-spec planning context (cached process-wide: specs are frozen).

    Bounded so design-space searches that mint fresh specs per step
    don't grow memory monotonically; 512 comfortably covers any grid
    resolved in one fleet call.
    """
    return SpecContext(spec=spec, cyc=spec.derive_cycles(),
                       mapper=DataMapper(spec), kernel=GemvKernel())


@dataclasses.dataclass(frozen=True)
class GemvRequest:
    """One unit of fleet work: a PIM GEMV point or its host baseline.

    ``spec`` names the memory system the request runs under; ``None``
    means "the caller's default", resolved by :meth:`resolved` before any
    planning or caching happens, so every planned/keyed request is
    spec-explicit.  ``key`` is the canonical dedupe/cache key — baseline
    timing depends only on (spec, H, W, dtype), so the PIM-only knobs are
    excluded there.
    """

    H: int
    W: int
    dtype: PimDType
    fence: bool = False
    reshape: bool = False
    flush: str = "bus"
    kind: str = "pim"            # "pim" | "baseline"
    spec: SystemSpec | None = None

    @staticmethod
    def pim(H: int, W: int, dtype: PimDType | str, *, fence: bool = False,
            reshape: bool = False, flush: str = "bus",
            spec: SystemSpec | None = None) -> "GemvRequest":
        dtype = PimDType.parse(dtype) if isinstance(dtype, str) else dtype
        return GemvRequest(H, W, dtype, fence, reshape, flush, "pim", spec)

    @staticmethod
    def baseline(H: int, W: int, dtype: PimDType | str,
                 spec: SystemSpec | None = None) -> "GemvRequest":
        dtype = PimDType.parse(dtype) if isinstance(dtype, str) else dtype
        return GemvRequest(H, W, dtype, kind="baseline", spec=spec)

    def resolved(self, default: SystemSpec) -> "GemvRequest":
        """This request with its spec filled in (no-op when explicit)."""
        if self.spec is not None:
            return self
        return dataclasses.replace(self, spec=default)

    @property
    def key(self) -> tuple:
        if self.kind == "baseline":
            # Baseline streams/timing/energy depend only on the memory
            # system (timings, channel/rank counts), never the PIM
            # knobs — PIM-variant grids share one baseline lane.
            mem = None if self.spec is None else (
                self.spec.timings, self.spec.num_channels,
                self.spec.num_ranks)
            return ("base", mem, self.H, self.W, self.dtype)
        return ("pim", self.spec, self.H, self.W, self.dtype, self.fence,
                self.reshape, self.flush)


@dataclasses.dataclass
class PlannedGemv:
    """A request with its layouts/programs/streams built, ready to time.

    ``stream_keys`` carries one structural identity per channel stream
    (see ``GemvStreams.stream_keys``): the engine dedupes and LRU-caches
    lanes by planner-provided key instead of hashing stream bytes.
    """

    req: GemvRequest
    ctx: SpecContext
    streams: list[np.ndarray]
    stream_keys: list | None = None
    gs: GemvStreams | None = None      # pim requests only
    weight_bytes: int = 0              # baseline requests only


@dataclasses.dataclass
class PimResult:
    cycles: int                 # max over channels
    ns: float
    flops: int
    weight_bytes: int
    utilization: float
    split: int
    energy: dict
    counts: np.ndarray          # aggregated opcode histogram
    meta: dict

    @property
    def gflops(self) -> float:
        return self.flops / max(self.ns, 1e-9)


@dataclasses.dataclass
class FunctionalGemv:
    """One HW/SW co-simulation unit: weights + activations + knobs.

    Unlike :class:`GemvRequest` this carries the actual operand arrays,
    so it is never deduped/cached — but its *timing* lane joins the same
    fleet batch as everything else in the call.
    """

    weights: np.ndarray
    x: np.ndarray
    dtype: PimDType
    fence: bool = False
    reshape: bool = False
    spec: SystemSpec | None = None


class PimExecutor:
    """Stateless planner for GEMV offload on LP5X-PIM.

    ``default_spec`` only fills in requests that do not name a spec of
    their own; all per-spec state lives in the shared ``spec_context``
    cache, keyed by the request's spec.
    """

    def __init__(self, default_spec: SystemSpec | None = None,
                 energy_params: EnergyParams | None = None,
                 device=None):
        self.default_spec = default_spec or DEFAULT_SYSTEM
        self.energy_params = energy_params or EnergyParams()
        self.device = engine.resolve_device(device)

    # -- paper pipeline -------------------------------------------------
    def plan(self, H: int, W: int, dtype: PimDType,
             reshape: bool = False, spec: SystemSpec | None = None
             ) -> tuple[PimLayout, codegen.PimProgram]:
        ctx = spec_context(spec or self.default_spec)
        layout = ctx.mapper.layout(H, W, dtype, reshape=reshape)
        program = codegen.synthesize(layout.tc, ctx.spec.pim)
        return layout, program

    def build_streams(self, layout: PimLayout, program: codegen.PimProgram,
                      x: np.ndarray | None = None,
                      fence: bool = False,
                      flush: str = "bus") -> GemvStreams:
        kernel = spec_context(layout.spec).kernel
        return kernel.build(layout, program, x=x, fence=fence, flush=flush)

    def time_streams(self, gs: GemvStreams) -> PimResult:
        ctx = spec_context(gs.layout.spec)
        _, totals = engine.run_streams(ctx.cyc, gs.streams,
                                       device=self.device)
        return self._pim_result(ctx, gs, totals)

    def run_gemv(self, H: int, W: int, dtype: PimDType,
                 fence: bool = False, reshape: bool = False,
                 flush: str = "bus",
                 spec: SystemSpec | None = None) -> PimResult:
        """Timing-only GEMV simulation (the Fig. 4 path)."""
        layout, program = self.plan(H, W, dtype, reshape=reshape, spec=spec)
        gs = self.build_streams(layout, program, fence=fence, flush=flush)
        return self.time_streams(gs)

    def run_gemv_functional(self, weights: np.ndarray, x: np.ndarray,
                            dtype: PimDType, fence: bool = False,
                            reshape: bool = False,
                            spec: SystemSpec | None = None
                            ) -> tuple[np.ndarray, PimResult]:
        """Full HW/SW co-simulation: returns (y, timing result)."""
        return self.run_functional_many([
            FunctionalGemv(weights, x, dtype, fence=fence, reshape=reshape,
                           spec=spec)])[0]

    # -- fleet API -------------------------------------------------------
    def plan_many(self, reqs: Iterable[GemvRequest]) -> list[PlannedGemv]:
        """Build every layout/program/stream eagerly (no timing yet)."""
        with trace.span("executor.plan_many"):
            return [self._plan_one(r.resolved(self.default_spec))
                    for r in reqs]

    def _plan_one(self, r: GemvRequest) -> PlannedGemv:
        ctx = spec_context(r.spec)
        if r.kind == "baseline":
            total_bytes = r.H * r.W * r.dtype.w_bits // 8
            per_ch = -(-total_bytes // ctx.spec.num_channels)
            with trace.span("executor.streams"):
                stream = controller.sequential_read_stream(per_ch, ctx.spec)
            # the stream is fully determined by (memory system, H, W,
            # dtype) == r.key, identical across channels -> one lane
            return PlannedGemv(
                req=r, ctx=ctx,
                streams=[stream] * ctx.spec.num_channels,
                stream_keys=[r.key] * ctx.spec.num_channels,
                weight_bytes=total_bytes)
        with trace.span("executor.layout"):
            layout, program = self.plan(r.H, r.W, r.dtype,
                                        reshape=r.reshape, spec=r.spec)
        with trace.span("executor.streams"):
            gs = self.build_streams(layout, program, fence=r.fence,
                                    flush=r.flush)
        return PlannedGemv(req=r, ctx=ctx, streams=gs.streams,
                           stream_keys=gs.stream_keys, gs=gs)

    def touch_many(self, reqs: Sequence[GemvRequest]) -> int:
        """Pin the requests' resolved lanes at the MRU end of the lane
        LRU (``engine.lane_cache_touch``); returns lanes found warm.

        Planning is cheap numpy stream synthesis (and the layouts /
        programs sit in the shared ``spec_context`` LRU), so this never
        dispatches the engine: absent lanes stay absent until something
        actually resolves them.  The speculative-decode serve loop uses
        it every tick to shield its hot small-shape draft lanes from
        eviction by large heterogeneous grid resolves.
        """
        reqs = [r.resolved(self.default_spec) for r in reqs]
        uniq: dict[tuple, GemvRequest] = {}
        for r in reqs:
            uniq.setdefault(r.key, r)
        pairs = []
        for p in self.plan_many(uniq.values()):
            pairs.extend((p.ctx.cyc, k) for k in p.stream_keys
                         if k is not None)
        return engine.lane_cache_touch(pairs)

    def run_many(self, reqs: Sequence[GemvRequest]) -> list[PimResult]:
        """Resolve many requests through ONE batched engine call.

        Requests may name arbitrary (heterogeneous) ``SystemSpec``s — the
        whole (spec x shape) grid still resolves as one fleet.  Duplicate
        requests (by ``key``, which includes the spec) are planned and
        timed once; the returned list matches the input order.  Results
        are bit-identical to the per-call ``run_gemv`` / ``run_baseline``
        paths under each request's spec.
        """
        reqs = [r.resolved(self.default_spec) for r in reqs]
        uniq: dict[tuple, GemvRequest] = {}
        for r in reqs:
            uniq.setdefault(r.key, r)
        planned = self.plan_many(uniq.values())
        fleet = engine.resolve_fleet(
            [(p.ctx.cyc, p.streams) for p in planned],
            keys=[p.stream_keys for p in planned],
            need_issue=False, device=self.device)
        with trace.span("executor.assemble"):
            by_key = {p.req.key: self._finish(p, fr.totals)
                      for p, fr in zip(planned, fleet)}
        return [by_key[r.key] for r in reqs]

    def run_functional_many(self, items: Sequence[FunctionalGemv]
                            ) -> list[tuple[np.ndarray, PimResult]]:
        """Batched HW/SW co-simulation.

        Plans every item (layout, codegen, DRAM preload, streams with
        WR_SRF payloads), resolves ALL timing lanes — across specs — in
        one ``resolve_fleet`` dispatch, then runs the functional device
        interpreter per item.  Returns [(y, timing result)] in order.
        """
        plans = []
        for it in items:
            spec = it.spec or self.default_spec
            ctx = spec_context(spec)
            H, W = it.weights.shape
            layout, program = self.plan(H, W, it.dtype, reshape=it.reshape,
                                        spec=spec)
            dram = ctx.mapper.pack(layout, it.weights)
            gs = self.build_streams(layout, program, x=it.x, fence=it.fence)
            plans.append((ctx, layout, program, dram, gs))
        fleet = engine.resolve_fleet(
            [(ctx.cyc, gs.streams) for ctx, _l, _p, _d, gs in plans],
            keys=[gs.stream_keys for _c, _l, _p, _d, gs in plans],
            need_issue=False, device=self.device)
        out = []
        for (ctx, layout, program, dram, gs), fr in zip(plans, fleet):
            y = device.execute_gemv(layout, program, dram, gs.streams,
                                    gs.payloads)
            out.append((y, self._pim_result(ctx, gs, fr.totals)))
        return out

    def _finish(self, p: PlannedGemv, totals: np.ndarray) -> PimResult:
        if p.req.kind == "baseline":
            return self._baseline_result(p.ctx, p.req, p.streams, totals,
                                         p.weight_bytes)
        return self._pim_result(p.ctx, p.gs, totals)

    # -- result assembly -------------------------------------------------
    def _pim_result(self, ctx: SpecContext, gs: GemvStreams,
                    totals: np.ndarray) -> PimResult:
        cycles = int(totals.max()) if totals.size else 0
        counts = sum((C.op_counts(s) for s in gs.streams),
                     np.zeros(C.NUM_OPCODES, dtype=np.int64))
        active = max(1, int(round(16 * gs.layout.utilization)))
        energy = gemv_energy_summary(gs.streams, totals, ctx.spec,
                                     gs.meta["flops"], self.energy_params,
                                     active_banks=active)
        return PimResult(
            cycles=cycles,
            ns=cycles * ctx.cyc.tck_ns,
            flops=gs.meta["flops"],
            weight_bytes=gs.meta["weight_bytes"],
            utilization=gs.meta["utilization"],
            split=gs.meta["split"],
            energy=energy,
            counts=counts,
            meta=gs.meta,
        )

    def _baseline_result(self, ctx: SpecContext, req: GemvRequest,
                         streams: list[np.ndarray],
                         totals: np.ndarray, total_bytes: int) -> PimResult:
        cycles = int(totals.max()) if totals.size else 0
        counts = sum((C.op_counts(s) for s in streams),
                     np.zeros(C.NUM_OPCODES, dtype=np.int64))
        energy = gemv_energy_summary(streams, totals, ctx.spec,
                                     2 * req.H * req.W, self.energy_params)
        return PimResult(cycles=cycles, ns=cycles * ctx.cyc.tck_ns,
                         flops=2 * req.H * req.W,
                         weight_bytes=total_bytes,
                         utilization=1.0, split=1, energy=energy,
                         counts=counts, meta=dict(kind="baseline"))

    # -- non-PIM baseline (Fig. 4 normalization) --------------------------
    def run_baseline(self, H: int, W: int, dtype: PimDType,
                     spec: SystemSpec | None = None) -> PimResult:
        """Sequential weight read on a non-PIM system (all channels)."""
        return self.run_many([GemvRequest.baseline(H, W, dtype,
                                                   spec=spec)])[0]

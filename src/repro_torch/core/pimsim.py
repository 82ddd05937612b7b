"""LP5X-PIM Sim — top-level simulator API (the paper's Fig. 1 box).

``PimSimulator`` is the user-facing facade over the HW model (timing
engine, memory controller, device model) and the SW model (PIM Kernel:
Data Mapper + Executor).  Benchmarks, the serving offload planner and the
examples all talk to this class.

Every query path — ``gemv``, ``baseline``, ``speedup``, ``sweep`` — routes
through :meth:`run_many`, which dedupes requests against the result cache
and resolves all cache misses in one batched engine call (the fleet API).
Requests carry their own ``SystemSpec`` (the simulator's spec is only the
default), so a *design-space grid* — heterogeneous specs x models x
shapes — is also a single ``resolve_fleet`` dispatch: that is the
spec-vectorized facade the Fig-4-style sweeps and LP-Spec-style
architecture/dataflow co-optimization loops run on.

The simulator runs its lanes on ``device``: the card by default; a
caller without one passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.timing import DEFAULT_SYSTEM, SystemSpec
from repro_torch.pimkernel.executor import (FunctionalGemv, GemvRequest,
                                      PimExecutor, PimResult)
from repro_torch.pimkernel.tileconfig import ALL_DTYPES, PimDType


class PimSimulator:
    def __init__(self, spec: SystemSpec | None = None, device=None):
        self.spec = spec or DEFAULT_SYSTEM
        self.executor = PimExecutor(self.spec, device=device)
        self._cache: dict = {}

    def clear_cache(self) -> None:
        """Drop memoized request results; the next query re-resolves
        through the engine (offload replans route here via
        ``OffloadPlanner.invalidate``)."""
        self._cache.clear()

    # ------------------------------------------------------------------
    def run_many(self, reqs: Sequence[GemvRequest]) -> list[PimResult]:
        """Resolve many requests; cache-hit dedupe + one engine batch.

        Requests without an explicit spec run under the simulator's
        default; mixed-spec request lists share the single batch.
        """
        reqs = [r.resolved(self.spec) for r in reqs]
        missing, seen = [], set()
        for r in reqs:
            if r.key not in self._cache and r.key not in seen:
                missing.append(r)
                seen.add(r.key)
        if missing:
            for r, res in zip(missing, self.executor.run_many(missing)):
                self._cache[r.key] = res
        return [self._cache[r.key] for r in reqs]

    def gemv(self, H: int, W: int, dtype: PimDType | str,
             fence: bool = False, reshape: bool = False,
             flush: str = "bus",
             spec: SystemSpec | None = None) -> PimResult:
        return self.run_many([GemvRequest.pim(H, W, dtype, fence=fence,
                                              reshape=reshape, flush=flush,
                                              spec=spec)])[0]

    def baseline(self, H: int, W: int, dtype: PimDType | str,
                 spec: SystemSpec | None = None) -> PimResult:
        return self.run_many([GemvRequest.baseline(H, W, dtype,
                                                   spec=spec)])[0]

    def speedup(self, H: int, W: int, dtype: PimDType | str,
                fence: bool = False, reshape: bool = False,
                spec: SystemSpec | None = None) -> float:
        """PIM speedup vs sequential-weight-read baseline (Fig. 4)."""
        base, pim = self.run_many([
            GemvRequest.baseline(H, W, dtype, spec=spec),
            GemvRequest.pim(H, W, dtype, fence=fence, reshape=reshape,
                            spec=spec),
        ])
        return base.ns / pim.ns

    def gemv_functional(self, weights: np.ndarray, x: np.ndarray,
                        dtype: PimDType | str, **kw):
        dtype = PimDType.parse(dtype) if isinstance(dtype, str) else dtype
        return self.executor.run_gemv_functional(weights, x, dtype, **kw)

    def gemv_functional_many(self, items: Sequence[FunctionalGemv]):
        """Batched HW/SW co-simulation: one timing dispatch for all items."""
        return self.executor.run_functional_many(items)

    # ------------------------------------------------------------------
    def sweep(self, dims: list[int], dtypes=None, axis: str = "activation",
              base_dim: int = 4096, fence: bool = False,
              reshape: bool = False,
              specs: Sequence[SystemSpec] | None = None) -> dict:
        """Paper Fig. 4 sweeps: vary one dimension, fix the other at 4096.

        axis='activation' varies W (input dim, top panels); axis='output'
        varies H (bottom panels).  The whole grid — every (spec, dtype,
        dim) point plus its baseline — is resolved as one fleet batch.

        With ``specs=None`` (the default spec) the result is
        ``{dtype: [speedups]}``; with a list of design variants it is
        ``{spec_index: {dtype: [speedups]}}`` — the Fig-4 surface per
        variant, still from the single batched engine query.
        """
        dtypes = [PimDType.parse(d) if isinstance(d, str) else d
                  for d in (dtypes or ALL_DTYPES)]
        single = specs is None
        specs = [self.spec] if single else list(specs)
        reqs: list[GemvRequest] = []
        for sp in specs:
            for dt in dtypes:
                for d in dims:
                    H, W = (base_dim, d) if axis == "activation" \
                        else (d, base_dim)
                    reqs.append(GemvRequest.baseline(H, W, dt, spec=sp))
                    reqs.append(GemvRequest.pim(H, W, dt, fence=fence,
                                                reshape=reshape, spec=sp))
        res = self.run_many(reqs)
        it = iter(res)
        surfaces: dict = {}
        for si, _sp in enumerate(specs):
            out: dict = {}
            for dt in dtypes:
                row = []
                for _d in dims:
                    base = next(it)
                    pim = next(it)
                    row.append(base.ns / pim.ns)
                out[dt.name] = row
            surfaces[si] = out
        return surfaces[0] if single else surfaces



_DEFAULT_SIMULATORS: dict = {}


def default_simulator(device=None) -> PimSimulator:
    """The process's shared simulator on ``device`` (the card unless
    ``device="cpu"``), one per resolved device."""
    dev = engine.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sim = _DEFAULT_SIMULATORS.get(dev)
    if sim is None:
        sim = _DEFAULT_SIMULATORS[dev] = PimSimulator(device=dev)
    return sim

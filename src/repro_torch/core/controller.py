"""Memory-controller model: request scheduling -> command streams.

The paper's memory controller "analyzes host memory requests and schedules
them to maximize processing throughput while strictly adhering to LPDDR5X
standard timing constraints".  For in-order per-channel streams this is a
*policy* question (which command next), and the timing engine enforces the
constraints.  This module provides the two policies the evaluation needs:

* :func:`sequential_read_stream` — the non-PIM baseline of Fig. 4: a
  sequential weight read of ``nbytes`` per channel using FR-FCFS-style
  open-page scheduling with bank interleaving (the throughput-maximal
  policy for a streaming access pattern: ACT latencies of bank *k+1* are
  hidden under the data bursts of bank *k*).
* :func:`interleaved_rw_stream` — mixed read/write streaming (used by
  host<->PIM data movement phases and tests).

Both generators are vectorized numpy (no Python-per-command loops) so that
multi-MB workloads build in milliseconds.
"""
from __future__ import annotations

import numpy as np

from . import commands as C
from .timing import SystemSpec


def _bank_interleaved_bursts(nbytes: int, spec: SystemSpec,
                             op: int) -> np.ndarray:
    """Open-page, bank-interleaved streaming over `nbytes` of one channel."""
    t = spec.timings
    nb = t.num_banks
    bursts_total = int(np.ceil(nbytes / t.burst_bytes))
    cols_per_row = t.page_bytes // t.burst_bytes

    # Layout: rows striped across banks; within (bank, row) sequential cols.
    # Command order: for each row-group, for each bank: ACT; then sweep
    # columns round-robin across banks (maximizes bus utilization); then
    # PRE per bank.  We emit ACT_b / cols / PRE_b blocks per bank but
    # interleave columns across banks inside a row-group.
    n_rowgroups = int(np.ceil(bursts_total / (cols_per_row * nb)))
    out = []
    remaining = bursts_total
    for rg in range(n_rowgroups):
        group = min(remaining, cols_per_row * nb)
        banks_used = int(np.ceil(group / cols_per_row))
        # ACTs first (engine hides them under prior data where possible).
        acts = np.zeros((banks_used, 4), dtype=np.int32)
        acts[:, 0] = C.ACT
        acts[:, 1] = np.arange(banks_used)
        acts[:, 2] = rg
        out.append(acts)
        # Column sweep, round-robin across the used banks.
        idx = np.arange(group, dtype=np.int32)
        cas = np.zeros((group, 4), dtype=np.int32)
        cas[:, 0] = op
        cas[:, 1] = idx % banks_used
        cas[:, 2] = rg
        cas[:, 3] = idx // banks_used
        out.append(cas)
        pres = np.zeros((banks_used, 4), dtype=np.int32)
        pres[:, 0] = C.PRE
        pres[:, 1] = np.arange(banks_used)
        out.append(pres)
        remaining -= group
    if not out:
        return np.zeros((0, 4), dtype=np.int32)
    return np.concatenate(out, axis=0)


def sequential_read_stream(nbytes_per_channel: int,
                           spec: SystemSpec) -> np.ndarray:
    """Non-PIM baseline: stream-read `nbytes_per_channel` (Fig. 4 baseline)."""
    return _bank_interleaved_bursts(nbytes_per_channel, spec, C.RD)


def sequential_write_stream(nbytes_per_channel: int,
                            spec: SystemSpec) -> np.ndarray:
    return _bank_interleaved_bursts(nbytes_per_channel, spec, C.WR)


def interleaved_rw_stream(nbytes_rd: int, nbytes_wr: int,
                          spec: SystemSpec) -> np.ndarray:
    rd = _bank_interleaved_bursts(nbytes_rd, spec, C.RD)
    wr = _bank_interleaved_bursts(nbytes_wr, spec, C.WR)
    return np.concatenate([rd, wr], axis=0)


def with_refresh(stream: np.ndarray, spec: SystemSpec) -> np.ndarray:
    """Insert PREA+REFAB roughly every tREFI worth of commands.

    Command-count spacing approximates time spacing for streaming patterns
    (every command occupies >= 1 CK); exact refresh placement is a
    controller policy, and this conservative variant never violates tREFI
    for streams whose average command occupancy is >= 1 CK.
    """
    if not spec.refresh_enabled or stream.shape[0] == 0:
        return stream
    cyc = spec.derive_cycles()
    period = max(cyc.cREFI // 2, 16)  # conservative: every tREFI/2 cycles
    chunks = []
    for start in range(0, stream.shape[0], period):
        chunks.append(stream[start:start + period])
        chunks.append(np.array([[C.PREA, 0, 0, 0], [C.REFAB, 0, 0, 0]],
                               dtype=np.int32))
    return np.concatenate(chunks, axis=0)

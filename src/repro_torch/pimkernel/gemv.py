"""GEMV Kernel (paper §2.2, PIM Executor sub-component 3).

"Executes General Matrix-Vector Multiplication on a per-tile basis using
the specialized PIM ISA and manages pipeline flush-out operations."

Given a :class:`PimLayout` (Data Mapper) and a :class:`PimProgram` (Code
Gen) this module synthesizes the per-channel command streams:

    MODE_MB · IRF setup
    per round:   per chunk:  [FENCE] · chunk config · SRF broadcast fill
                             ACT_MB/MAC sweep (row-buffer aware) · PRE_MB
                 [FENCE] · ACC flush-out (RD_ACC per active bank)
    MODE_SB

The same structure drives both the timing engine (issue cycles) and the
functional device interpreter (`core/device.py`), which is what ties the
HW and SW models together "organically" as the paper puts it: one command
stream, two views.

Synthesis is *block-vectorized*: each round is assembled from numpy
blocks (the ACT/MAC row sweep, SRF fill, and flush-out sections are pure
column/row arithmetic, never per-command ``emit()``), all channel-
independent round structure is computed once per round, and channels
whose active (round, bank-set) sequences coincide — the common case in a
round-robin block placement — share one stream ndarray, one payload dict
and one *structural stream key* (``GemvStreams.stream_keys``), which is
what lets the engine dedupe/cache lanes without hashing the bytes.
``build_reference`` retains the original per-command ``StreamBuilder``
path as the parity oracle for the vectorized synthesizer.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import commands as C
from repro_torch.core.commands import StreamBuilder, repeat_block, single
from . import codegen
from .control import FencePolicy, PimControl
from .datamapper import PimLayout

BURST = 32

_FENCE = single(C.FENCE)
_PRE_MB = single(C.PRE_MB)
_MODE_MB = single(C.MODE_MB)
_MODE_SB = single(C.MODE_SB)
_EMPTY = np.zeros((0, 4), dtype=np.int32)


@dataclasses.dataclass
class GemvStreams:
    """Per-channel command streams + WR_SRF payload side-band.

    ``stream_keys`` (vectorized builds only) carries one hashable
    structural identity per channel: equal keys guarantee byte-identical
    streams, so ``engine.resolve_lanes`` can dedupe and LRU-cache lanes
    without re-hashing them.
    """

    streams: list[np.ndarray]
    payloads: list[dict[int, np.ndarray]]
    layout: PimLayout
    meta: dict
    stream_keys: list | None = None


@dataclasses.dataclass
class _ChunkPlan:
    """Channel-independent structure of one (round, chunk) tile step."""

    header: np.ndarray          # WR_IRF chunk marker + re-config block
    srf: np.ndarray             # WR_SRF broadcast fill block
    srf_meta: list              # (w_tile, j) per WR_SRF command, in order
    mac: np.ndarray             # (n_bursts, 4) MAC block, rows/cols filled
    trans: np.ndarray           # burst indices that open a new row
    trans_rows: np.ndarray      # the row opened at each transition


class GemvKernel:
    """Stateless stream synthesizer: the spec rides on the layout."""

    def build(self, layout: PimLayout, program: codegen.PimProgram,
              x: np.ndarray | None = None,
              fence: bool = False, flush: str = "bus") -> GemvStreams:
        """Synthesize command streams (and payloads when ``x`` given).

        ``flush``: "bus" reads accumulators to the host over the data
        bus (RD_ACC); "dram" moves them into DRAM internally (MOV_ACC —
        the paper's "accumulation register-to-DRAM data movements"), the
        host reading y later with normal SB reads.

        Byte-identical to :meth:`build_reference` (asserted by the
        parity suite); ~an order of magnitude faster because rounds are
        numpy blocks shared across channels with equal round-sets.
        """
        spec = layout.spec
        policy = FencePolicy(per_tile=fence)
        xpad = None
        if x is not None:
            xpad = np.zeros(layout.padded_w, dtype=np.asarray(x).dtype)
            xpad[: layout.W] = x

        # Per-channel round-set: the only channel-dependent inputs of the
        # synthesis are which rounds a channel participates in and with
        # which (rank, bank) blocks.
        per_ch = []
        for ch in range(spec.num_channels):
            rnds = []
            for rnd in range(layout.rounds):
                banks = layout.active_banks(rnd, ch)
                if banks:
                    rnds.append((rnd, tuple(banks)))
            per_ch.append(tuple(rnds))

        base_key = ("gemv", layout.spec, layout.H, layout.W,
                    layout.tc.dtype, layout.split, bool(fence), flush)
        round_cache: dict[int, list[_ChunkPlan]] = {}
        raw_cache: dict[int, np.ndarray] = {}
        built: dict[tuple, tuple[np.ndarray, dict]] = {}
        streams, payloads, stream_keys = [], [], []
        for cls in per_ch:
            ent = built.get(cls)
            if ent is None:
                ent = self._build_class(layout, program, cls, policy,
                                        flush, xpad, round_cache,
                                        raw_cache)
                built[cls] = ent
            streams.append(ent[0])
            payloads.append(ent[1])
            stream_keys.append(base_key + (cls,))

        meta = dict(
            flops=layout.flops,
            weight_bytes=layout.weight_bytes,
            utilization=layout.utilization,
            split=layout.split,
            rounds=layout.rounds,
            tiles=layout.n_htiles * layout.n_wtiles,
        )
        return GemvStreams(streams, payloads, layout, meta,
                           stream_keys=stream_keys)

    # -- vectorized synthesis ------------------------------------------
    def _round_plan(self, layout: PimLayout, program: codegen.PimProgram,
                    rnd: int, page: int) -> list[_ChunkPlan]:
        """Channel-independent blocks of one round (cached per build)."""
        tc = layout.tc
        plans: list[_ChunkPlan] = []
        prev_row = -1                   # open-row chains across chunks
        for chunk in range(layout.group_w):
            groups = layout.active_groups(rnd, chunk)
            if not groups:
                continue
            header = np.concatenate([
                single(C.WR_IRF, a=rnd % (1 << 15), b=1, c=chunk),
                repeat_block(C.WR_IRF, program.chunk_cfg_cmds - 1)])
            n_srf = len(groups) * tc.srf_wr_cmds
            srf = np.zeros((n_srf, 4), dtype=np.int32)
            srf[:, 0] = C.WR_SRF
            srf[:, 1] = np.repeat(np.asarray(groups, np.int32),
                                  tc.srf_wr_cmds)
            srf[:, 2] = np.tile(np.arange(tc.srf_wr_cmds, dtype=np.int32),
                                len(groups))
            srf_meta = [(layout.w_tile_at(g, chunk), j)
                        for g in groups for j in range(tc.srf_wr_cmds)]

            n_bursts = layout.max_bursts(rnd, chunk)
            offs = (layout.chunk_offset(rnd, chunk)
                    + BURST * np.arange(n_bursts, dtype=np.int64))
            rows = (offs // page).astype(np.int32)
            mac = np.zeros((n_bursts, 4), dtype=np.int32)
            mac[:, 0] = C.MAC
            mac[:, 2] = rows
            mac[:, 3] = (offs % page) // BURST
            first_new = rows[0] != prev_row if n_bursts else False
            interior = np.flatnonzero(rows[1:] != rows[:-1]) + 1
            trans = (np.concatenate([[0], interior]) if first_new
                     else interior).astype(np.int64)
            plans.append(_ChunkPlan(header=header, srf=srf,
                                    srf_meta=srf_meta, mac=mac,
                                    trans=trans, trans_rows=rows[trans]))
            if n_bursts:
                prev_row = int(rows[-1])
        return plans

    def _build_class(self, layout: PimLayout, program: codegen.PimProgram,
                     cls: tuple, policy: FencePolicy, flush: str,
                     xpad, round_cache: dict, raw_cache: dict
                     ) -> tuple[np.ndarray, dict]:
        """Assemble one channel-class stream from per-round blocks."""
        if not cls:
            return _EMPTY, {}
        tc = layout.tc
        page = layout.spec.timings.page_bytes
        blocks: list[np.ndarray] = [_MODE_MB,
                                    repeat_block(C.WR_IRF,
                                                 program.setup_cmds)]
        pay_meta: list = []
        any_tile = False
        for rnd, banks in cls:
            plans = round_cache.get(rnd)
            if plans is None:
                plans = round_cache[rnd] = self._round_plan(
                    layout, program, rnd, page)
            quads = sorted({bank % 4 for _rank, bank in banks})
            opened = False
            for p in plans:
                if policy.per_tile and any_tile:
                    blocks.append(_FENCE)
                blocks.append(p.header)
                blocks.append(p.srf)
                pay_meta.extend(p.srf_meta)
                # ACT/MAC row sweep: MAC runs split at row transitions,
                # each opening PRE_MB (if a row is open) + ACT_MB x quads.
                k = p.trans.shape[0]
                if k:
                    acts = np.zeros((k, len(quads), 4), dtype=np.int32)
                    acts[:, :, 0] = C.ACT_MB
                    acts[:, :, 1] = np.asarray(quads, np.int32)
                    acts[:, :, 2] = p.trans_rows[:, None]
                    bounds = np.append(p.trans, p.mac.shape[0])
                    if p.trans[0] > 0:
                        blocks.append(p.mac[: p.trans[0]])
                    for j in range(k):
                        if opened:
                            blocks.append(_PRE_MB)
                        opened = True
                        blocks.append(acts[j])
                        blocks.append(p.mac[bounds[j]: bounds[j + 1]])
                elif p.mac.shape[0]:
                    blocks.append(p.mac)
                if policy.per_tile and policy.double:
                    blocks.append(_FENCE)
                any_tile = True
            # Flush-out: close rows, move accumulators out of the blocks.
            if policy.per_tile and policy.before_flush and not policy.double:
                blocks.append(_FENCE)
            if opened:
                blocks.append(_PRE_MB)
            if flush == "dram":
                blocks.append(repeat_block(C.MOV_ACC, tc.acc_rd_cmds))
            else:
                n_rd = len(banks) * tc.acc_rd_cmds
                rd = np.zeros((n_rd, 4), dtype=np.int32)
                rd[:, 0] = C.RD_ACC
                rd[:, 1] = np.repeat([bank for _r, bank in banks],
                                     tc.acc_rd_cmds)
                rd[:, 2] = np.repeat([rank for rank, _b in banks],
                                     tc.acc_rd_cmds)
                rd[:, 3] = np.tile(np.arange(tc.acc_rd_cmds,
                                             dtype=np.int32), len(banks))
                blocks.append(rd)
        blocks.append(_MODE_SB)
        stream = np.concatenate(blocks, axis=0)

        pay: dict[int, np.ndarray] = {}
        if xpad is not None:
            positions = np.flatnonzero(stream[:, 0] == C.WR_SRF)
            for pos, (w_tile, j) in zip(positions, pay_meta):
                raw = raw_cache.get(w_tile)
                if raw is None:
                    seg = xpad[w_tile * tc.t_w:(w_tile + 1) * tc.t_w]
                    raw = codegen.encode_acts(seg, tc.dtype)
                    raw = np.pad(raw,
                                 (0, tc.srf_wr_cmds * BURST - raw.size))
                    raw_cache[w_tile] = raw
                pay[int(pos)] = raw[j * BURST:(j + 1) * BURST]
        return stream, pay

    # -- reference (per-command) synthesis -----------------------------
    def build_reference(self, layout: PimLayout,
                        program: codegen.PimProgram,
                        x: np.ndarray | None = None,
                        fence: bool = False,
                        flush: str = "bus") -> GemvStreams:
        """The original per-command ``StreamBuilder`` path.

        Retained as the oracle for the vectorized synthesizer: the
        parity tests (and ``benchmarks/fleet_speed.py`` plan rows)
        assert :meth:`build` produces byte-identical streams/payloads.
        """
        spec = layout.spec
        page = spec.timings.page_bytes
        xpad = None
        if x is not None:
            xpad = np.zeros(layout.padded_w, dtype=np.asarray(x).dtype)
            xpad[: layout.W] = x

        streams, payloads = [], []
        for ch in range(spec.num_channels):
            b = StreamBuilder()
            pay: dict[int, np.ndarray] = {}
            ctl = PimControl(b, FencePolicy(per_tile=fence))
            ch_rounds = [r for r in range(layout.rounds)
                         if layout.active_banks(r, ch)]
            if ch_rounds:
                ctl.enter_mb()
                b.emit_repeat(C.WR_IRF, program.setup_cmds, a=0, b=0)
                for rnd in ch_rounds:
                    self._round(b, pay, ctl, layout, program, rnd, ch,
                                xpad, page, flush)
                ctl.enter_sb()
            streams.append(b.build())
            payloads.append(pay)

        meta = dict(
            flops=layout.flops,
            weight_bytes=layout.weight_bytes,
            utilization=layout.utilization,
            split=layout.split,
            rounds=layout.rounds,
            tiles=layout.n_htiles * layout.n_wtiles,
        )
        return GemvStreams(streams, payloads, layout, meta)

    # ------------------------------------------------------------------
    def _round(self, b: StreamBuilder, pay: dict, ctl: PimControl,
               layout: PimLayout, program: codegen.PimProgram, rnd: int,
               ch: int, xpad, page: int, flush: str = "bus") -> None:
        tc = layout.tc
        banks = layout.active_banks(rnd, ch)
        quads = sorted({bank % 4 for _, bank in banks})
        open_row = -1

        for chunk in range(layout.group_w):
            groups = layout.active_groups(rnd, chunk)
            if not groups:
                continue
            ctl.tile_begin()
            # chunk re-config (marks chunk start for the interpreter:
            # b-field 1 = chunk-start flag, c-field = chunk index).
            b.emit(C.WR_IRF, a=rnd % (1 << 15), b=1, c=chunk)
            if program.chunk_cfg_cmds > 1:
                b.emit_repeat(C.WR_IRF, program.chunk_cfg_cmds - 1,
                              a=0, b=0)
            # SRF broadcast fill, one pass per split group.
            for g in groups:
                w_tile = layout.w_tile_at(g, chunk)
                if xpad is not None:
                    seg = xpad[w_tile * tc.t_w:(w_tile + 1) * tc.t_w]
                    raw = codegen.encode_acts(seg, tc.dtype)
                    raw = np.pad(raw, (0, tc.srf_wr_cmds * BURST - raw.size))
                for j in range(tc.srf_wr_cmds):
                    if xpad is not None:
                        pay[len(b)] = raw[j * BURST:(j + 1) * BURST]
                    b.emit(C.WR_SRF, a=g, b=j)
            # MAC sweep over the tile bytes, row-buffer aware.
            n_bursts = layout.max_bursts(rnd, chunk)
            off = layout.chunk_offset(rnd, chunk)
            emitted = 0
            while emitted < n_bursts:
                row = off // page
                if row != open_row:
                    if open_row >= 0:
                        b.emit(C.PRE_MB)
                    for q in quads:
                        b.emit(C.ACT_MB, a=q, b=row)
                    open_row = row
                col0 = (off % page) // BURST
                n = min(n_bursts - emitted, page // BURST - col0)
                b.emit_repeat(C.MAC, n, a=0, b=row, c_start=col0)
                emitted += n
                off += n * BURST
            ctl.tile_end()
        # Flush-out: close rows, move accumulators out of the blocks.
        ctl.flush_boundary()
        if open_row >= 0:
            b.emit(C.PRE_MB)
        if flush == "dram":
            # internal ACC->DRAM move (broadcast, no data-bus usage);
            # the host reads y later with standard SB-mode reads.
            b.emit_repeat(C.MOV_ACC, tc.acc_rd_cmds)
        else:
            for rank, bank in banks:
                b.emit_repeat(C.RD_ACC, tc.acc_rd_cmds, a=bank, b=rank)

"""Data Mapper (paper §2.2, offline stage).

Receives the weight matrix + data type, structures it into PIM tiles
(`tileconfig`), generates the memory layout (`addrmap` — vertical +
horizontal mapping, optional reshape column-split) and *preloads* it into
the per-bank DRAM images.  Everything the runtime needs (tile->block
assignment, per-chunk byte ranges, SRF chunk ranges) is derived from the
resulting :class:`PimLayout`, so placement decisions live in exactly one
place — as in the paper's architecture (Fig. 2, both components refer to
the PIM tiling configuration).

The packing is *byte-exact*: ``pack`` produces per-(channel, rank, bank)
uint8 DRAM images and ``unpack`` inverts them (hypothesis tests assert the
round trip).  The device-level interpreter (`core/device.py`) executes the
generated command streams against these images, which is what makes the
behavioral-fidelity tests end-to-end.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.timing import SystemSpec
from . import addrmap
from .tileconfig import PimDType, TileConfig

BURST = 32  # bytes per BL16 access


def _encode_w(mat: np.ndarray, dtype: PimDType) -> np.ndarray:
    """Encode an integer (or fp8-code) matrix into its byte layout rows."""
    if dtype.is_fp:
        return mat.astype(np.uint8)  # fp8 codes stored verbatim
    if dtype.w_bits == 8:
        return mat.astype(np.int8).view(np.uint8)
    if dtype.w_bits == 4:
        m = mat.astype(np.int8)
        assert m.shape[1] % 2 == 0
        lo = (m[:, 0::2] & 0xF).astype(np.uint8)
        hi = (m[:, 1::2] & 0xF).astype(np.uint8)
        return lo | (hi << 4)
    raise ValueError(dtype)


def _decode_w(raw: np.ndarray, dtype: PimDType, n_elems: int) -> np.ndarray:
    """Decode bytes back into signed weight values (int paths) or codes."""
    if dtype.is_fp:
        return raw[:n_elems].astype(np.int32)  # fp8 codes
    if dtype.w_bits == 8:
        return raw.view(np.int8)[:n_elems].astype(np.int32)
    if dtype.w_bits == 4:
        lo = (raw & 0xF).astype(np.int8)
        hi = ((raw >> 4) & 0xF).astype(np.int8)
        lo = np.where(lo >= 8, lo - 16, lo)
        hi = np.where(hi >= 8, hi - 16, hi)
        out = np.empty(raw.size * 2, dtype=np.int32)
        out[0::2] = lo
        out[1::2] = hi
        return out[:n_elems]
    raise ValueError(dtype)


@dataclasses.dataclass
class PimLayout:
    """Placement + schedule geometry for one GEMV weight matrix."""

    spec: SystemSpec
    tc: TileConfig
    H: int
    W: int
    split: int                   # reshape column-split factor (1 = off)
    n_htiles: int
    n_wtiles: int
    group_w: int                 # w-tiles per split group
    n_logical: int               # h-tiles * split
    rounds: int                  # ceil(n_logical / num_blocks)

    # ---- geometry helpers -------------------------------------------------
    @property
    def nblocks(self) -> int:
        return addrmap.num_blocks(self.spec)

    @property
    def padded_h(self) -> int:
        return self.n_htiles * self.tc.t_h

    @property
    def padded_w(self) -> int:
        return self.n_wtiles * self.tc.t_w

    def logical_of(self, h_tile: int, g: int) -> int:
        return h_tile * self.split + g

    def place(self, logical: int) -> tuple[int, tuple[int, int, int]]:
        """logical block index -> (round, (channel, rank, bank))."""
        blk = logical % self.nblocks
        rnd = logical // self.nblocks
        return rnd, addrmap.block_of(blk, self.spec)

    def w_tile_at(self, g: int, chunk: int) -> int | None:
        w = g * self.group_w + chunk
        if chunk >= self.group_w or w >= min((g + 1) * self.group_w,
                                             self.n_wtiles):
            return None
        return w

    def chunk_offset(self, rnd: int, chunk: int) -> int:
        """Byte offset of (round, chunk)'s tile inside its bank."""
        return (rnd * self.group_w + chunk) * self.tc.tile_w_bytes

    def active_logicals(self, rnd: int) -> range:
        return range(rnd * self.nblocks,
                     min((rnd + 1) * self.nblocks, self.n_logical))

    def active_banks(self, rnd: int, channel: int) -> list[tuple[int, int]]:
        """(rank, bank) of this channel's active blocks in round `rnd`."""
        out = []
        for logical in self.active_logicals(rnd):
            ch, rank, bank = addrmap.block_of(logical % self.nblocks,
                                              self.spec)
            if ch == channel:
                out.append((rank, bank))
        return out

    def tile_eff(self, h_tile: int, w_tile: int) -> tuple[int, int]:
        th = self.tc.t_h if h_tile < self.n_htiles - 1 else \
            self.H - h_tile * self.tc.t_h
        tw = self.tc.t_w if w_tile < self.n_wtiles - 1 else \
            self.W - w_tile * self.tc.t_w
        return th, tw

    def max_bursts(self, rnd: int, chunk: int) -> int:
        """Lock-step MAC count at (round, chunk): worst active bank.

        Storage is row-padded to the full ``t_w`` stride (all banks must
        share one IRF program in broadcast mode), so the W direction always
        sweeps the full row; only a uniformly-short edge h-tile lets the
        sweep stop early (trailing tile rows are a sequential suffix).
        """
        if not self.active_groups(rnd, chunk):
            return 0
        h_tiles = {l // self.split for l in self.active_logicals(rnd)}
        th = self.tc.t_h if any(h < self.n_htiles - 1 for h in h_tiles) \
            else (self.H - (self.n_htiles - 1) * self.tc.t_h)
        row_bytes = self.tc.t_w * self.tc.dtype.w_bits // 8
        return int(math.ceil(th * row_bytes / BURST))

    def active_groups(self, rnd: int, chunk: int) -> list[int]:
        groups = sorted({l % self.split for l in self.active_logicals(rnd)})
        return [g for g in groups if self.w_tile_at(g, chunk) is not None]

    @property
    def utilization(self) -> float:
        return self.n_logical / (self.rounds * self.nblocks)

    @property
    def flops(self) -> int:
        return 2 * self.H * self.W

    @property
    def weight_bytes(self) -> int:
        return self.H * self.W * self.tc.dtype.w_bits // 8


class DataMapper:
    """Offline placement: matrix -> PimLayout (+ optional DRAM preload)."""

    def __init__(self, spec: SystemSpec):
        self.spec = spec

    def layout(self, H: int, W: int, dtype: PimDType,
               reshape: bool = False) -> PimLayout:
        tc = TileConfig.make(dtype, self.spec.pim,
                             self.spec.timings.burst_bytes)
        n_h, n_w = tc.tiles_for(H, W)
        nblk = addrmap.num_blocks(self.spec)
        split = 1
        if reshape and n_h < nblk and n_w > 1:
            # Paper §2.3: column-based partitioning activates idle blocks.
            split = min(self.spec.pim.max_reshape_split, n_w,
                        max(1, nblk // n_h))
        group_w = -(-n_w // split)
        n_logical = n_h * split
        rounds = -(-n_logical // nblk)
        return PimLayout(spec=self.spec, tc=tc, H=H, W=W, split=split,
                         n_htiles=n_h, n_wtiles=n_w, group_w=group_w,
                         n_logical=n_logical, rounds=rounds)

    # ------------------------------------------------------------------
    def pack(self, layout: PimLayout,
             weights: np.ndarray) -> dict[tuple[int, int, int], np.ndarray]:
        """Preload weights into per-(ch, rank, bank) uint8 DRAM images.

        ``weights`` is an integer matrix (int dtypes: int8 values; W4 in
        [-8, 7]) or uint8 fp8 codes of shape (H, W).  Edge tiles are stored
        zero-padded to the full tile footprint so every (round, chunk) has
        a uniform byte offset across banks (lock-step broadcast invariant).
        """
        tc, spec = layout.tc, layout.spec
        H, W = weights.shape
        assert (H, W) == (layout.H, layout.W)
        padded = np.zeros((layout.padded_h, layout.padded_w),
                          dtype=weights.dtype)
        padded[:H, :W] = weights
        bank_bytes = layout.rounds * layout.group_w * tc.tile_w_bytes
        dram = {}
        for ch in range(spec.num_channels):
            for rank in range(spec.num_ranks):
                for bank in range(spec.timings.num_banks):
                    dram[(ch, rank, bank)] = np.zeros(bank_bytes,
                                                      dtype=np.uint8)
        for h in range(layout.n_htiles):
            for g in range(layout.split):
                logical = layout.logical_of(h, g)
                rnd, (ch, rank, bank) = layout.place(logical)
                img = dram[(ch, rank, bank)]
                for chunk in range(layout.group_w):
                    w = layout.w_tile_at(g, chunk)
                    if w is None:
                        continue
                    tile = padded[h * tc.t_h:(h + 1) * tc.t_h,
                                  w * tc.t_w:(w + 1) * tc.t_w]
                    raw = _encode_w(tile, tc.dtype).reshape(-1)
                    off = layout.chunk_offset(rnd, chunk)
                    img[off:off + raw.size] = raw
        return dram

    def unpack(self, layout: PimLayout,
               dram: dict[tuple[int, int, int], np.ndarray]) -> np.ndarray:
        """Inverse of :meth:`pack` (returns the padded matrix)."""
        tc = layout.tc
        row_bytes = tc.t_w * tc.dtype.w_bits // 8
        out = np.zeros((layout.padded_h, layout.padded_w), dtype=np.int32)
        for h in range(layout.n_htiles):
            for g in range(layout.split):
                logical = layout.logical_of(h, g)
                rnd, (ch, rank, bank) = layout.place(logical)
                img = dram[(ch, rank, bank)]
                for chunk in range(layout.group_w):
                    w = layout.w_tile_at(g, chunk)
                    if w is None:
                        continue
                    off = layout.chunk_offset(rnd, chunk)
                    raw = img[off:off + tc.tile_w_bytes]
                    rows = raw.reshape(tc.t_h, row_bytes)
                    vals = np.stack([
                        _decode_w(rows[r], tc.dtype, tc.t_w)
                        for r in range(tc.t_h)])
                    out[h * tc.t_h:(h + 1) * tc.t_h,
                        w * tc.t_w:(w + 1) * tc.t_w] = vals
        return out

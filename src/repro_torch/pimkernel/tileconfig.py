"""PIM tile configuration (paper Fig. 3).

The tile size is "constrained by the capacities of the PIM block's
input/output register files and the data precision" (§2.3):

* ``T_w`` — number of input-vector elements a tile consumes = SRF capacity
  in bits / activation bits.
* ``T_h`` — number of output rows a tile produces = number of 32-bit
  accumulator registers.

With the default ``PimSpec`` (SRF = 512 B, 64 ACC regs) this yields the
paper's large-tile group (W8A8, W4A4, FP-W8A8: T_w >= 512) and small-tile
group (W8A16, W4A16, FP-W8A16: T_w = 256), reproducing the SRF-write
frequency argument for their speedup gap.
"""
from __future__ import annotations

import dataclasses
import enum
import math

from repro_torch.core.timing import PimSpec


class PimDType(enum.Enum):
    """Weight/activation precision formats evaluated in the paper."""

    W8A8 = ("int", 8, 8)
    W4A4 = ("int", 4, 4)
    W8A16 = ("int", 8, 16)
    W4A8 = ("int", 4, 8)
    W4A16 = ("int", 4, 16)
    FP_W8A8 = ("fp", 8, 8)
    FP_W8A16 = ("fp", 8, 16)

    def __init__(self, kind: str, w_bits: int, a_bits: int):
        self.kind = kind
        self.w_bits = w_bits
        self.a_bits = a_bits

    @property
    def is_fp(self) -> bool:
        return self.kind == "fp"

    @property
    def w_bytes(self) -> float:
        return self.w_bits / 8

    @property
    def a_bytes(self) -> float:
        return self.a_bits / 8

    @classmethod
    def parse(cls, name: str) -> "PimDType":
        return cls[name.upper().replace("-", "_")]


ALL_DTYPES = list(PimDType)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Concrete PIM tile geometry for one dtype under one PimSpec."""

    dtype: PimDType
    t_h: int                 # rows per tile (ACC registers)
    t_w: int                 # input elements per tile (SRF capacity)
    tile_w_bytes: int        # weight bytes per tile = t_h * t_w * w_bits/8
    srf_chunk_bytes: int     # activation bytes per SRF fill = t_w * a_bits/8
    srf_wr_cmds: int         # WR_SRF commands per SRF fill (32 B each)
    macs_per_tile: int       # 32 B weight bursts per tile
    acc_rd_cmds: int         # RD_ACC bursts to flush one bank's ACC file

    @classmethod
    def make(cls, dtype: PimDType, pim: PimSpec,
             burst_bytes: int = 32) -> "TileConfig":
        t_w = pim.srf_bytes * 8 // dtype.a_bits
        t_h = pim.acc_regs
        tile_w_bytes = t_h * t_w * dtype.w_bits // 8
        srf_chunk = t_w * dtype.a_bits // 8
        return cls(
            dtype=dtype,
            t_h=t_h,
            t_w=t_w,
            tile_w_bytes=tile_w_bytes,
            srf_chunk_bytes=srf_chunk,
            srf_wr_cmds=int(math.ceil(srf_chunk / burst_bytes)),
            macs_per_tile=int(math.ceil(tile_w_bytes / burst_bytes)),
            acc_rd_cmds=int(math.ceil(pim.acc_file_bytes / burst_bytes)),
        )

    def tiles_for(self, h: int, w: int) -> tuple[int, int]:
        """Number of (h, w) tiles covering an H x W matrix."""
        return (int(math.ceil(h / self.t_h)), int(math.ceil(w / self.t_w)))

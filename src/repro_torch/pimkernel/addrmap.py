"""2D address mapping (paper §2.3, Fig. 3).

* **Vertical mapping** — tile rows (the H direction) are interleaved across
  the DRAM hierarchy in Channel -> Rank -> BankGroup -> Bank order so that
  consecutive h-tiles land on distinct PIM blocks: this maximizes bank-level
  parallelism for PIM execution and external bandwidth for the preload.
* **Horizontal mapping** — tiles adjacent in the W direction are placed at
  consecutive byte offsets of the *same* bank, so the per-tile MAC sweeps
  hit the open row (row-buffer locality).

``block_of`` / ``bank_layout_offset`` define the bijection
``(h_tile, w_tile) <-> (channel, rank, bank, byte_offset)`` used by both the
Data Mapper (placement) and the GEMV kernel (command synthesis); a
hypothesis test asserts bijectivity over random geometries.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.timing import SystemSpec


@dataclasses.dataclass(frozen=True)
class BlockAddr:
    channel: int
    rank: int
    bank: int           # 0..15 : bank id = bg * banks_per_group + idx
    byte_offset: int    # linear offset inside the bank's PIM region

    def row_col(self, page_bytes: int, burst_bytes: int) -> tuple[int, int]:
        return (self.byte_offset // page_bytes,
                (self.byte_offset % page_bytes) // burst_bytes)


def num_blocks(spec: SystemSpec) -> int:
    return spec.num_channels * spec.num_ranks * spec.timings.num_banks


def block_of(block_id: int, spec: SystemSpec) -> tuple[int, int, int]:
    """block_id -> (channel, rank, bank): channel-first interleaving.

    Bank order enumerates bank groups first (bg = fastest-varying within a
    channel/rank after channels), i.e. block ids walk Ch -> Rank -> BG ->
    Bank-in-group, matching the paper's vertical-mapping order.
    """
    t = spec.timings
    ch = block_id % spec.num_channels
    rest = block_id // spec.num_channels
    rank = rest % spec.num_ranks
    rest //= spec.num_ranks
    bg = rest % t.num_bankgroups
    idx = rest // t.num_bankgroups
    bank = bg * t.banks_per_group + idx
    return ch, rank, bank


def block_id_of(ch: int, rank: int, bank: int, spec: SystemSpec) -> int:
    t = spec.timings
    bg, idx = divmod(bank, t.banks_per_group)
    rest = idx * t.num_bankgroups + bg
    rest = rest * spec.num_ranks + rank
    return rest * spec.num_channels + ch

def tile_address(h_tile: int, w_tile: int, n_wtiles: int, tile_bytes: int,
                 spec: SystemSpec, split: int = 1,
                 base_offset: int = 0) -> BlockAddr:
    """Map tile (h_tile, w_tile) of a matrix to its physical location.

    ``split`` is the reshape column-split factor: with split > 1 the
    w-tiles of one h-tile are divided into ``split`` groups assigned to
    *different* blocks (paper §2.3 "Reshape Optimization"); within a group
    the horizontal mapping (same bank, consecutive offsets) is preserved.
    """
    nblk = num_blocks(spec)
    group_w = -(-n_wtiles // split)          # w-tiles per split group
    g, w_in = divmod(w_tile, group_w)
    logical = h_tile * split + g             # logical block index
    blk = logical % nblk
    step = logical // nblk                   # serialized rounds
    ch, rank, bank = block_of(blk, spec)
    # Horizontal mapping: consecutive w-tiles (within the group) adjacent;
    # successive rounds stacked after them.
    offset = base_offset + (step * group_w + w_in) * tile_bytes
    return BlockAddr(ch, rank, bank, offset)

"""PIM Control (paper §2.2, PIM Executor sub-component 2).

Manages system-wide control logic: transitions between Single-Bank (SB)
mode — standard DRAM operation — and Multi-Bank (MB) mode — broadcast PIM
execution across banks — plus the memory-fence policy of §3.2 ("fences
between successive tiles strictly guarantee inter-tile execution order").
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import commands as C
from repro_torch.core.commands import StreamBuilder


@dataclasses.dataclass
class FencePolicy:
    """Where fences are inserted.  `per_tile` reproduces the paper §3.2.

    A per-tile ordering point needs two fences in real host software: one
    before the operand update (the next tile's SRF write must not overtake
    the previous tile's MACs) and one after the tile's compute phase (the
    next tile's commands must not be reordered before it).  ``double``
    models that; with it disabled only the inter-tile fence is emitted.
    """

    per_tile: bool = False      # FENCE around successive tile (chunk) steps
    double: bool = True         # operand-ordering fence + inter-tile fence
    before_flush: bool = True   # FENCE before ACC readout (result ordering)


class PimControl:
    """Tracks SB/MB mode and emits transition / fence commands."""

    def __init__(self, builder: StreamBuilder,
                 policy: FencePolicy | None = None):
        self.b = builder
        self.policy = policy or FencePolicy()
        self.mode = 0  # SB
        self._any_tile_done = False

    def enter_mb(self) -> None:
        if self.mode != 1:
            self.b.emit(C.MODE_MB)
            self.mode = 1

    def enter_sb(self) -> None:
        if self.mode != 0:
            self.b.emit(C.MODE_SB)
            self.mode = 0

    def tile_begin(self) -> None:
        """Operand-ordering fence before each tile step after the first."""
        if self.policy.per_tile and self._any_tile_done:
            self.b.emit(C.FENCE)

    def tile_end(self) -> None:
        """Inter-tile ordering fence after each tile's compute phase."""
        if self.policy.per_tile and self.policy.double:
            self.b.emit(C.FENCE)
        self._any_tile_done = True

    def flush_boundary(self) -> None:
        if (self.policy.per_tile and self.policy.before_flush
                and not self.policy.double):
            self.b.emit(C.FENCE)

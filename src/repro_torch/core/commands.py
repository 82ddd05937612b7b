"""DRAM + PIM command encoding.

A command stream is an int32 array of shape ``(N, 4)``::

    [opcode, bank_or_quad, row_or_slot, col_or_idx]

Opcode semantics (bank = DRAM bank id 0..15, quad = one bank per bank
group, i.e. banks ``{bg*4 + q}`` for ``bg in 0..3``):

====  =========  =============================================================
code  name       meaning
====  =========  =============================================================
0     NOP        padding; consumes nothing
1     ACT        activate ``row`` in ``bank``                       (SB mode)
2     PRE        precharge ``bank``                                 (SB mode)
3     PREA       precharge all banks
4     RD         BL16 read  ``bank``/open row/``col``               (SB mode)
5     WR         BL16 write ``bank``/open row/``col``               (SB mode)
6     REFAB      all-bank refresh (banks must be precharged)
7     MODE_MB    SB -> MB transition (drains channel first)
8     MODE_SB    MB -> SB transition (drains channel first)
9     ACT_MB     broadcast activate ``row`` in quad ``q`` (4 banks) (MB mode)
10    PRE_MB     broadcast precharge all 16 banks                   (MB mode)
11    WR_SRF     broadcast 32 B write into SRF slot ``row``         (MB mode)
12    WR_IRF     broadcast IRF/config write                         (MB mode)
13    MAC        broadcast MAC: every bank reads ``col`` of its open row,
                 multiplies against SRF operands, accumulates into ACC
14    RD_ACC     read 32 B of ACC registers from ``bank`` over the bus
15    MOV_ACC    internal ACC -> DRAM move (no data-bus usage)
16    FENCE      memory fence: drain channel, stall ``cFENCE`` cycles
====  =========  =============================================================

``FENCE`` is not a DRAM command — it models the host-side ordering stall the
paper evaluates in §3.2 (150 ns between successive tiles).
"""
from __future__ import annotations

import numpy as np

NOP = 0
ACT = 1
PRE = 2
PREA = 3
RD = 4
WR = 5
REFAB = 6
MODE_MB = 7
MODE_SB = 8
ACT_MB = 9
PRE_MB = 10
WR_SRF = 11
WR_IRF = 12
MAC = 13
RD_ACC = 14
MOV_ACC = 15
FENCE = 16

NUM_OPCODES = 17

OP_NAMES = [
    "NOP", "ACT", "PRE", "PREA", "RD", "WR", "REFAB", "MODE_MB", "MODE_SB",
    "ACT_MB", "PRE_MB", "WR_SRF", "WR_IRF", "MAC", "RD_ACC", "MOV_ACC",
    "FENCE",
]


def single(op: int, a: int = 0, b: int = 0, c: int = 0) -> np.ndarray:
    """One command as a (1, 4) int32 block."""
    return np.array([[op, a, b, c]], dtype=np.int32)


def repeat_block(op: int, count: int, a: int = 0, b: int = 0,
                 c_start: int = 0, c_step: int = 1) -> np.ndarray:
    """``count`` commands with a striding last field as one (count, 4)
    block — the vectorized building brick shared by :class:`StreamBuilder`
    and the block-synthesizing GEMV kernel."""
    block = np.empty((max(count, 0), 4), dtype=np.int32)
    if count > 0:
        block[:, 0] = op
        block[:, 1] = a
        block[:, 2] = b
        block[:, 3] = c_start + c_step * np.arange(count, dtype=np.int32)
    return block


class StreamBuilder:
    """Append-only builder for command streams (numpy int32 (N,4))."""

    __slots__ = ("_chunks", "_n")

    def __init__(self) -> None:
        self._chunks: list[np.ndarray] = []
        self._n = 0

    def emit(self, op: int, a: int = 0, b: int = 0, c: int = 0) -> None:
        self._chunks.append(single(op, a, b, c))
        self._n += 1

    def emit_block(self, arr: np.ndarray) -> None:
        assert arr.ndim == 2 and arr.shape[1] == 4
        self._chunks.append(np.asarray(arr, dtype=np.int32))
        self._n += arr.shape[0]

    def emit_repeat(self, op: int, count: int, a: int = 0, b: int = 0,
                    c_start: int = 0, c_step: int = 1) -> None:
        """Emit ``count`` commands with a striding last field (vectorized)."""
        if count <= 0:
            return
        self._chunks.append(repeat_block(op, count, a, b, c_start, c_step))
        self._n += count

    def __len__(self) -> int:
        return self._n

    def build(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0, 4), dtype=np.int32)
        out = np.concatenate(self._chunks, axis=0)
        self._chunks = [out]
        return out


def pad_streams(streams: list[np.ndarray]) -> np.ndarray:
    """Stack variable-length streams into (C, Nmax, 4), NOP padded."""
    n = max((s.shape[0] for s in streams), default=0)
    out = np.zeros((len(streams), n, 4), dtype=np.int32)
    for i, s in enumerate(streams):
        out[i, : s.shape[0]] = s
    return out


def op_counts(stream: np.ndarray) -> np.ndarray:
    """Histogram of opcodes, length NUM_OPCODES."""
    return np.bincount(stream[:, 0], minlength=NUM_OPCODES)

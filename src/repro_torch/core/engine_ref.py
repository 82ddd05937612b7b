"""Pure-Python reference timing engine (the oracle).

Resolves the issue cycle of every command in a stream under the LPDDR5X +
PIM timing constraints.  Semantics here are authoritative; the lane
resolver behind ``engine.py`` (the CUDA kernel and its plain torch
version) must produce bit-identical issue cycles.

The engine is *command-level cycle-accurate*: every JEDEC constraint is an
explicit ``max(last_event + t_constraint, ...)`` term, which is equivalent
to an event-driven simulation for in-order per-channel streams (the memory
controller's scheduling policy lives in the stream generators — see
``core/controller.py`` and ``pimkernel/gemv.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import commands as C
from .timing import TimingCycles

NEG = -(1 << 30)  # "never happened"


@dataclasses.dataclass
class ChannelState:
    """Mutable timing state for one channel (single rank)."""

    nb: int
    open_row: np.ndarray         # (nb,) int; -1 closed
    ready_act: np.ndarray        # (nb,) earliest ACT (precharge done)
    act_cycle: np.ndarray        # (nb,) last ACT issue
    rd_cycle: np.ndarray         # (nb,) last RD issue (tRTP)
    wr_end: np.ndarray           # (nb,) last WR data end (tWR)
    faw: np.ndarray              # (4,) ring of last ACT cycles
    faw_i: int = 0
    last_act: int = NEG          # any-bank ACT (tRRD)
    last_actmb: int = NEG
    last_cas: int = NEG          # any CAS (tCCD)
    bus_free: int = 0            # data bus free cycle
    bus_dir: int = 0             # 0 = rd, 1 = wr
    cmd_free: int = 0            # next CA-bus slot
    last_mac: int = NEG
    srf_ready: int = 0           # SRF contents usable
    mac_pipe_end: int = 0        # MAC pipeline drained
    mode: int = 0                # 0 = SB, 1 = MB
    mode_ready: int = 0
    drain: int = 0               # running max completion (fences/modes)
    fence_until: int = 0

    @classmethod
    def fresh(cls, nb: int) -> "ChannelState":
        return cls(
            nb=nb,
            open_row=np.full(nb, -1, dtype=np.int64),
            ready_act=np.zeros(nb, dtype=np.int64),
            act_cycle=np.full(nb, NEG, dtype=np.int64),
            rd_cycle=np.full(nb, NEG, dtype=np.int64),
            wr_end=np.full(nb, NEG, dtype=np.int64),
            faw=np.full(4, NEG, dtype=np.int64),
        )


def _quad_banks(q: int, nb: int) -> list[int]:
    """ACT_MB quad q activates one bank per bank group: banks {bg*4 + q}."""
    return [bg * 4 + q for bg in range(nb // 4)]


class RefEngine:
    """Reference resolver.  ``run`` returns (issue_cycles, total_cycles)."""

    def __init__(self, cyc: TimingCycles, validate: bool = True):
        self.c = cyc
        self.validate = validate

    def run(self, stream: np.ndarray) -> tuple[np.ndarray, int]:
        c = self.c
        st = ChannelState.fresh(c.num_banks)
        issue = np.zeros(stream.shape[0], dtype=np.int64)
        for i in range(stream.shape[0]):
            op, a, b, col = (int(x) for x in stream[i])
            issue[i] = self._step(st, op, a, b, col)
        return issue, int(st.drain)

    # ------------------------------------------------------------------
    def _step(self, st: ChannelState, op: int, a: int, b: int, col: int) -> int:
        c = self.c
        t0 = max(st.cmd_free, st.fence_until, st.mode_ready)

        if op == C.NOP:
            return t0

        if op == C.ACT:
            if self.validate:
                assert st.mode == 0, "ACT only in SB mode"
                assert st.open_row[a] == -1, f"bank {a} already open"
            t = max(t0, int(st.ready_act[a]), int(st.act_cycle[a]) + c.cRC,
                    st.last_act + c.cRRD, int(st.faw[st.faw_i]) + c.cFAW)
            st.open_row[a] = b
            st.act_cycle[a] = t
            st.last_act = t
            st.faw[st.faw_i] = t
            st.faw_i = (st.faw_i + 1) % 4
            st.cmd_free = t + c.cACT
            st.drain = max(st.drain, t + c.cRCD)
            return t

        if op == C.PRE:
            t = max(t0, int(st.act_cycle[a]) + c.cRAS,
                    int(st.rd_cycle[a]) + c.cRTP, int(st.wr_end[a]) + c.cWR)
            st.open_row[a] = -1
            st.ready_act[a] = t + c.cRP
            st.cmd_free = t + c.cPRE
            st.drain = max(st.drain, t + c.cRP)
            return t

        if op == C.PREA or op == C.PRE_MB:
            t = max(t0, int(st.act_cycle.max()) + c.cRAS,
                    int(st.rd_cycle.max()) + c.cRTP,
                    int(st.wr_end.max()) + c.cWR,
                    st.last_mac + c.cRTP)
            st.open_row[:] = -1
            st.ready_act[:] = t + c.cRP
            st.cmd_free = t + c.cPRE
            st.drain = max(st.drain, t + c.cRP)
            return t

        if op == C.RD:
            if self.validate:
                assert st.mode == 0 and st.open_row[a] == b, "RD row mismatch"
            turn = c.cWTR if st.bus_dir == 1 else 0
            t = max(t0, int(st.act_cycle[a]) + c.cRCD, st.last_cas + c.cCCD,
                    st.bus_free + turn - c.cRL,
                    int(st.wr_end[a]) + c.cWTR)
            st.rd_cycle[a] = t
            st.last_cas = t
            st.bus_free = t + c.cRL + c.cBURST
            st.bus_dir = 0
            st.cmd_free = t + c.cCAS
            st.drain = max(st.drain, t + c.cRL + c.cBURST)
            return t

        if op == C.WR:
            if self.validate:
                assert st.mode == 0 and st.open_row[a] == b, "WR row mismatch"
            turn = c.cRTW if st.bus_dir == 0 else 0
            t = max(t0, int(st.act_cycle[a]) + c.cRCD, st.last_cas + c.cCCD,
                    st.bus_free + turn - c.cWL)
            st.wr_end[a] = t + c.cWL + c.cBURST
            st.last_cas = t
            st.bus_free = t + c.cWL + c.cBURST
            st.bus_dir = 1
            st.cmd_free = t + c.cCAS
            st.drain = max(st.drain, t + c.cWL + c.cBURST)
            return t

        if op == C.REFAB:
            if self.validate:
                assert (st.open_row == -1).all(), "REFAB needs all precharged"
            t = max(t0, int(st.ready_act.max()))
            st.ready_act[:] = t + c.cRFC
            st.cmd_free = t + c.cACT
            st.drain = max(st.drain, t + c.cRFC)
            return t

        if op in (C.MODE_MB, C.MODE_SB):
            t = max(t0, st.drain)
            st.mode = 1 if op == C.MODE_MB else 0
            st.mode_ready = t + c.cMODE
            st.cmd_free = t + c.cACT
            st.drain = max(st.drain, t + c.cMODE)
            return t

        if op == C.ACT_MB:
            if self.validate:
                assert st.mode == 1, "ACT_MB only in MB mode"
            banks = _quad_banks(a, st.nb)
            t = max(t0, st.last_actmb + c.cRRDMB, st.last_act + c.cRRD,
                    max(int(st.ready_act[x]) for x in banks),
                    max(int(st.act_cycle[x]) for x in banks) + c.cRC)
            for x in banks:
                st.open_row[x] = b
                st.act_cycle[x] = t
            st.last_act = t
            st.last_actmb = t
            st.faw[st.faw_i] = t
            st.faw_i = (st.faw_i + 1) % 4
            st.cmd_free = t + c.cACT
            st.drain = max(st.drain, t + c.cRCD)
            return t

        if op in (C.WR_SRF, C.WR_IRF):
            turn = c.cRTW if st.bus_dir == 0 else 0
            t = max(t0, st.last_cas + c.cSRFI,
                    st.bus_free + turn - c.cWL,
                    st.last_mac + c.cMACWR)
            end = t + c.cWL + c.cBURST
            if op == C.WR_SRF:
                st.srf_ready = max(st.srf_ready, end)
            st.last_cas = t
            st.bus_free = end
            st.bus_dir = 1
            st.cmd_free = t + c.cCAS
            st.drain = max(st.drain, end)
            return t

        if op == C.MAC:
            if self.validate:
                assert st.mode == 1, "MAC only in MB mode"
                assert (st.open_row >= 0).all() or True  # partial fills allowed
            t = max(t0, st.last_mac + c.cMACI, st.srf_ready,
                    int(st.act_cycle.max()) + c.cRCD)
            st.last_mac = t
            st.rd_cycle[:] = t              # MAC reads the open rows
            st.mac_pipe_end = t + c.cMACPIPE
            st.cmd_free = t + c.cMACCMD
            st.drain = max(st.drain, st.mac_pipe_end)
            return t

        if op == C.RD_ACC:
            turn = c.cWTR if st.bus_dir == 1 else 0
            t = max(t0, st.mac_pipe_end, st.last_cas + c.cCCD,
                    st.bus_free + turn - c.cRL)
            st.last_cas = t
            st.bus_free = t + c.cRL + c.cBURST
            st.bus_dir = 0
            st.cmd_free = t + c.cCAS
            st.drain = max(st.drain, t + c.cRL + c.cBURST)
            return t

        if op == C.MOV_ACC:
            t = max(t0, st.mac_pipe_end, st.last_cas + c.cCCD)
            st.wr_end[:] = np.maximum(st.wr_end, t + c.cMOV)
            st.last_cas = t
            st.cmd_free = t + c.cCAS
            st.drain = max(st.drain, t + c.cMOV)
            return t

        if op == C.FENCE:
            # The host-side fence latency is paid per fence instruction:
            # the fence retires cFENCE after the channel drains.
            t = st.drain + c.cFENCE
            st.fence_until = t
            st.cmd_free = t
            st.drain = t
            return t

        raise ValueError(f"unknown opcode {op}")

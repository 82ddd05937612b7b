"""Plain reference of the simulated numbers: specs, command streams, lane
totals, ns, energy and offload decisions.

A frozen, self-contained restatement of the LPDDR5X-PIM timing model the
program implements, written from its documented semantics: the memory
system and its cycle derivation, the per-command GEMV stream synthesis
(tiles, vertical / horizontal block mapping, reshape split, IRF setup and
chunk re-configuration, SRF fills, row-aware MAC sweeps, fences,
accumulator flush-out), the non-PIM baseline (an open-page,
bank-interleaved sequential read), the command-level timing rules, the
counting energy model and the planner's per-site decisions.  Numpy and
Python only; nothing here imports the program.

The lane resolver steps one command at a time.  Long streams are mostly
a block of commands repeated many times (a baseline read repeats one row
group, a GEMV one tile step), and every timing rule is a ``max`` of
earlier event times plus constants.  So once two successive copies of a
block have moved every time the block writes by the same amount and left
the discrete state (bus direction, FAW slot, mode) as it found it, every
further copy moves them by that amount again: :func:`resolve_total` steps
such a run until that holds, then adds the shift for the copies left.
The step is the same with and without the jump, and the tests hold the
two equal.
"""
from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np

# ---------------------------------------------------------------------------
# Memory system
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Timings:
    ck_ghz: float = 1.2
    data_rate_mtps: int = 9600
    channel_bits: int = 16
    burst_len: int = 16
    num_bankgroups: int = 4
    banks_per_group: int = 4
    page_bytes: int = 2048
    tRCD: float = 18.0
    tRP: float = 18.0
    tRAS: float = 42.0
    tRC: float = 60.0
    tRRD: float = 7.5
    tFAW: float = 30.0
    tCCD_ck: int = 2
    tRTP: float = 7.5
    tWR: float = 34.0
    tWTR: float = 10.0
    tRTW_bus: float = 5.0
    tRL: float = 15.0
    tWL: float = 9.0
    tRFCab: float = 280.0
    tREFI: float = 3904.0
    cmd_act_ck: int = 2
    cmd_cas_ck: int = 2
    cmd_pre_ck: int = 1

    @property
    def tck_ns(self) -> float:
        return 1.0 / self.ck_ghz

    @property
    def num_banks(self) -> int:
        return self.num_bankgroups * self.banks_per_group

    @property
    def burst_bytes(self) -> int:
        return self.burst_len * self.channel_bits // 8


@dataclasses.dataclass(frozen=True)
class Pim:
    srf_bytes: int = 512
    acc_regs: int = 64
    acc_bytes_per_reg: int = 4
    irf_entries: int = 32
    mac_interval_ck: int = 3
    mac_cmd_ck: int = 1
    mac_pipe_ck: int = 18
    mac_wr_gap_ck: int = 12
    srf_wr_interval_ck: int = 14
    tRRD_mb_ck: int = 30
    tMODE_ns: float = 150.0
    mov_acc_ck: int = 16
    irf_setup_cmds: int = 16
    irf_chunk_cmds: int = 4
    max_reshape_split: int = 2
    fence_restart_pre: bool = True


@dataclasses.dataclass(frozen=True)
class Spec:
    timings: Timings = dataclasses.field(default_factory=Timings)
    pim: Pim = dataclasses.field(default_factory=Pim)
    num_channels: int = 4
    num_ranks: int = 1
    fence_ns: float = 150.0
    refresh_enabled: bool = False


def spec_from_dict(d: dict) -> Spec:
    d = dict(d)
    return Spec(timings=Timings(**d.pop("timings", {})),
                pim=Pim(**d.pop("pim", {})), **d)


# Cycle constants in the order the step reads them.
CYC = ("cRCD", "cRP", "cRAS", "cRC", "cRRD", "cFAW", "cCCD", "cRTP", "cWR",
       "cWTR", "cRTW", "cRL", "cWL", "cBURST", "cRFC", "cREFI", "cACT",
       "cCAS", "cPRE", "cMODE", "cMACI", "cMACCMD", "cMACPIPE", "cMACWR",
       "cSRFI", "cRRDMB", "cMOV", "cFENCE")


def cycles(spec: Spec) -> dict:
    """Every constraint in whole CK cycles (ns rounded up), plus
    ``tck_ns`` and ``num_banks``."""
    t, p = spec.timings, spec.pim

    def ck(ns: float) -> int:
        return int(math.ceil(ns / t.tck_ns - 1e-9))

    return dict(
        tck_ns=t.tck_ns, num_banks=t.num_banks,
        cRCD=ck(t.tRCD), cRP=ck(t.tRP), cRAS=ck(t.tRAS), cRC=ck(t.tRC),
        cRRD=ck(t.tRRD), cFAW=ck(t.tFAW), cCCD=t.tCCD_ck,
        cRTP=ck(t.tRTP), cWR=ck(t.tWR), cWTR=ck(t.tWTR),
        cRTW=ck(t.tRTW_bus), cRL=ck(t.tRL), cWL=ck(t.tWL),
        cBURST=t.tCCD_ck, cRFC=ck(t.tRFCab), cREFI=ck(t.tREFI),
        cACT=t.cmd_act_ck, cCAS=t.cmd_cas_ck, cPRE=t.cmd_pre_ck,
        cMODE=ck(p.tMODE_ns), cMACI=p.mac_interval_ck,
        cMACCMD=p.mac_cmd_ck, cMACPIPE=p.mac_pipe_ck,
        cMACWR=p.mac_wr_gap_ck, cSRFI=p.srf_wr_interval_ck,
        cRRDMB=p.tRRD_mb_ck, cMOV=p.mov_acc_ck, cFENCE=ck(spec.fence_ns))


def cycles_key(spec: Spec) -> tuple:
    c = cycles(spec)
    return (c["num_banks"],) + tuple(c[k] for k in CYC)


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------

(NOP, ACT, PRE, PREA, RD, WR, REFAB, MODE_MB, MODE_SB, ACT_MB, PRE_MB,
 WR_SRF, WR_IRF, MAC, RD_ACC, MOV_ACC, FENCE) = range(17)
N_OPS = 17
BANK_OPS = (ACT, PRE, RD, WR, ACT_MB)    # ops whose timing reads field a
BURST = 32

DTYPES = {"W8A8": ("int", 8, 8), "W4A4": ("int", 4, 4),
          "W8A16": ("int", 8, 16), "W4A8": ("int", 4, 8),
          "W4A16": ("int", 4, 16), "FP_W8A8": ("fp", 8, 8),
          "FP_W8A16": ("fp", 8, 16)}


class Builder:
    """Per-command stream builder: single ``[op, a, b, c]`` rows, and runs
    of one command with a counting last field as whole blocks."""

    def __init__(self):
        self.blocks: list = []
        self.rows: list = []

    def _flush(self):
        if self.rows:
            self.blocks.append(np.asarray(self.rows, dtype=np.int32))
            self.rows = []

    def emit(self, op, a=0, b=0, c=0):
        self.rows.append((op, a, b, c))

    def repeat(self, op, n, a=0, b=0, c0=0):
        if n <= 0:
            return
        if n < 8:
            self.rows.extend((op, a, b, c0 + i) for i in range(n))
            return
        self._flush()
        blk = np.empty((n, 4), np.int32)
        blk[:, 0], blk[:, 1], blk[:, 2] = op, a, b
        blk[:, 3] = c0 + np.arange(n)
        self.blocks.append(blk)

    def array(self) -> np.ndarray:
        self._flush()
        if not self.blocks:
            return np.zeros((0, 4), np.int32)
        return np.concatenate(self.blocks)


def sequential_read(nbytes: int, spec: Spec) -> np.ndarray:
    """The non-PIM baseline on one channel: per row group, ACT each bank
    used, the bursts round-robin over those banks, then PRE each."""
    t = spec.timings
    nb = t.num_banks
    total = -(-nbytes // t.burst_bytes)
    cols = t.page_bytes // t.burst_bytes
    out, rg = [], 0
    while total > 0:
        group = min(total, cols * nb)
        used = -(-group // cols)
        blk = np.zeros((used + group + used, 4), np.int32)
        blk[:used, 0] = ACT
        blk[:used, 1] = np.arange(used)
        blk[:used, 2] = rg
        i = np.arange(group)
        blk[used:used + group, 0] = RD
        blk[used:used + group, 1] = i % used
        blk[used:used + group, 2] = rg
        blk[used:used + group, 3] = i // used
        blk[used + group:, 0] = PRE
        blk[used + group:, 1] = np.arange(used)
        out.append(blk)
        total -= group
        rg += 1
    return np.concatenate(out) if out else np.zeros((0, 4), np.int32)


@dataclasses.dataclass
class Layout:
    spec: Spec
    H: int
    W: int
    w_bits: int
    t_h: int
    t_w: int
    tile_bytes: int
    srf_cmds: int
    acc_cmds: int
    split: int
    n_h: int
    n_w: int
    group_w: int
    n_logical: int
    rounds: int

    @property
    def nblocks(self):
        s = self.spec
        return s.num_channels * s.num_ranks * s.timings.num_banks

    def block(self, blk: int) -> tuple:
        """Block id -> (channel, rank, bank): channels vary fastest, then
        ranks, bank groups, and banks within a group."""
        s, t = self.spec, self.spec.timings
        ch = blk % s.num_channels
        rest = blk // s.num_channels
        rank = rest % s.num_ranks
        rest //= s.num_ranks
        bg = rest % t.num_bankgroups
        return ch, rank, bg * t.banks_per_group + rest // t.num_bankgroups

    def logicals(self, rnd: int) -> range:
        return range(rnd * self.nblocks,
                     min((rnd + 1) * self.nblocks, self.n_logical))

    def banks(self, rnd: int, ch: int) -> list:
        out = []
        for lg in self.logicals(rnd):
            c, rank, bank = self.block(lg % self.nblocks)
            if c == ch:
                out.append((rank, bank))
        return out

    def w_tile(self, g: int, chunk: int):
        w = g * self.group_w + chunk
        if chunk >= self.group_w or w >= min((g + 1) * self.group_w,
                                             self.n_w):
            return None
        return w

    def groups(self, rnd: int, chunk: int) -> list:
        gs = sorted({lg % self.split for lg in self.logicals(rnd)})
        return [g for g in gs if self.w_tile(g, chunk) is not None]

    def bursts(self, rnd: int, chunk: int) -> int:
        """MACs at (round, chunk): a full tile unless every active block
        holds the short last h-tile."""
        if not self.groups(rnd, chunk):
            return 0
        hs = {lg // self.split for lg in self.logicals(rnd)}
        th = self.t_h if any(h < self.n_h - 1 for h in hs) \
            else self.H - (self.n_h - 1) * self.t_h
        return -(-(th * self.t_w * self.w_bits // 8) // BURST)


def layout(H: int, W: int, dtype: str, reshape: bool, spec: Spec) -> Layout:
    _kind, w_bits, a_bits = DTYPES[dtype]
    p = spec.pim
    t_w = p.srf_bytes * 8 // a_bits
    t_h = p.acc_regs
    tile_bytes = t_h * t_w * w_bits // 8
    srf_cmds = -(-(t_w * a_bits // 8) // spec.timings.burst_bytes)
    acc_cmds = -(-(p.acc_regs * p.acc_bytes_per_reg)
                 // spec.timings.burst_bytes)
    n_h, n_w = -(-H // t_h), -(-W // t_w)
    nblk = spec.num_channels * spec.num_ranks * spec.timings.num_banks
    split = 1
    if reshape and n_h < nblk and n_w > 1:
        split = min(p.max_reshape_split, n_w, max(1, nblk // n_h))
    group_w = -(-n_w // split)
    n_logical = n_h * split
    return Layout(spec, H, W, w_bits, t_h, t_w, tile_bytes, srf_cmds,
                  acc_cmds, split, n_h, n_w, group_w, n_logical,
                  -(-n_logical // nblk))


def gemv_streams(lay: Layout, fence: bool) -> list:
    """One command stream per channel of a PIM GEMV (accumulators read
    out over the bus)."""
    spec = lay.spec
    page = spec.timings.page_bytes
    out = []
    for ch in range(spec.num_channels):
        b = Builder()
        rounds = [r for r in range(lay.rounds) if lay.banks(r, ch)]
        if rounds:
            b.emit(MODE_MB)
            b.repeat(WR_IRF, spec.pim.irf_setup_cmds)
            any_tile = False
            for rnd in rounds:
                banks = lay.banks(rnd, ch)
                quads = sorted({bank % 4 for _r, bank in banks})
                open_row = -1
                for chunk in range(lay.group_w):
                    groups = lay.groups(rnd, chunk)
                    if not groups:
                        continue
                    if fence and any_tile:
                        b.emit(FENCE)
                    b.emit(WR_IRF, rnd % (1 << 15), 1, chunk)
                    b.repeat(WR_IRF, spec.pim.irf_chunk_cmds - 1)
                    for g in groups:
                        for j in range(lay.srf_cmds):
                            b.emit(WR_SRF, g, j)
                    n = lay.bursts(rnd, chunk)
                    off = (rnd * lay.group_w + chunk) * lay.tile_bytes
                    done = 0
                    while done < n:
                        row = off // page
                        if row != open_row:
                            if open_row >= 0:
                                b.emit(PRE_MB)
                            for q in quads:
                                b.emit(ACT_MB, q, row)
                            open_row = row
                        col = (off % page) // BURST
                        k = min(n - done, page // BURST - col)
                        b.repeat(MAC, k, 0, row, col)
                        done += k
                        off += k * BURST
                    if fence:
                        b.emit(FENCE)
                    any_tile = True
                if open_row >= 0:
                    b.emit(PRE_MB)
                for rank, bank in banks:
                    b.repeat(RD_ACC, lay.acc_cmds, bank, rank)
            b.emit(MODE_SB)
        out.append(b.array())
    return out


def baseline_streams(H: int, W: int, dtype: str, spec: Spec) -> list:
    w_bits = DTYPES[dtype][1]
    per_ch = -(-(H * W * w_bits // 8) // spec.num_channels)
    s = sequential_read(per_ch, spec)
    return [s] * spec.num_channels


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

NEG = -(1 << 30)


class _State:
    """Index layout of the flat state list for ``nb`` banks: four per-bank
    time arrays, the FAW ring, scalar times, then discrete fields."""

    def __init__(self, nb: int):
        self.nb = nb
        self.RA, self.AC, self.RC, self.WE = 0, nb, 2 * nb, 3 * nb
        self.FAW = 4 * nb
        (self.LA, self.LAMB, self.LCAS, self.BUS, self.CMD, self.LMAC,
         self.SRF, self.MPE, self.MODER, self.DRAIN,
         self.FENCEU) = range(4 * nb + 4, 4 * nb + 15)
        self.times = 4 * nb + 15
        self.FAWI, self.BUSDIR, self.MODE = range(self.times,
                                                  self.times + 3)

    def fresh(self) -> list:
        nb = self.nb
        s = [0] * nb + [NEG] * (3 * nb) + [NEG] * 4
        s += [NEG, NEG, NEG, 0, 0, NEG, 0, 0, 0, 0, 0]
        return s + [0, 0, 0]

    def writes(self, op: int, a: int) -> set:
        """Every state time ``op`` may write (a superset is safe: a written
        time that does not move blocks the jump)."""
        nb = self.nb
        banks = range(nb)
        w = set() if op == NOP else {self.CMD, self.DRAIN}
        if op == ACT:
            w |= {self.AC + a, self.LA, *range(self.FAW, self.FAW + 4)}
        elif op == ACT_MB:
            w |= {self.AC + bg * 4 + a for bg in range(nb // 4)}
            w |= {self.LA, self.LAMB, *range(self.FAW, self.FAW + 4)}
        elif op == PRE:
            w.add(self.RA + a)
        elif op in (PREA, PRE_MB, REFAB):
            w |= {self.RA + i for i in banks}
        elif op == RD:
            w |= {self.RC + a, self.LCAS, self.BUS}
        elif op == WR:
            w |= {self.WE + a, self.LCAS, self.BUS}
        elif op in (MODE_MB, MODE_SB):
            w.add(self.MODER)
        elif op in (WR_SRF, WR_IRF):
            w |= {self.LCAS, self.BUS}
            if op == WR_SRF:
                w.add(self.SRF)
        elif op == MAC:
            w |= {self.LMAC, self.MPE, *(self.RC + i for i in banks)}
        elif op == RD_ACC:
            w |= {self.LCAS, self.BUS}
        elif op == MOV_ACC:
            w |= {self.LCAS, *(self.WE + i for i in banks)}
        elif op == FENCE:
            w.add(self.FENCEU)
        return w


def _step(s: list, L: _State, c: dict, op: int, a: int) -> int:
    """Issue one command against state ``s`` (in place); its issue
    cycle."""
    nb = L.nb
    t0 = max(s[L.CMD], s[L.FENCEU], s[L.MODER])
    if op == NOP:
        return t0
    if op == ACT:
        t = max(t0, s[L.RA + a], s[L.AC + a] + c["cRC"], s[L.LA] + c["cRRD"],
                s[L.FAW + s[L.FAWI]] + c["cFAW"])
        s[L.AC + a] = t
        s[L.LA] = t
        s[L.FAW + s[L.FAWI]] = t
        s[L.FAWI] = (s[L.FAWI] + 1) % 4
        s[L.CMD] = t + c["cACT"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cRCD"])
        return t
    if op == PRE:
        t = max(t0, s[L.AC + a] + c["cRAS"], s[L.RC + a] + c["cRTP"],
                s[L.WE + a] + c["cWR"])
        s[L.RA + a] = t + c["cRP"]
        s[L.CMD] = t + c["cPRE"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cRP"])
        return t
    if op in (PREA, PRE_MB):
        t = max(t0, max(s[L.AC:L.AC + nb]) + c["cRAS"],
                max(s[L.RC:L.RC + nb]) + c["cRTP"],
                max(s[L.WE:L.WE + nb]) + c["cWR"], s[L.LMAC] + c["cRTP"])
        s[L.RA:L.RA + nb] = [t + c["cRP"]] * nb
        s[L.CMD] = t + c["cPRE"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cRP"])
        return t
    if op == RD:
        turn = c["cWTR"] if s[L.BUSDIR] == 1 else 0
        t = max(t0, s[L.AC + a] + c["cRCD"], s[L.LCAS] + c["cCCD"],
                s[L.BUS] + turn - c["cRL"], s[L.WE + a] + c["cWTR"])
        s[L.RC + a] = t
        s[L.LCAS] = t
        s[L.BUS] = t + c["cRL"] + c["cBURST"]
        s[L.BUSDIR] = 0
        s[L.CMD] = t + c["cCAS"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cRL"] + c["cBURST"])
        return t
    if op == WR:
        turn = c["cRTW"] if s[L.BUSDIR] == 0 else 0
        t = max(t0, s[L.AC + a] + c["cRCD"], s[L.LCAS] + c["cCCD"],
                s[L.BUS] + turn - c["cWL"])
        s[L.WE + a] = t + c["cWL"] + c["cBURST"]
        s[L.LCAS] = t
        s[L.BUS] = t + c["cWL"] + c["cBURST"]
        s[L.BUSDIR] = 1
        s[L.CMD] = t + c["cCAS"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cWL"] + c["cBURST"])
        return t
    if op == REFAB:
        t = max(t0, max(s[L.RA:L.RA + nb]))
        s[L.RA:L.RA + nb] = [t + c["cRFC"]] * nb
        s[L.CMD] = t + c["cACT"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cRFC"])
        return t
    if op in (MODE_MB, MODE_SB):
        t = max(t0, s[L.DRAIN])
        s[L.MODE] = 1 if op == MODE_MB else 0
        s[L.MODER] = t + c["cMODE"]
        s[L.CMD] = t + c["cACT"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cMODE"])
        return t
    if op == ACT_MB:
        banks = [bg * 4 + a for bg in range(nb // 4)]
        t = max(t0, s[L.LAMB] + c["cRRDMB"], s[L.LA] + c["cRRD"],
                max(s[L.RA + x] for x in banks),
                max(s[L.AC + x] for x in banks) + c["cRC"])
        for x in banks:
            s[L.AC + x] = t
        s[L.LA] = t
        s[L.LAMB] = t
        s[L.FAW + s[L.FAWI]] = t
        s[L.FAWI] = (s[L.FAWI] + 1) % 4
        s[L.CMD] = t + c["cACT"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cRCD"])
        return t
    if op in (WR_SRF, WR_IRF):
        turn = c["cRTW"] if s[L.BUSDIR] == 0 else 0
        t = max(t0, s[L.LCAS] + c["cSRFI"], s[L.BUS] + turn - c["cWL"],
                s[L.LMAC] + c["cMACWR"])
        end = t + c["cWL"] + c["cBURST"]
        if op == WR_SRF:
            s[L.SRF] = max(s[L.SRF], end)
        s[L.LCAS] = t
        s[L.BUS] = end
        s[L.BUSDIR] = 1
        s[L.CMD] = t + c["cCAS"]
        s[L.DRAIN] = max(s[L.DRAIN], end)
        return t
    if op == MAC:
        t = max(t0, s[L.LMAC] + c["cMACI"], s[L.SRF],
                max(s[L.AC:L.AC + nb]) + c["cRCD"])
        s[L.LMAC] = t
        s[L.RC:L.RC + nb] = [t] * nb
        s[L.MPE] = t + c["cMACPIPE"]
        s[L.CMD] = t + c["cMACCMD"]
        s[L.DRAIN] = max(s[L.DRAIN], s[L.MPE])
        return t
    if op == RD_ACC:
        turn = c["cWTR"] if s[L.BUSDIR] == 1 else 0
        t = max(t0, s[L.MPE], s[L.LCAS] + c["cCCD"],
                s[L.BUS] + turn - c["cRL"])
        s[L.LCAS] = t
        s[L.BUS] = t + c["cRL"] + c["cBURST"]
        s[L.BUSDIR] = 0
        s[L.CMD] = t + c["cCAS"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cRL"] + c["cBURST"])
        return t
    if op == MOV_ACC:
        t = max(t0, s[L.MPE], s[L.LCAS] + c["cCCD"])
        for i in range(nb):
            s[L.WE + i] = max(s[L.WE + i], t + c["cMOV"])
        s[L.LCAS] = t
        s[L.CMD] = t + c["cCAS"]
        s[L.DRAIN] = max(s[L.DRAIN], t + c["cMOV"])
        return t
    if op == FENCE:
        t = s[L.DRAIN] + c["cFENCE"]
        s[L.FENCEU] = t
        s[L.CMD] = t
        s[L.DRAIN] = t
        return t
    raise ValueError(f"unknown opcode {op}")


def _runs(ops: np.ndarray, a: np.ndarray, min_reps: int = 4) -> list:
    """Non-overlapping ``(start, period, reps)``: ``reps`` copies of one
    block of ``period`` commands, equal in every field the step reads.
    Candidate periods are the commonest gaps between repeats of a few
    anchor commands; which are found only decides the speed."""
    n = ops.shape[0]
    if n < 64:
        return []
    key = ops.astype(np.int64) * (1 << 32) + np.where(
        np.isin(ops, BANK_OPS), a, 0).astype(np.int64)
    periods = set()
    for at in {0, n // 7, n // 3, n // 2, (2 * n) // 3, n - 1}:
        pos = np.flatnonzero(key == key[at])
        if pos.size >= min_reps:
            gaps, counts = np.unique(np.diff(pos), return_counts=True)
            periods.update(int(g) for g in gaps[np.argsort(-counts)[:2]])
    found = []
    for p in sorted(periods):
        if p <= 0 or p * min_reps > n:
            continue
        eq = np.concatenate([[False], key[p:] == key[:-p], [False]])
        edges = np.flatnonzero(np.diff(eq.astype(np.int8)))
        for lo, hi in zip(edges[0::2], edges[1::2]):
            reps = (hi - lo) // p + 1      # [lo, hi + p) is p-periodic
            if reps >= min_reps:
                found.append((reps * p, int(lo), p, int(reps)))
    chosen, starts, ends = [], [], []      # taken spans, sorted
    for cover, lo, p, reps in sorted(found, reverse=True):
        hi = lo + reps * p
        k = bisect.bisect_left(starts, lo)
        if (k == 0 or ends[k - 1] <= lo) and (k == len(starts)
                                               or starts[k] >= hi):
            chosen.append((lo, p, reps))
            starts.insert(k, lo)
            ends.insert(k, hi)
    return sorted(chosen)


def resolve_total(stream: np.ndarray, cyc: dict,
                  jump: bool = True) -> int:
    """A lane's total cycles: the channel's drain after its last
    command.  ``jump=False`` steps every command."""
    L = _State(cyc["num_banks"])
    s = L.fresh()
    ops = stream[:, 0]
    al = stream[:, 1].tolist()
    opl = ops.tolist()
    runs = _runs(ops, stream[:, 1]) if jump else []
    i = 0
    for start, p, reps in runs:
        for j in range(i, start):
            _step(s, L, cyc, opl[j], al[j])
        writes = set()
        for j in range(start, start + p):
            writes |= L.writes(opl[j], al[j])
        hist = [list(s)]
        b = 0
        while b < reps:
            lo = start + b * p
            for j in range(lo, lo + p):
                _step(s, L, cyc, opl[j], al[j])
            b += 1
            hist = (hist + [list(s)])[-3:]
            if len(hist) == 3 and b < reps:
                s0, s1, s2 = hist
                delta = s2[L.DRAIN] - s1[L.DRAIN]
                same = all(s0[k] == s1[k] == s2[k]
                           for k in range(L.times, L.times + 3))
                moved = all(s1[k] - s0[k] == delta and s2[k] - s1[k] == delta
                            for k in writes)
                still = all(s0[k] == s2[k] for k in range(L.times)
                            if k not in writes)
                if same and moved and still and delta >= 0:
                    for k in writes:
                        s[k] += (reps - b) * delta
                    b = reps
        i = start + reps * p
    for j in range(i, len(opl)):
        _step(s, L, cyc, opl[j], al[j])
    return s[L.DRAIN]


# ---------------------------------------------------------------------------
# Energy (counting model)
# ---------------------------------------------------------------------------

ENERGY = dict(e_act_pj=800.0, e_rd_pj=350.0, e_wr_pj=330.0,
              e_rd_io_pj=150.0, e_mac_pj=180.0, e_srf_pj=120.0,
              e_acc_rd_pj=200.0, e_mov_pj=260.0, e_ref_pj=25000.0,
              e_mode_pj=500.0, p_bg_mw_per_ch=120.0)


def op_counts(stream: np.ndarray) -> np.ndarray:
    return np.bincount(stream[:, 0], minlength=N_OPS)


def channel_energy(counts: np.ndarray, total: int, spec: Spec,
                   active: int) -> dict:
    p, t = ENERGY, spec.timings
    ns = total * t.tck_ns
    act = (counts[ACT] * p["e_act_pj"]
           + counts[ACT_MB] * p["e_act_pj"] * t.num_bankgroups)
    io = (counts[RD] * p["e_rd_pj"] + counts[WR] * p["e_wr_pj"]
          + counts[RD_ACC] * p["e_acc_rd_pj"]
          + (counts[WR_SRF] + counts[WR_IRF]) * p["e_srf_pj"])
    mac = counts[MAC] * p["e_mac_pj"] * active
    misc = (counts[REFAB] * p["e_ref_pj"]
            + (counts[MODE_MB] + counts[MODE_SB]) * p["e_mode_pj"]
            + counts[MOV_ACC] * p["e_mov_pj"])
    bg = p["p_bg_mw_per_ch"] * 1e-3 * ns
    total_pj = act + io + mac + misc + bg
    return dict(total_pj=float(total_pj), act_pj=float(act),
                io_pj=float(io), mac_pj=float(mac), misc_pj=float(misc),
                background_pj=float(bg), runtime_ns=float(ns))


# ---------------------------------------------------------------------------
# Points and decisions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Point:
    """One simulated GEMV: its streams, lane totals and results."""

    streams: list
    totals: list
    cycles: int
    ns: float
    energy: dict
    counts: np.ndarray
    flops: int
    weight_bytes: int
    utilization: float
    split: int


def point(kind: str, H: int, W: int, dtype: str, spec: Spec,
          fence: bool = True, reshape: bool = False,
          float_bits: int = 64) -> Point:
    """Simulate one PIM GEMV (``kind="pim"``) or its host baseline.
    ``float_bits=32`` computes ns and energy in float32 (the control)."""
    cyc = cycles(spec)
    if kind == "pim":
        lay = layout(H, W, dtype, reshape, spec)
        streams = gemv_streams(lay, fence)
        active = max(1, int(round(16 * lay.n_logical
                                  / (lay.rounds * lay.nblocks))))
        util, split = lay.n_logical / (lay.rounds * lay.nblocks), lay.split
        wbytes = H * W * lay.w_bits // 8
    else:
        streams = baseline_streams(H, W, dtype, spec)
        active, util, split = 16, 1.0, 1
        wbytes = H * W * DTYPES[dtype][1] // 8
    totals, seen = [], []
    for s in streams:
        for prev, tot in seen:
            if prev is s or (prev.shape == s.shape
                             and np.array_equal(prev, s)):
                break
        else:
            tot = resolve_total(s, cyc)
            seen.append((s, tot))
        totals.append(tot)
    cyc_max = max(totals) if totals else 0
    ch_counts = [op_counts(s) for s in streams]
    counts = sum(ch_counts, np.zeros(N_OPS, dtype=np.int64))
    per_ch = [channel_energy(n, tot, spec, active)
              for n, tot in zip(ch_counts, totals)]
    total_pj = sum(d["total_pj"] for d in per_ch)
    flops = 2 * H * W
    ns = cyc_max * cyc["tck_ns"]
    if float_bits == 32:
        f = np.float32
        ns = float(f(cyc_max) * f(cyc["tck_ns"]))
        total_pj = float(sum((f(d["total_pj"]) for d in per_ch), f(0)))
    energy = dict(total_pj=total_pj, pj_per_op=total_pj / max(flops, 1),
                  runtime_ns=max(d["runtime_ns"] for d in per_ch),
                  channels=per_ch)
    return Point(streams, totals, cyc_max, ns, energy, counts, flops,
                 wbytes, util, split)


@dataclasses.dataclass(frozen=True)
class Site:
    name: str
    h: int
    w: int
    count: int


def decode_sites(cfg: dict) -> list:
    """The weight matrices one decode token multiplies, layers folded."""
    L, d = cfg["n_layers"], cfg["d_model"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    sites = [Site("attn.wq", hq * hd, d, L), Site("attn.wk", hkv * hd, d, L),
             Site("attn.wv", hkv * hd, d, L), Site("attn.wo", d, hq * hd, L)]
    n = 3 if cfg.get("mlp", "swiglu") == "swiglu" else 2
    if cfg["family"] == "moe":
        e, k = cfg["moe"]["n_experts"], cfg["moe"]["top_k"]
        sites.append(Site("moe.router", e, d, L))
        sites += [Site(f"moe.w{i}", cfg["d_ff"], d, L * k)
                  for i in range(n - 1)]
        sites.append(Site("moe.wo", d, cfg["d_ff"], L * k))
    else:
        sites += [Site(f"mlp.w{i}", cfg["d_ff"], d, L) for i in range(n - 1)]
        sites.append(Site("mlp.wo", d, cfg["d_ff"], L))
    vocab_padded = -(-cfg["vocab"] // 256) * 256
    sites.append(Site("lm_head", vocab_padded, d, 1))
    return sites


@dataclasses.dataclass
class Decision:
    site: Site
    pim_ns: float
    host_ns: float
    reshape: bool
    offload_below_batch: int


def plan(cfg: dict, spec: Spec, dtype: str = "W8A8", fence: bool = True,
         float_bits: int = 64) -> tuple:
    """A spec's decisions and its points, keyed by (kind, site name)."""
    points, out = {}, []
    for site in decode_sites(cfg):
        reshape = site.h < 2048
        pim = point("pim", site.h, site.w, dtype, spec, fence, reshape,
                    float_bits)
        base = point("baseline", site.h, site.w, dtype, spec,
                     float_bits=float_bits)
        points[("pim", site.name)] = pim
        points[("baseline", site.name)] = base
        out.append(Decision(site, pim.ns, base.ns, reshape,
                            max(1, int(base.ns / pim.ns))))
    return out, points


def decode_speedup(decisions: list, batch: int) -> dict:
    """Amdahl over every site: the step on the host alone and with every
    site PIM wins at ``batch`` offloaded."""
    off = {d.site.name for d in decisions
           if d.pim_ns * batch < d.host_ns}
    host = mixed = 0.0
    for d in decisions:
        h = d.host_ns * d.site.count
        host += h
        mixed += d.pim_ns * batch * d.site.count if d.site.name in off \
            else h
    return dict(batch=batch, host_ns=host, mixed_ns=mixed,
                speedup=host / max(mixed, 1e-9),
                offloaded=[d.site.name for d in decisions
                           if d.site.name in off],
                n_sites=len(decisions))

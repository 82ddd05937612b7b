"""Functional LP5X-PIM device model (behavioral fidelity layer).

Interprets a GEMV command stream *at burst granularity* against the
per-bank DRAM images produced by the Data Mapper: ACT_MB tracks open rows,
WR_SRF fills the source register files (payload side-band), MAC executes
the IRF program step (decode 32 B of weights from the open row, multiply
against the SRF window, accumulate), RD_ACC snapshots the accumulator
file.  The output must equal ``W @ x`` computed by numpy — asserted by the
behavioral tests — which is the "consistent behavioral accuracy" the paper
claims for the integrated HW/SW model.

The interpreter is deliberately independent from the stream *generator*:
it trusts only the command stream, the DRAM images, and the IRF program,
so layout or codegen bugs cannot cancel out.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import commands as C
from repro_torch.pimkernel import codegen
from repro_torch.pimkernel.datamapper import PimLayout

BURST = 32


class PimDeviceModel:
    """Functional interpreter for one channel."""

    def __init__(self, layout: PimLayout, program: codegen.PimProgram,
                 channel: int,
                 dram: dict[tuple[int, int, int], np.ndarray]):
        self.layout = layout
        self.program = program
        self.ch = channel
        spec = layout.spec
        self.page = spec.timings.page_bytes
        self.nb = spec.timings.num_banks
        self.nr = spec.num_ranks
        self.dram = {(r, b): dram[(channel, r, b)]
                     for r in range(self.nr) for b in range(self.nb)}
        is_fp = layout.tc.dtype.is_fp
        self.acc_dtype = np.float64 if is_fp else np.int64
        self.srf = {(r, b): np.zeros(layout.tc.srf_wr_cmds * BURST, np.uint8)
                    for r in range(self.nr) for b in range(self.nb)}
        self.acc = {(r, b): np.zeros(layout.tc.t_h, self.acc_dtype)
                    for r in range(self.nr) for b in range(self.nb)}
        self.open_row = np.full(self.nb, -1, dtype=np.int64)
        self.pc = 0
        self.round = -1
        self.bankmap: dict[tuple[int, int], tuple[int, int]] = {}
        self.snapshots: dict[tuple[int, int, int], np.ndarray] = {}
        self._flushed: set[tuple[int, int]] = set()

    # ------------------------------------------------------------------
    def _enter_round(self, rnd: int) -> None:
        self.round = rnd
        self.bankmap.clear()
        self._flushed.clear()
        for logical in self.layout.active_logicals(rnd):
            r2, (ch, rank, bank) = self.layout.place(logical)
            if ch == self.ch:
                self.bankmap[(rank, bank)] = (logical // self.layout.split,
                                              logical % self.layout.split)
        for key in self.acc:
            self.acc[key][:] = 0

    def run(self, stream: np.ndarray,
            payloads: dict[int, np.ndarray]) -> dict:
        tc = self.layout.tc
        prog = self.program
        for i in range(stream.shape[0]):
            op, a, b, col = (int(v) for v in stream[i])
            if op == C.MAC:
                svals_cache: dict[int, np.ndarray] = {}
                for (rank, bank), (_h, g) in self.bankmap.items():
                    row = int(self.open_row[bank])
                    assert row >= 0, "MAC on closed row"
                    byte = row * self.page + col * BURST
                    img = self.dram[(rank, bank)]
                    raw = img[byte:byte + BURST]
                    w = codegen.decode_w_burst(raw, tc.dtype)
                    srf_vals = codegen.decode_srf(self.srf[(rank, bank)],
                                                  tc.dtype)
                    o = int(prog.srf_off[self.pc])
                    seg = srf_vals[o:o + prog.n_elems]
                    acc_i = int(prog.acc_idx[self.pc])
                    if tc.dtype.is_fp:
                        self.acc[(rank, bank)][acc_i] += float(
                            np.dot(w.astype(np.float64),
                                   seg.astype(np.float64)))
                    else:
                        self.acc[(rank, bank)][acc_i] += int(
                            np.dot(w.astype(np.int64),
                                   seg.astype(np.int64)))
                self.pc += 1
            elif op == C.ACT_MB:
                banks = [bg * 4 + a for bg in range(self.nb // 4)]
                for bk in banks:
                    self.open_row[bk] = b
            elif op == C.PRE_MB or op == C.PREA:
                self.open_row[:] = -1
            elif op == C.WR_SRF:
                data = payloads.get(i)
                if data is not None:
                    for (rank, bank), (_h, g) in self.bankmap.items():
                        if g == a:
                            self.srf[(rank, bank)][
                                b * BURST:(b + 1) * BURST] = data
            elif op == C.WR_IRF:
                if b == 1:  # chunk-start marker
                    self.pc = 0
                    if a != self.round:
                        self._enter_round(a)
            elif op == C.RD_ACC:
                key = (b, a)  # (rank, bank)
                if key in self.bankmap and key not in self._flushed:
                    self._flushed.add(key)
                    self.snapshots[(b, a, self.round)] = \
                        self.acc[key].copy()
            # NOP/ACT/PRE/RD/WR/REFAB/MODE_*/FENCE/MOV_ACC: no functional
            # effect on the GEMV datapath model.
        return self.snapshots


def execute_gemv(layout: PimLayout, program: codegen.PimProgram,
                 dram: dict, streams, payloads) -> np.ndarray:
    """Run all channels' streams; assemble y (padded_h) from ACC snapshots."""
    is_fp = layout.tc.dtype.is_fp
    y = np.zeros(layout.padded_h, dtype=np.float64 if is_fp else np.int64)
    snaps = {}
    for ch in range(layout.spec.num_channels):
        dev = PimDeviceModel(layout, program, ch, dram)
        snaps[ch] = dev.run(streams[ch], payloads[ch])
    for logical in range(layout.n_logical):
        rnd, (ch, rank, bank) = layout.place(logical)
        h = logical // layout.split
        acc = snaps[ch].get((rank, bank, rnd))
        assert acc is not None, f"missing flush for logical {logical}"
        y[h * layout.tc.t_h:(h + 1) * layout.tc.t_h] += acc
    return y[: layout.H]

"""Energy model for LPDDR5X / LP5X-PIM.

Per-command energies are derived from representative LPDDR5X IDD figures
(activate/precharge pair, read/write burst I/O + array access) plus PIM
compute-unit estimates; background power covers standby/clocking.  Values
are approximate — the paper does not publish circuit energy — and are
exposed on :class:`EnergyParams` so studies can re-parameterize.

The model is *counting based*: it consumes the opcode histogram of a
resolved stream plus the total runtime; it does not need to be inside the
cycle engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import commands as C
from .timing import SystemSpec


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    e_act_pj: float = 800.0      # ACT+PRE pair, one bank (row open energy)
    e_rd_pj: float = 350.0       # 32 B read burst (array + I/O)
    e_wr_pj: float = 330.0       # 32 B write burst
    e_rd_io_pj: float = 150.0    # I/O part (saved by PIM-internal access)
    e_mac_pj: float = 180.0      # per bank: 32 B internal read + MAC
    e_srf_pj: float = 120.0      # broadcast SRF/IRF write (per command)
    e_acc_rd_pj: float = 200.0   # ACC register read-out burst
    e_mov_pj: float = 260.0      # ACC -> DRAM internal move
    e_ref_pj: float = 25000.0    # REFab
    e_mode_pj: float = 500.0     # mode transition
    p_bg_mw_per_ch: float = 120.0  # background (standby + clock) per channel


def stream_energy_pj(counts: np.ndarray, total_cycles: int,
                     spec: SystemSpec,
                     params: EnergyParams = EnergyParams(),
                     active_banks: int = 16) -> dict:
    """Energy (pJ) for one channel given opcode counts and runtime."""
    t = spec.timings
    ns = total_cycles * t.tck_ns
    # ACT_MB opens `num_bankgroups` banks with one command.
    act_energy = (counts[C.ACT] * params.e_act_pj
                  + counts[C.ACT_MB] * params.e_act_pj * t.num_bankgroups)
    io_energy = (counts[C.RD] * params.e_rd_pj
                 + counts[C.WR] * params.e_wr_pj
                 + counts[C.RD_ACC] * params.e_acc_rd_pj
                 + (counts[C.WR_SRF] + counts[C.WR_IRF]) * params.e_srf_pj)
    # A broadcast MAC performs `active_banks` internal reads + MACs.
    mac_energy = counts[C.MAC] * params.e_mac_pj * active_banks
    misc = (counts[C.REFAB] * params.e_ref_pj
            + (counts[C.MODE_MB] + counts[C.MODE_SB]) * params.e_mode_pj
            + counts[C.MOV_ACC] * params.e_mov_pj)
    background = params.p_bg_mw_per_ch * 1e-3 * ns  # mW * ns = pJ
    total = act_energy + io_energy + mac_energy + misc + background
    return dict(total_pj=float(total), act_pj=float(act_energy),
                io_pj=float(io_energy), mac_pj=float(mac_energy),
                misc_pj=float(misc), background_pj=float(background),
                runtime_ns=float(ns))


def gemv_energy_summary(streams: list[np.ndarray], totals: np.ndarray,
                        spec: SystemSpec, flops: int,
                        params: EnergyParams = EnergyParams(),
                        active_banks: int = 16) -> dict:
    """Aggregate channel energies; report pJ/op for a GEMV of `flops`."""
    per_ch = [stream_energy_pj(C.op_counts(s), int(tc), spec, params,
                               active_banks)
              for s, tc in zip(streams, totals)]
    total_pj = sum(d["total_pj"] for d in per_ch)
    runtime_ns = max(d["runtime_ns"] for d in per_ch)
    return dict(total_pj=total_pj,
                pj_per_op=total_pj / max(flops, 1),
                runtime_ns=runtime_ns,
                channels=per_ch)

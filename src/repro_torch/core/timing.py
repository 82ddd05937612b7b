"""LPDDR5X timing / PIM device parameters.

All primary timing values are given in nanoseconds and converted to integer
command-clock (CK) cycles.  LPDDR5X-9600 operates the data bus at 9600 MT/s
per pin with WCK = 4.8 GHz and CK = 1.2 GHz (WCK:CK = 4:1).  One BL16 burst
moves 32 B per 16-bit channel and occupies 2 CK on the data bus, hence
seamless bursts at tCCD = 2 CK deliver 19.2 GB/s per channel.

JEDEC JESD209-5C timing values are speed-bin dependent; the numbers below
are representative round values documented in DESIGN.md §2.2.  PIM-specific
values (MAC interval, SRF/ACC capacities, mode-transition time, ...) are the
calibration knobs of the model — the JEDEC standard does not cover them and
the paper keeps the circuit details confidential, so they are fit so that
the paper's published speedups emerge (see EXPERIMENTS.md §Paper).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LpddrTimings:
    """JEDEC-style analog timing values for one LPDDR5X channel (ns)."""

    ck_ghz: float = 1.2          # command clock (CK); tCK = 0.8333 ns
    data_rate_mtps: int = 9600   # per-pin data rate
    channel_bits: int = 16       # DQ width per channel
    burst_len: int = 16          # BL16
    num_bankgroups: int = 4
    banks_per_group: int = 4
    page_bytes: int = 2048       # row buffer per bank
    # --- core timings (ns) ---
    tRCD: float = 18.0
    tRP: float = 18.0
    tRAS: float = 42.0
    tRC: float = 60.0
    tRRD: float = 7.5
    tFAW: float = 30.0
    tCCD_ck: int = 2             # CAS-to-CAS, in CK (BL16 seamless)
    tRTP: float = 7.5
    tWR: float = 34.0
    tWTR: float = 10.0
    tRTW_bus: float = 5.0        # extra data-bus turnaround rd->wr
    tRL: float = 15.0            # read latency (CAS to data)
    tWL: float = 9.0             # write latency
    tRFCab: float = 280.0        # all-bank refresh (8 Gb die)
    tREFI: float = 3904.0
    cmd_act_ck: int = 2          # ACT occupies 2 CA slots (ACT-1/ACT-2)
    cmd_cas_ck: int = 2          # RD/WR occupy 2 CA slots
    cmd_pre_ck: int = 1

    @property
    def tck_ns(self) -> float:
        return 1.0 / self.ck_ghz

    @property
    def num_banks(self) -> int:
        return self.num_bankgroups * self.banks_per_group

    @property
    def burst_bytes(self) -> int:
        return self.burst_len * self.channel_bits // 8  # 32 B

    @property
    def channel_gbps(self) -> float:
        """Peak data bandwidth per channel in GB/s."""
        return self.data_rate_mtps * 1e6 * self.channel_bits / 8 / 1e9


@dataclasses.dataclass(frozen=True)
class PimSpec:
    """LP5X-PIM block parameters (per-bank PIM units).  Calibrated knobs."""

    srf_bytes: int = 512         # source register file (input-vector chunk)
    acc_regs: int = 64           # 32-bit accumulators -> T_h
    acc_bytes_per_reg: int = 4
    irf_entries: int = 32        # instruction register file depth
    mac_interval_ck: int = 3     # broadcast MAC command spacing (CK)
    mac_cmd_ck: int = 1          # CA-bus slots a MAC occupies
    mac_pipe_ck: int = 18        # MAC pipeline depth (drain before readout)
    mac_wr_gap_ck: int = 12      # last MAC -> SRF/IRF write turnaround
    srf_wr_interval_ck: int = 14  # WR_SRF/WR_IRF spacing (SRF write port)
    tRRD_mb_ck: int = 30         # ACT_MB -> ACT_MB spacing (power limited)
    tMODE_ns: float = 150.0      # SB<->MB mode transition
    mov_acc_ck: int = 16         # ACC -> DRAM internal move per burst
    irf_setup_cmds: int = 16     # WR_IRF commands to program a kernel
    irf_chunk_cmds: int = 4      # per-chunk IRF/config rewrites
    max_reshape_split: int = 2   # column-split bound (IRF addressing)
    fence_restart_pre: bool = True   # fences force row close (ordering)

    @property
    def acc_file_bytes(self) -> int:
        return self.acc_regs * self.acc_bytes_per_reg


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """Full reference memory system: LPDDR5X-9600, 4 channels (paper §3)."""

    timings: LpddrTimings = dataclasses.field(default_factory=LpddrTimings)
    pim: PimSpec = dataclasses.field(default_factory=PimSpec)
    num_channels: int = 4
    num_ranks: int = 1
    fence_ns: float = 150.0      # static memory-fence latency (paper §3.2)
    refresh_enabled: bool = False

    @property
    def total_pim_blocks(self) -> int:
        return self.num_channels * self.num_ranks * self.timings.num_banks

    def derive_cycles(self) -> "TimingCycles":
        t = self.timings
        p = self.pim

        def ck(ns: float) -> int:
            return int(math.ceil(ns / t.tck_ns - 1e-9))

        return TimingCycles(
            tck_ns=t.tck_ns,
            num_banks=t.num_banks,
            cRCD=ck(t.tRCD), cRP=ck(t.tRP), cRAS=ck(t.tRAS), cRC=ck(t.tRC),
            cRRD=ck(t.tRRD), cFAW=ck(t.tFAW), cCCD=t.tCCD_ck,
            cRTP=ck(t.tRTP), cWR=ck(t.tWR), cWTR=ck(t.tWTR),
            cRTW=ck(t.tRTW_bus), cRL=ck(t.tRL), cWL=ck(t.tWL),
            cBURST=t.tCCD_ck, cRFC=ck(t.tRFCab), cREFI=ck(t.tREFI),
            cACT=t.cmd_act_ck, cCAS=t.cmd_cas_ck, cPRE=t.cmd_pre_ck,
            cMODE=ck(p.tMODE_ns), cMACI=p.mac_interval_ck,
            cMACCMD=p.mac_cmd_ck, cMACPIPE=p.mac_pipe_ck,
            cMACWR=p.mac_wr_gap_ck, cSRFI=p.srf_wr_interval_ck,
            cRRDMB=p.tRRD_mb_ck, cMOV=p.mov_acc_ck,
            cFENCE=ck(self.fence_ns),
        )


@dataclasses.dataclass(frozen=True)
class TimingCycles:
    """All constraints in integer CK cycles — shared by both engines.

    A plain frozen dataclass: a fleet of timing configurations becomes
    one int32 ``(F, len(CYC_FIELDS))`` tensor (``engine.pack_cycles``),
    with ``num_banks`` picking the kernel instantiation and ``tck_ns``
    (unused by the timing step) left out.
    """

    tck_ns: float
    num_banks: int
    cRCD: int; cRP: int; cRAS: int; cRC: int
    cRRD: int; cFAW: int; cCCD: int
    cRTP: int; cWR: int; cWTR: int; cRTW: int
    cRL: int; cWL: int; cBURST: int
    cRFC: int; cREFI: int
    cACT: int; cCAS: int; cPRE: int
    cMODE: int; cMACI: int; cMACCMD: int; cMACPIPE: int
    cMACWR: int; cSRFI: int; cRRDMB: int; cMOV: int
    cFENCE: int

    def as_tuple(self) -> tuple:
        return dataclasses.astuple(self)


# A default spec used across tests/benchmarks.
DEFAULT_SYSTEM = SystemSpec()


def spec_from_dict(d: dict) -> SystemSpec:
    """A :class:`SystemSpec` from ``dataclasses.asdict`` of an equal spec
    (nested ``timings`` / ``pim`` dicts) — how a design point defined
    elsewhere is carried over field for field."""
    d = dict(d)
    return SystemSpec(timings=LpddrTimings(**d.pop("timings")),
                      pim=PimSpec(**d.pop("pim")), **d)


def cycles_from_dict(d: dict) -> TimingCycles:
    """A :class:`TimingCycles` from ``dataclasses.asdict`` of an equal one."""
    return TimingCycles(**d)

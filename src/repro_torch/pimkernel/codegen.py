"""PIM Device Code Gen (paper §2.2, PIM Executor sub-component 1).

"Dynamically synthesizes optimized PIM instructions (IRF code) and hardware
configuration code based on matrix shapes and data types."

The IRF program of a GEMV kernel is the per-tile MAC traversal: for the
k-th 32 B weight burst of a tile it names the destination accumulator and
the SRF operand window.  The hardware executes it as a loop nest
(ACC-outer, SRF-inner); we synthesize both the loop-nest form (what would
be written to the IRF — bounded by ``PimSpec.irf_entries``) and the
flattened per-burst arrays the functional device model consumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.timing import PimSpec
from .tileconfig import PimDType, TileConfig

BURST = 32


@dataclasses.dataclass(frozen=True)
class IrfInsn:
    op: str                  # LOOP / MAC / FLUSH / CFG
    args: tuple


@dataclasses.dataclass
class PimProgram:
    """IRF code + flattened burst->operand mapping for one tile shape."""

    dtype: PimDType
    insns: list               # loop-nest IRF form
    acc_idx: np.ndarray       # (macs_per_tile,) destination accumulator
    srf_off: np.ndarray       # (macs_per_tile,) first SRF element index
    n_elems: int              # weight elements per 32 B burst
    setup_cmds: int           # WR_IRF commands to load the program
    chunk_cfg_cmds: int       # WR_IRF commands per chunk re-config

    def __len__(self) -> int:
        return len(self.insns)


def synthesize(tc: TileConfig, pim: PimSpec) -> PimProgram:
    """Generate the GEMV IRF program for one tile geometry."""
    row_bytes = tc.t_w * tc.dtype.w_bits // 8
    bursts_per_row = -(-row_bytes // BURST)
    n_elems = BURST * 8 // tc.dtype.w_bits

    # Loop-nest (IRF) form: outer loop over accumulators (tile rows),
    # inner loop over the row's weight bursts.  This is what bounds the
    # program to a handful of IRF entries regardless of tile size.
    insns = [
        IrfInsn("CFG", ("dtype", tc.dtype.name)),
        IrfInsn("LOOP", ("acc", tc.t_h)),
        IrfInsn("LOOP", ("burst", bursts_per_row)),
        IrfInsn("MAC", ("acc=acc", "srf=burst*%d" % n_elems)),
        IrfInsn("ENDL", ("burst",)),
        IrfInsn("ENDL", ("acc",)),
        IrfInsn("FLUSH", ()),
    ]
    assert len(insns) <= pim.irf_entries, "IRF overflow"

    k = np.arange(tc.macs_per_tile, dtype=np.int64)
    byte_in_tile = k * BURST
    acc = byte_in_tile // row_bytes
    elem = (byte_in_tile % row_bytes) * 8 // tc.dtype.w_bits
    return PimProgram(
        dtype=tc.dtype,
        insns=insns,
        acc_idx=acc.astype(np.int32),
        srf_off=elem.astype(np.int32),
        n_elems=n_elems,
        setup_cmds=pim.irf_setup_cmds,
        chunk_cfg_cmds=pim.irf_chunk_cmds,
    )


def decode_srf(raw: np.ndarray, dtype: PimDType) -> np.ndarray:
    """Decode SRF bytes into activation values (int paths / fp via codes)."""
    if dtype.is_fp:
        if dtype.a_bits == 8:
            return _fp8_decode(raw)
        return raw.view(np.float16).astype(np.float32)
    if dtype.a_bits == 8:
        return raw.view(np.int8).astype(np.int32)
    if dtype.a_bits == 16:
        return raw.view("<i2").astype(np.int32)
    if dtype.a_bits == 4:
        lo = (raw & 0xF).astype(np.int8)
        hi = ((raw >> 4) & 0xF).astype(np.int8)
        lo = np.where(lo >= 8, lo - 16, lo).astype(np.int32)
        hi = np.where(hi >= 8, hi - 16, hi).astype(np.int32)
        out = np.empty(raw.size * 2, dtype=np.int32)
        out[0::2] = lo
        out[1::2] = hi
        return out
    raise ValueError(dtype)


def encode_acts(x: np.ndarray, dtype: PimDType) -> np.ndarray:
    """Encode activation values into SRF byte layout."""
    if dtype.is_fp:
        if dtype.a_bits == 8:
            return _fp8_encode(x)
        return x.astype(np.float16).view(np.uint8)
    if dtype.a_bits == 8:
        return x.astype(np.int8).view(np.uint8)
    if dtype.a_bits == 16:
        return x.astype("<i2").view(np.uint8)
    if dtype.a_bits == 4:
        m = x.astype(np.int8)
        lo = (m[0::2] & 0xF).astype(np.uint8)
        hi = (m[1::2] & 0xF).astype(np.uint8)
        return lo | (hi << 4)
    raise ValueError(dtype)


# --- fp8 (e4m3, no inf, saturating) helpers used by the FP dtypes --------
_FP8_TABLE = None


def _fp8_table() -> np.ndarray:
    global _FP8_TABLE
    if _FP8_TABLE is None:
        codes = np.arange(256, dtype=np.uint32)
        sign = np.where(codes >> 7, -1.0, 1.0)
        exp = ((codes >> 3) & 0xF).astype(np.int32)
        man = (codes & 0x7).astype(np.float64)
        normal = sign * (1.0 + man / 8.0) * np.exp2(exp - 7.0)
        subnorm = sign * (man / 8.0) * np.exp2(-6.0)
        vals = np.where(exp == 0, subnorm, normal)
        # e4m3fn: exp==15, man==7 is NaN; keep finite (saturate) for sim.
        _FP8_TABLE = vals.astype(np.float32)
    return _FP8_TABLE


def _fp8_decode(raw: np.ndarray) -> np.ndarray:
    return _fp8_table()[raw]


def _fp8_encode(x: np.ndarray) -> np.ndarray:
    """Nearest-value quantization to e4m3 codes (simulation-grade)."""
    table = _fp8_table()
    order = np.argsort(table, kind="stable")
    svals = table[order]
    idx = np.searchsorted(svals, x.astype(np.float32))
    idx = np.clip(idx, 1, 255)
    left = svals[idx - 1]
    right = svals[np.minimum(idx, 255)]
    pick = np.where(np.abs(x - left) <= np.abs(right - x), idx - 1, idx)
    return order[pick].astype(np.uint8)


def decode_w_burst(raw: np.ndarray, dtype: PimDType) -> np.ndarray:
    """Decode one 32 B weight burst into values (int32 or float32)."""
    if dtype.is_fp:
        return _fp8_decode(raw)
    if dtype.w_bits == 8:
        return raw.view(np.int8).astype(np.int32)
    if dtype.w_bits == 4:
        lo = (raw & 0xF).astype(np.int8)
        hi = ((raw >> 4) & 0xF).astype(np.int8)
        lo = np.where(lo >= 8, lo - 16, lo).astype(np.int32)
        hi = np.where(hi >= 8, hi - 16, hi).astype(np.int32)
        out = np.empty(raw.size * 2, dtype=np.int32)
        out[0::2] = lo
        out[1::2] = hi
        return out
    raise ValueError(dtype)

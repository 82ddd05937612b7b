"""Heterogeneous memory-device populations as first-class spec families.

CXLRAMSim's observation (PAPERS.md) is that real deployments mix memory
populations — on-device LPDDR in phones, faster server parts, and
CXL-attached expanders with extra link latency — and co-evaluation only
means something against the *fleet*, not one golden device.  The
spec-vectorized facade makes that cheap here: each family below is just
a frozen :class:`~repro_torch.core.timing.SystemSpec` variant, so a
whole mixed population resolves in ONE ``run_many`` engine call
(heterogeneous ``TimingCycles`` ride the fleet axis as rows of the
packed timing tensor).

All families share the default bank geometry (4 bankgroups x 4 banks)
on purpose: the lane resolver has one kernel instantiation per bank
count, so the whole fleet shares one launch and the comparison measures
*timing* differences only.
"""
from __future__ import annotations

from repro_torch.core.timing import (DEFAULT_SYSTEM, LpddrTimings,
                                     PimSpec, SystemSpec)

# Phone-class LP5X: a 6400 MT/s bin on half the channels, slower core
# timings and a slower PIM MAC — the on-device regime the paper's
# motivating use case (local LLM decode) actually ships on.
PHONE_LP5X = SystemSpec(
    timings=LpddrTimings(data_rate_mtps=6400, tRCD=21.0, tRP=21.0,
                         tRAS=48.0, tRC=70.0, tRL=18.0),
    pim=PimSpec(mac_interval_ck=4),
    num_channels=2,
)

# Server-class LP5X: the default 9600 MT/s four-channel part.
SERVER_LP5X = DEFAULT_SYSTEM

# Server fast-bin: tightened core timings, faster PIM MAC cadence —
# the upper envelope of the same silicon.
SERVER_LP5X_FAST = SystemSpec(
    timings=LpddrTimings(tRCD=15.0, tRP=15.0, tRAS=36.0, tRC=52.0),
    pim=PimSpec(mac_interval_ck=2),
)

# CXL-expander-like profile: default media behind an expander link —
# extra read latency on every access and a much costlier mode fence
# (the mode-switch handshake crosses the link), per CXLRAMSim.
CXL_EXPANDER = SystemSpec(
    timings=LpddrTimings(tRL=27.0, tRCD=24.0, tRP=24.0),
    fence_ns=450.0,
)

SPEC_FAMILIES = {
    "phone-lp5x": PHONE_LP5X,
    "server-lp5x": SERVER_LP5X,
    "server-lp5x-fast": SERVER_LP5X_FAST,
    "cxl-expander": CXL_EXPANDER,
}


def family_specs() -> list:
    """(name, SystemSpec) pairs in deterministic report order."""
    return list(SPEC_FAMILIES.items())

"""The lane scan's share of its roofline: the least time its launches could
take, the bytes they need (``peaks.lane_scan_bytes``: every true command,
timing row, length and total read or written once) over the card's
3.35e12 B/s, over their CUDA-event time.  The scan runs no tensor-core
operation and no published int32 peak is at hand, so bytes bound it."""
from bench import peaks

UNIT = "%"
LAYER = "kernels.lane_scan"


def read(obs: dict):
    if not obs.get("kernel_s") or not obs.get("lane_bytes"):
        return None
    return 100.0 * obs["lane_bytes"] / peaks.HBM_BYTES_PER_S / obs["kernel_s"]

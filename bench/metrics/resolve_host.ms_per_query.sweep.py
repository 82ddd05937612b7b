"""Host milliseconds of ``engine.resolve_lanes`` per query: its wall (dedupe,
LRU, packing, copies, launch, read-back) less the lane-scan kernel's
CUDA-event time."""
UNIT = "ms/query"
LAYER = "core.engine"


def read(obs: dict):
    if "resolve_s" not in obs or "kernel_s" not in obs or not obs["queries"]:
        return None
    return (obs["resolve_s"] - obs["kernel_s"]) * 1e3 / obs["queries"]

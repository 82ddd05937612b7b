"""Share of the profiled serving steps during which no operation ran on the
card (``torch.profiler``)."""
UNIT = "ratio"
LAYER = "device"


def read(obs: dict):
    if not obs.get("profiled_s") or "tokens" not in obs:
        return None
    return 1.0 - obs["busy_s"] / obs["profiled_s"]

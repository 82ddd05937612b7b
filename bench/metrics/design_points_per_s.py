"""Design points priced per second of host wall: every point of every
query the window completed (specs x sites x {PIM, host}), over the whole
window."""
UNIT = "points/s"
LAYER = "serving.offload"


def read(obs: dict):
    if not obs.get("window_s") or "points" not in obs:
        return None
    return obs["points"] / obs["window_s"]

"""Lane-scan nanoseconds per command of each launch's longest lane (the
serial chain that sets its time): kernel time over those commands, both
summed over the window's launches."""
UNIT = "ns/step"
LAYER = "kernels.lane_scan"


def read(obs: dict):
    if not obs.get("kernel_s") or not obs.get("longest_commands"):
        return None
    return obs["kernel_s"] * 1e9 / obs["longest_commands"]

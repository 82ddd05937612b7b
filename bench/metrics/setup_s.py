"""Set-up seconds: process start to the window's start (imports, the
kernel library's load or first build, weights, warm-up)."""
UNIT = "s"
LAYER = "entry"


def read(obs: dict):
    return obs.get("setup_s")

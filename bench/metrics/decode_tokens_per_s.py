"""Tokens generated per second: every token the engine produced in the
window (prefills inside it included), over the whole window."""
UNIT = "tokens/s"
LAYER = "serving.engine"


def read(obs: dict):
    if not obs.get("window_s") or "tokens" not in obs:
        return None
    return obs["tokens"] / obs["window_s"]

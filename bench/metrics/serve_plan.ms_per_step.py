"""Milliseconds per decode step in the offload controller's ``observe``
and the planner's per-step ``decode_speedup`` telemetry."""
UNIT = "ms/step"
LAYER = "serving.policy"


def read(obs: dict):
    if "plan_s" not in obs or not obs.get("steps"):
        return None
    return obs["plan_s"] * 1e3 / obs["steps"]

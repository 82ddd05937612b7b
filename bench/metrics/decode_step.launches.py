"""Kernel launches per decode step in the profiled steps
(``torch.profiler``'s launch calls)."""
UNIT = "launches/step"
LAYER = "models.model"


def read(obs: dict):
    if not obs.get("profiled_steps"):
        return None
    return obs["profiled_launches"] / obs["profiled_steps"]

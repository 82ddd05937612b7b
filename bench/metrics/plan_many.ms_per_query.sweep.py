"""Milliseconds of ``PimExecutor.plan_many`` (layouts, IRF programs and
command streams, in numpy on the host) per design-point query."""
UNIT = "ms/query"
LAYER = "pimkernel.executor"


def read(obs: dict):
    if "plan_many_s" not in obs or "points" not in obs or not obs["queries"]:
        return None
    return obs["plan_many_s"] * 1e3 / obs["queries"]

"""The benchmark's only door into the program (``repro_torch``): its
configuration and spec types built from the benchmark's plain data, the
kernel library's build, and device syncs."""
from __future__ import annotations

import dataclasses

import torch


def arch(config: dict):
    """The program's ``ArchConfig`` from a configuration file."""
    from repro_torch.configs.base import ArchConfig, MoeConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in config.items() if k in names}
    if kw.get("moe"):
        kw["moe"] = MoeConfig(**kw["moe"])
    return ArchConfig(**kw)


def spec(d: dict):
    """The program's ``SystemSpec`` from a spec dict of the traffic."""
    from repro_torch.core.timing import spec_from_dict

    d = dict(d)
    d.setdefault("timings", {})
    d.setdefault("pim", {})
    return spec_from_dict(d)


def build(run) -> None:
    """Start from an empty lane LRU, and build (first run of a checkout)
    or load the kernel library from the fixed directory
    ``bench/_build/nvcc`` of the checkout."""
    from repro_torch.core import engine

    engine.lane_cache_reset()
    if run.device.type != "cuda":
        return
    from repro_torch.kernels import build as kbuild

    kbuild.configure_build_dir(run.root / "bench" / "_build" / "nvcc")
    kbuild.load_library()
    run.obs["nvcc_s"] = kbuild.BUILD_INFO["seconds"]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0

"""Production meshes and the lane mesh.

``make_production_mesh`` is a FUNCTION (not a module constant), and it
runs inside :func:`fake_process_group`, so importing this module never
touches a process group.  The production meshes are built over a fake
512-rank group (``torch.testing``'s ``FakeStore``, backend ``"fake"``):
their collectives move no data, and tensors on them are traced with fake
tensors, never run.

Single pod: (16, 16) = 256 ranks, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model); the pod
axis composes with data for batch sharding, so only the gradient
all-reduce (training) crosses the inter-pod links.

The lane mesh (:func:`make_lane_mesh`) is something else: a 1-D list of
torch devices the engine's lane resolution shards over
(``core/engine.py``), on real devices.
"""
from __future__ import annotations

import contextlib

import torch

# Perf knob: alternate factorization of the same chips, e.g. (64, 4)
# for small-model training where 16-way TP over-pays in activation
# all-reduces.  None = the production shapes.
MESH_OVERRIDE = None

FAKE_WORLD = 512


@contextlib.contextmanager
def fake_process_group(world_size: int = FAKE_WORLD, rank: int = 0):
    """A fake ``world_size``-rank default process group for the block,
    destroyed on exit (also on an exception).  Refuses to run when a
    process group already exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(device_type: str, shape, names):
    """A ``DeviceMesh`` over ranks ``0 .. prod(shape) - 1`` of the current
    group, from an explicit rank tensor (no device is set per rank)."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for d in shape:
        n *= d
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the current (fake) group:
    (16, 16) ("data", "model") over ranks 0-255, or (2, 16, 16) ("pod",
    "data", "model") over 0-511; ``MESH_OVERRIDE`` refactors the single
    pod.  Run it inside :func:`fake_process_group`."""
    if MESH_OVERRIDE is not None and not multi_pod:
        return _device_mesh(device_type, MESH_OVERRIDE, ("data", "model"))
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device_type, shape, axes)


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes of a mesh (pod composes with data)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data"))


def make_host_mesh(model: int = 1, device_type: str = "cpu"):
    """(world // model, model) ("data", "model") ``DeviceMesh`` over the
    current process group (tests, examples)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    return _device_mesh(device_type, (n // model, model), ("data", "model"))


def make_lane_mesh(n: int | None = None, devices=None):
    """A 1-D lane mesh of ``n`` devices for the engine's lane resolution
    (``engine.configure_lane_mesh``), taken from ``devices`` (default:
    the visible CUDA devices; a device may repeat, as ``["cuda:0"] * 4``
    does, the way the JAX package forces host devices).  ``n=None``
    takes them all."""
    from repro_torch.core.engine import build_lane_mesh, visible_devices
    devs = visible_devices() if devices is None else list(devices)
    return build_lane_mesh(len(devs) if n is None else n, devs)

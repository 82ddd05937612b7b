"""Atomic, async checkpointing in the JAX package's layout.

Layout: one directory per step::

    ckpt_dir/step_00000120/
        manifest.json     # leaf names, shapes, dtypes, step, extra
        <leaf-path>.npy   # one file per tree leaf

Leaf names are the reference's (``jax.tree`` key paths joined by
``__``: dict keys sorted, ``AdamWState`` fields as ``.step`` / ``.m`` /
``.v``), so a checkpoint either package writes restores into the other.

Guarantees:
  * atomic: written to step_xxx.tmp, fsync'd, then renamed — a crash
    mid-save never corrupts the latest checkpoint (restart-safe);
  * async: ``AsyncCheckpointer.save`` copies the tree to host memory on
    the training thread and writes it on a background thread;
  * restore onto a device: ``restore(..., device=)`` places each leaf on
    ``device`` (default: the device of the matching leaf of
    ``tree_like``);
  * elastic restore: ``restore(..., shardings=)`` takes the *target*
    layout, ``(DeviceMesh, placements)`` per leaf, so a checkpoint
    written on one mesh restores onto another.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

from .optimizer import tree_flatten_with_path, tree_map, tree_unflatten


def _leaf_paths(tree) -> list[str]:
    return ["__".join(path) for path, _ in tree_flatten_with_path(tree)]


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (never a view of a live CPU tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save(ckpt_dir, step: int, tree, extra: dict | None = None) -> str:
    """Synchronous atomic save."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for path, leaf in tree_flatten_with_path(tree):
        name = "__".join(path)
        arr = _to_numpy(leaf)
        np.save(tmp / f"{name}.npy", arr)
        manifest["leaves"].append(
            dict(name=name, shape=list(arr.shape), dtype=str(arr.dtype)))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    fd = os.open(tmp, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir, tree_like, step: int | None = None,
            shardings=None, device=None) -> tuple:
    """Load into the structure of ``tree_like`` (tensors, or anything
    with ``.shape``); each leaf goes to ``device``, or else to its
    ``tree_like`` leaf's device (the CPU for a leaf that is no tensor).
    ``shardings``: a tree like ``tree_like`` of ``(DeviceMesh,
    placements)`` pairs (or ``sharding.NamedSharding`` objects), or one pair
    for every leaf; each leaf is then placed with ``distribute_tensor``
    on its mesh's device type.  Returns ``(tree, manifest)``."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = []
    for path, ref in tree_flatten_with_path(tree_like):
        name = "__".join(path)
        arr = np.load(d / f"{name}.npy")
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"{name}: ckpt {arr.shape} vs model "
                             f"{tuple(ref.shape)}")
        if shardings is not None:
            out.append(place_sharded(torch.from_numpy(arr),
                                     _at_path(shardings, path)))
            continue
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        out.append(torch.from_numpy(arr).to(dev))
    return tree_unflatten(tree_like, out), manifest


def _is_sharding(x) -> bool:
    return callable(getattr(x, "placements", None)) or (
        isinstance(x, tuple) and len(x) == 2
        and hasattr(x[0], "mesh_dim_names"))


def _at_path(shardings, path):
    """The sharding of the leaf at ``path`` (a key path of
    ``tree_flatten_with_path``) in a tree of shardings, or the one
    sharding given for every leaf."""
    node = shardings
    for key in path:
        if _is_sharding(node):
            break
        if key.startswith("."):
            node = getattr(node, key[1:])
        elif isinstance(node, dict):
            node = node[key]
        else:
            node = node[int(key)]
    return node


def place_sharded(t: torch.Tensor, sharding):
    """``t`` as a DTensor: ``sharding`` is ``(DeviceMesh, placements)`` or
    a ``sharding.NamedSharding``."""
    from torch.distributed.tensor import distribute_tensor
    if callable(getattr(sharding, "placements", None)):
        mesh, placements = sharding.mesh, sharding.placements()
    else:
        mesh, placements = sharding
    return distribute_tensor(t.to(mesh.device_type), mesh, placements)


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        host_tree = tree_map(_to_numpy, tree)  # snapshot (sync point)

        def work():
            save(self.ckpt_dir, step, host_tree, extra)
            self.last_saved = step
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(p for p in self.ckpt_dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for p in steps[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)

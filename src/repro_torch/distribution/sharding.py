"""Logical-axis sharding rules (per arch x shape-kind x mesh).

Parameters carry *logical* axis names (``models.model.param_logical``);
this module maps them to mesh pspecs with divisibility-checked greedy
assignment (a mesh axis is used at most once per leaf; dims whose size
does not divide the axis fall back to replication).  The rules and their
byte arithmetic are the JAX package's, exactly.

A pspec is a tuple with one entry per tensor dim: ``None``
(replicated), a mesh axis name (``"model"``) or a tuple of axis names
(``("pod", "data")``).  :func:`to_placements` turns one into DTensor
placements over a ``DeviceMesh``; :func:`distribute` places a tree.

Policy:
  * tensor-parallel axes (vocab / heads / kv_heads / mlp / experts) -> "model"
  * FSDP: "embed" -> "data" for archs >= ``FSDP_THRESHOLD`` params, so the
    72B/132B train states fit; small archs replicate over data.
  * batch -> ("pod", "data"); pods are pure DP (only grad all-reduce
    crosses pod links).
  * decode caches: batch -> data when divisible, else sequence -> (data,
    model) (sequence parallelism for long_500k).

A mesh here is anything with axis sizes: a :class:`MeshShape` (rule
math without devices) or a ``torch.distributed`` ``DeviceMesh`` with
named dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import data_axes
from repro_torch.models import model as M

FSDP_THRESHOLD = 5_000_000_000

# Perf knob: when True, decode/prefill cells shard params TP-only (no
# FSDP over "data") — weight-stationary serving kills the per-step
# parameter all-gathers at the cost of 16x param memory per device.
SERVE_TP_ONLY = False


class MeshShape:
    """Axis-size view of a mesh (rule math without device state)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    @property
    def size(self):
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The axis sizes of a ``MeshShape`` or a named ``DeviceMesh``."""
        if isinstance(mesh, MeshShape):
            return mesh
        names = getattr(mesh, "mesh_dim_names", None)
        if names is not None:
            return cls(dict(zip(names, mesh.shape)))
        return cls(mesh.shape)


class NamedSharding(NamedTuple):
    """A pspec on a mesh (the JAX package's ``NamedSharding``)."""

    mesh: object
    spec: tuple

    def placements(self):
        return to_placements(self.spec, self.mesh)


def to_placements(pspec, mesh) -> list:
    """DTensor placements of ``pspec`` over a named ``DeviceMesh``:
    ``Shard(d)`` on every mesh dim that names tensor dim ``d``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, ax in enumerate(tuple(pspec)):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(s, (str, type(None)))
                                        for s in x)


def leaves_with_paths(tree, is_leaf=lambda x: False, path=()):
    """``[(path, leaf)]`` of a nested dict / tuple tree in ``jax.tree``'s
    order (dict keys sorted), so two trees zip as the JAX package's
    ``jax.tree.leaves`` pairs them."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return [pl for k in sorted(tree)
                    for pl in leaves_with_paths(tree[k], is_leaf,
                                                path + (k,))]
        if isinstance(tree, (tuple, list)):
            return [pl for i, v in enumerate(tree)
                    for pl in leaves_with_paths(v, is_leaf, path + (i,))]
        if tree is None:
            return []
    return [(path, tree)]


def _map_like(tree, fn, path=()):
    """``tree`` with each tensor leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_like(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_like(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tp_rules(cfg: ArchConfig, mesh, kind: str = "train") -> dict:
    """logical axis -> mesh axis (or None)."""
    msize = MeshShape.of(mesh).shape["model"]
    fsdp = cfg.param_count() >= FSDP_THRESHOLD
    if SERVE_TP_ONLY and kind in ("decode", "prefill"):
        fsdp = False
    rules = {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": None,
        "embed": "data" if fsdp else None,
        "embed2": None,
        "ssm_inner": None,
        "ssm_heads": None,
        "layers": None,
    }
    if cfg.moe and cfg.moe.n_experts % msize == 0:
        rules["experts"] = "model"
        rules["mlp"] = None          # expert dim claims the model axis
    return rules


def _leaf_pspec(logical: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    sizes = MeshShape.of(mesh).shape
    spec = []
    used = set()
    for name, dim in zip(logical, shape):
        axis = rules.get(name)
        if axis is not None and axis not in used and \
                dim % sizes[axis] == 0:
            spec.append(axis)
            used.add(axis)
        else:
            spec.append(None)
    return tuple(spec)


def _param_pairs(cfg: ArchConfig, dtype=torch.bfloat16):
    """``[(path, logical axes, meta spec)]`` of every parameter leaf,
    zipped in ``jax.tree`` order as the JAX package zips them."""
    from repro_torch.models.quant import quantize_logical
    logical = M.param_logical(cfg)
    if M.QUANT_BITS:
        logical = quantize_logical(logical)
    flat_l = leaves_with_paths(logical, _is_logical)
    flat_s = leaves_with_paths(M.param_specs(cfg, dtype))
    return [(path, log, spec)
            for (_lp, log), (path, spec) in zip(flat_l, flat_s)]


def param_shardings(cfg: ArchConfig, mesh, kind: str = "train"):
    """:class:`NamedSharding` tree matching ``model.param_specs(cfg)``."""
    rules = tp_rules(cfg, mesh, kind)
    by_path = {path: NamedSharding(mesh, _leaf_pspec(tuple(log), spec.shape,
                                                     rules, mesh))
               for path, log, spec in _param_pairs(cfg)}
    return _map_like(M.param_specs(cfg), lambda path, _s: by_path[path])


def _batch_dim_axes(mesh, n: int):
    """Sharding for a global-batch dim of size n (prefers pod+data)."""
    sizes = MeshShape.of(mesh).shape
    dax = data_axes(mesh)
    total = 1
    for a in dax:
        total *= sizes[a]
    if n % total == 0:
        return dax if len(dax) > 1 else dax[0]
    if n % sizes["data"] == 0:
        return "data"
    return None


def cache_shardings(cfg: ArchConfig, mesh, shape: ShapeConfig):
    """Sharding tree for the KV/SSM cache of a decode/prefill cell."""
    sizes = MeshShape.of(mesh).shape
    b = shape.global_batch
    batch_ax = _batch_dim_axes(mesh, b)

    def kv_spec(leaf_shape):
        # (L, B, S, kv, hd)
        _, _, s, _kv, _hd = leaf_shape
        used = {a for a in (batch_ax if isinstance(batch_ax, tuple)
                            else (batch_ax,)) if a}
        seq_ax = None
        if batch_ax is None:
            if s % (sizes["data"] * sizes["model"]) == 0:
                seq_ax = ("data", "model")
        elif "model" not in used and s % sizes["model"] == 0:
            seq_ax = "model"
        return (None, batch_ax, seq_ax, None, None)

    def ssm_spec(leaf_shape):
        # (L, B, nh, p, n)
        _, _, nh, p, _n = leaf_shape
        if nh % sizes["model"] == 0:
            return (None, batch_ax, "model", None, None)
        if p % sizes["model"] == 0:
            return (None, batch_ax, None, "model", None)
        return (None, batch_ax, None, None, None)

    cache_spec = M.init_cache(cfg, b, shape.seq_len, torch.bfloat16,
                              device="meta")
    out = {}
    if "kv" in cache_spec:
        out["kv"] = tuple(NamedSharding(mesh, kv_spec(tuple(leaf.shape)))
                          for leaf in cache_spec["kv"])
        if "kv_scale" in cache_spec:
            out["kv_scale"] = tuple(
                NamedSharding(mesh, (None, batch_ax, None, None, None))
                for _ in cache_spec["kv_scale"])
    if "ssm" in cache_spec:
        out["ssm"] = NamedSharding(mesh,
                                   ssm_spec(tuple(cache_spec["ssm"].shape)))
        out["conv"] = NamedSharding(mesh, (None, batch_ax, None, None))
    return out


def _shard_bytes(shape, pspec, mesh) -> int:
    sizes = MeshShape.of(mesh).shape
    n = 1
    for d in shape:
        n *= d
    denom = 1
    for ax in tuple(pspec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            denom *= sizes[a]
    return n // denom


def state_bytes_per_device(cfg: ArchConfig, shape: ShapeConfig,
                           mesh=None, with_opt: bool | None = None
                           ) -> dict:
    """Exact per-device byte footprint of params / opt / cache under the
    sharding rules (drives the memory roofline term and fit checks)."""
    mesh = MeshShape.of(mesh) if mesh is not None else \
        MeshShape({"data": 16, "model": 16})
    rules = tp_rules(cfg, mesh, shape.kind)
    params = 0
    for _path, log, spec in _param_pairs(cfg):
        ps = _leaf_pspec(tuple(log), tuple(spec.shape), rules, mesh)
        params += _shard_bytes(spec.shape, ps, mesh) * spec.element_size()
    out = dict(params=params)
    if with_opt if with_opt is not None else shape.kind == "train":
        out["opt"] = params * 4          # m, v in f32
        out["grads"] = params
    if shape.kind != "train":
        b = shape.global_batch
        cache_specs = M.init_cache(cfg, b, shape.seq_len, torch.bfloat16,
                                   device="meta")
        batch_ax = _batch_dim_axes(mesh, b)
        cache = 0
        if "kv" in cache_specs:
            for leaf in cache_specs["kv"]:
                denom = 1
                used = {a for a in ((batch_ax,) if not isinstance(
                    batch_ax, tuple) else batch_ax) if a}
                if batch_ax is not None:
                    for a in used:
                        denom *= mesh.shape[a]
                s = leaf.shape[2]
                if batch_ax is None and s % (mesh.shape["data"]
                                             * mesh.shape["model"]) == 0:
                    denom *= mesh.shape["data"] * mesh.shape["model"]
                elif "model" not in used and s % mesh.shape["model"] == 0:
                    denom *= mesh.shape["model"]
                cache += leaf.numel() * leaf.element_size() // denom
        for key in ("ssm", "conv"):
            if key in cache_specs:
                leaf = cache_specs[key]
                denom = mesh.shape["data"] if b % mesh.shape["data"] == 0 \
                    else 1
                itemsize = 4 if key == "ssm" else 2
                cache += leaf.numel() * itemsize // denom
        out["cache"] = cache
    out["total"] = sum(out.values())
    return out


def input_shardings(cfg: ArchConfig, mesh, shape: ShapeConfig) -> dict:
    """Shardings matching ``model.input_specs(cfg, shape)``."""
    b = shape.global_batch
    batch_ax = _batch_dim_axes(mesh, b)
    bspec2 = NamedSharding(mesh, (batch_ax, None))
    bspec3 = NamedSharding(mesh, (batch_ax, None, None))
    out: dict = {}
    if shape.kind == "train":
        if cfg.input_mode == "embeddings":
            batch = {"embeds": bspec3, "labels": bspec2}
        else:
            batch = {"tokens": bspec2, "labels": bspec2}
            if cfg.prefix_patches:
                batch["patches"] = bspec3
        out["batch"] = batch
    elif shape.kind == "prefill":
        if cfg.input_mode == "embeddings":
            out["batch"] = {"embeds": bspec3}
        else:
            out["batch"] = {"tokens": bspec2}
            if cfg.prefix_patches:
                out["batch"]["patches"] = bspec3
        out["cache"] = cache_shardings(cfg, mesh, shape)
    else:
        out["token"] = bspec3 if cfg.input_mode == "embeddings" else bspec2
        out["pos"] = NamedSharding(mesh, ())
        out["cache"] = cache_shardings(cfg, mesh, shape)
    return out


def distribute(specs, shardings, device=None):
    """Fake DTensors for a tree of ``meta`` specs under a matching tree of
    :class:`NamedSharding`\\ s on a ``DeviceMesh``: each leaf is an empty
    tensor of its spec's global shape and dtype on ``device`` (the mesh's
    device type by default), placed with ``distribute_tensor`` without
    moving data (``src_data_rank=None``).  Call under a
    ``FakeTensorMode``: nothing is allocated."""
    from torch.distributed.tensor import distribute_tensor

    def place(path, spec):
        sh = _get(shardings, path)
        dev = device or sh.mesh.device_type
        t = torch.empty(tuple(spec.shape), dtype=spec.dtype, device=dev)
        return distribute_tensor(t, sh.mesh, sh.placements(),
                                 src_data_rank=None)
    return _map_like(specs, place)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree

"""AdamW + gradient clipping + LR schedules, written out (no torch.optim).

The formulas are the JAX package's, op for op, in float32 tensors on the
parameters' device: ``b1 ** step`` is a float32 power of a tensor (Python's
float64 pow is an ulp off jnp's), and no tensor is divided by a Python
scalar (CUDA divides by a scalar through its reciprocal, an ulp off true
division).  ``torch.optim.AdamW`` places the bias correction and the
weight decay differently, so it would not hold to the reference.

Trees are the models' nested dicts (and tuples / :class:`AdamWState`).
They flatten with dict keys sorted, as ``jax.tree`` flattens them, so
sums over leaves run in the reference's order and checkpoint leaf names
match its names.  The update runs in place on the parameters and
moments, the counterpart of the reference's donated buffers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

PyTree = Any


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor      # int32 scalar on the parameters' device
    m: PyTree
    v: PyTree


# ---------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------

def tree_flatten_with_path(tree, path: tuple = ()) -> list:
    """``[(key path, leaf)]`` in ``jax.tree`` order: dict keys sorted,
    sequence items by index, :class:`AdamWState` fields in field order
    as ``.step`` / ``.m`` / ``.v``."""
    if isinstance(tree, AdamWState):
        return [kv for f in dataclasses.fields(tree)
                for kv in tree_flatten_with_path(getattr(tree, f.name),
                                                 (*path, "." + f.name))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k], (*path, str(k)))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_path(v, (*path, str(i)))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves) -> PyTree:
    """``leaves`` (in :func:`tree_leaves` order) in the structure of
    ``like``; dicts keep ``like``'s key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, AdamWState):
            return AdamWState(**{f.name: build(getattr(t, f.name))
                                 for f in dataclasses.fields(t)})
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest) -> PyTree:
    leaves = [fn(*xs) for xs in zip(tree_leaves(tree),
                                     *(tree_leaves(r) for r in rest))]
    return tree_unflatten(tree, leaves)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------

def adamw_init(params: PyTree) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=tree_map(torch.clone, zeros))


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(
        _scalar(max_norm, norm) / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, state: AdamWState,
                 lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0):
    """One AdamW step, written into ``params``, ``state.m`` and
    ``state.v`` in place; returns ``(params, AdamWState)`` (the same
    parameter and moment tensors, a new step)."""
    grads, _gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(_scalar(b1, stepf), stepf)
    b2c = 1.0 - torch.pow(_scalar(b2, stepf), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        del g
        mh = m / b1c
        delta = torch.sqrt(v / b2c).add_(eps)
        delta = torch.div(mh, delta, out=mh)
        p32 = p.float()
        delta.add_(p32 * weight_decay)
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 (so step 0's lr is 0), then a cosine decay to
    ``min_frac * base_lr``; a float32 scalar on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = (base_lr * step) / _scalar(max(warmup, 1), step)
    t = torch.clamp((step - warmup) / _scalar(max(total - warmup, 1), step),
                    0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)

"""Gradient compression with error feedback.

Two composable schemes; the residual of the lossy step is carried and
added to the next gradient, preserving convergence:

* int8 quantization (4x over f32 / 2x over bf16): per-leaf absmax scale.
* top-k sparsification: keep the k largest-magnitude entries per leaf.

The int8 round trip is bit-equal to the JAX package's: the scale divides
by a tensor on the gradient's device (CUDA divides by a Python scalar
through its reciprocal), and ``torch.round`` rounds half to even as
``jnp.round`` does.  The trainer applies compress -> reduce ->
decompress inside the step; with one device the reduction is the
identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .optimizer import tree_leaves, tree_map, tree_unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "int8"      # none | int8 | topk | int8+topk
    topk_frac: float = 0.01


def init_error_state(grads: PyTree) -> PyTree:
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def quantize_int8(g: torch.Tensor):
    absmax = torch.clamp_min(g.abs().max(), 1e-12)
    scale = absmax / torch.as_tensor(127.0, dtype=absmax.dtype,
                                     device=absmax.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1).abs()
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return (g.abs() >= thresh).to(g.dtype)


def compress_decompress(g: torch.Tensor,
                        cfg: CompressionConfig) -> torch.Tensor:
    """The lossy channel a gradient leaf passes through (round trip)."""
    out = g.float()
    if "topk" in cfg.scheme:
        out = out * topk_mask(out, cfg.topk_frac)
    if "int8" in cfg.scheme:
        q, s = quantize_int8(out)
        out = dequantize_int8(q, s)
    return out


@torch.no_grad()
def apply_with_error_feedback(grads: PyTree, err: PyTree,
                              cfg: CompressionConfig,
                              reduce_fn=None) -> tuple[PyTree, PyTree]:
    """grads -> (compressed+reduced grads, new error state).

    The new error state is written into ``err``'s tensors in place, and
    what is sent into float32 gradient leaves (the counterpart of the
    reference's donated buffers); ``reduce_fn`` is the reduction applied
    in compressed space, identity by default.
    """
    if cfg.scheme == "none":
        if reduce_fn is not None:
            grads = tree_map(reduce_fn, grads)
        return grads, err

    sent_leaves = []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        g = g.float().add_(e)
        sent = compress_decompress(g, cfg)
        torch.sub(g, sent, out=e)
        sent = g.copy_(sent)
        if reduce_fn is not None:
            sent = reduce_fn(sent)
        sent_leaves.append(sent)
    return tree_unflatten(grads, sent_leaves), err


def compression_ratio(cfg: CompressionConfig) -> float:
    r = 1.0
    if "topk" in cfg.scheme:
        r *= cfg.topk_frac * 2  # indices + values
    if "int8" in cfg.scheme:
        r *= 0.25
    return min(r, 1.0)

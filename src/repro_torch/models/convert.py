"""Carry weights between the JAX package and the port.

Both packages use one parameter tree: nested dicts, per-layer leaves
stacked on a leading L axis, quantized leaves as ``{"q", "s"}`` bundles.
:func:`params_from_numpy` turns that tree as numpy arrays (the JAX
package's params after ``np.asarray`` on every leaf) into the port's
tensors on a device; :func:`params_to_numpy` is the inverse.  bfloat16
arrays (numpy's ``bfloat16`` extension dtype) cross as their 16-bit
patterns, so no extension module is needed here.

:func:`draw_numpy_params` draws a model's weights as float32 numpy
arrays from ``np.random.default_rng(seed)`` in the tree and scales of
``init_params``: the weights a fixture writer and the card can both
redraw from one seed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from . import layers as L
from . import model as M


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device=None):
    """A nested dict / tuple / list of numpy arrays -> the same tree of
    tensors on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return _to_tensor(x, dev)

    return walk(tree)


def params_to_numpy(tree):
    """The port's tree of tensors -> numpy arrays on the host (bfloat16
    leaves widen to float32, which holds them exactly)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()      # never a view of a live tensor


def draw_numpy_params(cfg, seed: int) -> dict:
    """``cfg``'s parameters as float32 numpy arrays drawn from
    ``np.random.default_rng(seed)``, leaf by leaf in ``init_params``'s
    order, each normal leaf scaled as ``init_params`` scales it."""
    return M.init_params(cfg, L.NumpyDraw(np.random.default_rng(seed)))

"""Weight quantization for serving (the paper's W8/W4 formats).

``quantize_params`` transforms an f32/bf16 parameter tree: every large
matmul leaf becomes ``{"q": int8[...], "s": f32[..., 1, out]}``
(symmetric, per output channel; W4 packs two rows' nibbles per byte) and
the models dequantize on use.  The ``q`` and ``s`` leaves are bit-equal
to the JAX package's: round half to even, scales by true division.
"""
from __future__ import annotations

import torch

from . import layers as L

# parameter names that get quantized (2D+ matmul weights)
QUANT_KEYS = {"embed", "lm_head", "patch_proj", "wq", "wk", "wv", "wo",
              "wi", "wg", "in_proj", "out_proj"}


def is_bundle(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def _quantize_leaf(w, w_bits: int):
    w = w.float()
    qmax = 2 ** (w_bits - 1) - 1
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = amax / torch.tensor(float(qmax), device=w.device)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    if w_bits == 4:
        # nibbles packed in a wider type, then wrapped back to int8
        lo = q[..., 0::2, :].to(torch.int32) & 0xF
        hi = q[..., 1::2, :].to(torch.int32) & 0xF
        q = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return {"q": q, "s": scale}


def _unpack4(q: torch.Tensor) -> torch.Tensor:
    """Packed int4 rows (..., R, C) -> int32 (..., 2R, C)."""
    q32 = q.to(torch.int32)
    lo = (q32 << 28) >> 28          # sign-extended low nibble
    hi = q32 >> 4
    return torch.stack([lo, hi], dim=-2).reshape(
        *q.shape[:-2], q.shape[-2] * 2, q.shape[-1])


def dequant_leaf(leaf, w_bits: int, dtype=torch.bfloat16):
    q = leaf["q"]
    if w_bits == 4:
        # a split of the packed rows is the same split of the unpacked
        q = L.LAYOUT.per_shard(_unpack4, q)
    return (q.float() * leaf["s"]).to(dtype)


def _walk(d, fn):
    out = {}
    for k, v in d.items():
        if is_bundle(v):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _walk(v, fn)
        else:
            out[k] = fn(k, v)
    return out


def quantize_params(params, w_bits: int = 8):
    """f32/bf16 param tree -> serving tree with quantized matmul leaves."""
    def fn(k, v):
        if k in QUANT_KEYS and isinstance(v, torch.Tensor) and \
                v.ndim >= 2 and v.shape[-2] % 2 == 0:
            return _quantize_leaf(v, w_bits)
        return v
    return _walk(params, fn)


def quantize_logical(logical):
    """Transform the logical-axis tree alongside :func:`quantize_params`:
    a bundle's ``s`` keeps the output axis (a size-1 dim before it)."""
    def fn(k, v):
        if k in QUANT_KEYS and isinstance(v, tuple) and len(v) >= 2:
            return {"q": v, "s": v[:-2] + (None, v[-1])}
        return v
    return _walk(logical, fn)


def dequant_tree(tree, w_bits: int = 8, dtype=torch.bfloat16):
    """Dequantize every {"q","s"} bundle in a (sub)tree on use."""
    if is_bundle(tree):
        return dequant_leaf(tree, w_bits, dtype)
    if isinstance(tree, dict):
        return {k: dequant_tree(v, w_bits, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(dequant_tree(v, w_bits, dtype) for v in tree)
    return tree

"""Core transformer layers as plain functions on tensors.

Everything here is shape-polymorphic over a leading batch and works in
three modes: training (full sequence), prefill (full sequence + returns KV
cache) and decode (single token against a cache).  Long sequences use a
blockwise streaming-softmax attention (loops over query / key blocks) so
long prefills never materialize S x S score tensors.

The masked-score value ``NEG_INF``, the float32 softmax and the f32 score
accumulation are part of the numbers: the same inputs give the JAX
package's results within float rounding.

Parameter initializers take a drawer (:class:`TorchDraw` or
:class:`NumpyDraw`, which carries the dtype and device) and draw every
per-layer leaf directly at its stacked shape (``lead``), so a model is
never held twice while it is built.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30

# Sequences longer than this use the blockwise streaming-softmax path.
FLASH_THRESHOLD = 2048

# Skip causal upper-triangle (q-block, k-block) pairs in the blockwise
# attention (only when the queries start at position 0).
FLASH_SKIP_BLOCKS = False


# ---------------------------------------------------------------------
# Drawing parameters
# ---------------------------------------------------------------------

class TorchDraw:
    """Draws leaves with a ``torch.Generator`` on its device."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32,
                 device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device) if device is not None \
            else generator.device

    def normal(self, shape, scale: float) -> torch.Tensor:
        out = torch.randn(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)
        return out.mul_(scale).to(self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype,
                           device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype,
                          device=self.device)

    def const(self, value: np.ndarray, lead=()) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(value, np.float32),
                            device=self.device).to(self.dtype)
        return t.expand(*lead, *t.shape).contiguous()


class NumpyDraw:
    """Draws the same tree as float32 numpy arrays from a numpy
    ``Generator``: the weights a fixture writer and the card redraw
    alike from one seed."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def normal(self, shape, scale: float) -> np.ndarray:
        out = self.rng.standard_normal(tuple(shape), dtype=np.float32)
        out *= np.float32(scale)
        return out

    def zeros(self, shape) -> np.ndarray:
        return np.zeros(tuple(shape), np.float32)

    def ones(self, shape) -> np.ndarray:
        return np.ones(tuple(shape), np.float32)

    def const(self, value: np.ndarray, lead=()) -> np.ndarray:
        value = np.asarray(value, np.float32)
        return np.ascontiguousarray(
            np.broadcast_to(value, (*lead, *value.shape)))


# ---------------------------------------------------------------------
# Norm, rotary embedding, matmul helper
# ---------------------------------------------------------------------

def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` with ``b`` a tensor on ``a``'s device: CUDA divides by a
    Python scalar through its reciprocal, an ulp off true division."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the operands promoted to one dtype, as jnp does."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


def rms_norm(x, gamma, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding.  x: (..., S, H, hd), positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(_div(-math.log(theta) * ar, half))
    angles = positions[..., None].float() * freqs   # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------

def _mask(qi, ki, window):
    m = ki[None, :] <= qi[:, None]
    if window is not None:
        m = m & ((qi[:, None] - ki[None, :]) < window)
    return m


def dense_attention(q, k, v, *, window=None, q_offset=0, kv_len=None):
    """Quadratic-path GQA attention (short sequences / decode).

    q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd).  ``q_offset`` is the
    absolute position of q[0] — scalar, or (B,) for ragged decode slots;
    ``kv_len`` (scalar or (B,)) masks the valid cache prefix when Sk is a
    padded cache.
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd))
    qo = torch.as_tensor(q_offset, device=dev)
    ar = torch.arange(sq, device=dev)
    qi = qo[:, None] + ar if qo.ndim == 1 else (qo + ar)[None]
    ki = torch.arange(sk, device=dev)
    mask = ki[None, None, :] <= qi[..., None]           # (B|1, sq, sk)
    if window is not None:
        mask = mask & ((qi[..., None] - ki[None, None, :]) < window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=dev)
        kl = kl[:, None, None] if kl.ndim == 1 else kl
        mask = mask & (ki[None, None, :] < kl)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, hq, hd)


def flash_attention(q, k, v, *, window=None, q_offset=0,
                    block_q: int = 512, block_k: int = 512):
    """Blockwise streaming-softmax attention (prefill / train on long S).

    Never materializes more than (B, Hkv, G, block_q, block_k) scores.
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    nq = -(-sq // bq)
    nk = -(-sk // bk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * bq - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * bk - sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * bk - sk))
    qb = qp.reshape(b, nq, bq, hkv, g, hd).permute(1, 0, 3, 4, 2, 5)
    kb = kp.reshape(b, nk, bk, hkv, hd).permute(1, 0, 3, 2, 4)
    vb = vp.reshape(b, nk, bk, hkv, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / math.sqrt(hd)

    def kv_scan(qblk, qi, n_blocks):
        m = torch.full((b, hkv, g, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, bq, hd), dtype=torch.float32,
                          device=dev)
        for ki_idx in range(n_blocks):
            kblk, vblk = kb[ki_idx], vb[ki_idx]
            ki = ki_idx * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bkgqd,bksd->bkgqs", qblk.float(),
                             kblk.float()) * scale
            msk = _mask(qi, ki, window) & (ki < sk)[None, :]
            s = torch.where(msk[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p.to(vblk.dtype), vblk)
            m = m_new
        return acc / torch.clamp_min(l, 1e-30)[..., None]

    outs = []
    for qi_idx in range(nq):
        if FLASH_SKIP_BLOCKS and isinstance(q_offset, int) and q_offset == 0:
            qi = qi_idx * bq + torch.arange(bq, device=dev)
            hi = min(nk, -(-((qi_idx + 1) * bq) // bk))
        else:
            qi = q_offset + qi_idx * bq + torch.arange(bq, device=dev)
            hi = nk
        outs.append(kv_scan(qb[qi_idx], qi, hi).to(q.dtype))
    ob = torch.stack(outs)                      # (nq, b, hkv, g, bq, hd)
    out = ob.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * bq, hq, hd)
    return out[:, :sq]


def attention(q, k, v, *, window=None, q_offset=0, kv_len=None,
              flash_threshold: int | None = None):
    if flash_threshold is None:
        flash_threshold = FLASH_THRESHOLD
    if q.shape[1] == 1 or k.shape[1] <= flash_threshold:
        return dense_attention(q, k, v, window=window, q_offset=q_offset,
                               kv_len=kv_len)
    assert kv_len is None, "flash path expects unpadded kv"
    return flash_attention(q, k, v, window=window, q_offset=q_offset)


# ---------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------

def mlp_apply(params, x, kind: str):
    if kind == "swiglu":
        h = F.silu(mm(x, params["wg"])) * mm(x, params["wi"])
    else:  # gelu (jax.nn.gelu's default: the tanh approximation)
        h = F.gelu(mm(x, params["wi"]), approximate="tanh")
    return mm(h, params["wo"])


def mlp_init(draw, d, ff, kind: str, lead=()):
    """``draw``: a drawer; ``lead``: leading (stacked-layer) dimensions
    of every leaf."""
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(ff)
    p = {"wi": draw.normal((*lead, d, ff), scale_in),
         "wo": draw.normal((*lead, ff, d), scale_out)}
    if kind == "swiglu":
        p["wg"] = draw.normal((*lead, d, ff), scale_in)
    return p

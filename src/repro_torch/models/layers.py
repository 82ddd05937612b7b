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
# Flash attention carries at most this many f32 scores a step: as many
# query blocks advance together as fit (256 MiB of scores); None: all.
FLASH_CHUNK_SCORES = 1 << 26

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


class MetaDraw:
    """Draws every leaf as a ``meta`` tensor: shapes and dtypes, no
    storage (the dry-run's parameter specs)."""

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype

    def normal(self, shape, scale: float) -> torch.Tensor:
        return self.zeros(shape)

    def zeros(self, shape) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=self.dtype, device="meta")

    ones = zeros

    def const(self, value: np.ndarray, lead=()) -> torch.Tensor:
        return self.zeros((*lead, *np.shape(value)))


# ---------------------------------------------------------------------
# Norm, rotary embedding, matmul helper
# ---------------------------------------------------------------------

def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` with ``b`` a tensor on ``a``'s device: CUDA divides by a
    Python scalar through its reciprocal, an ulp off true division."""
    return a / scalar_like(b, a)


_SCALARS: dict = {}


def scalar_like(value, like: torch.Tensor) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=like.dtype, device=like.device)``,
    built once per (value, dtype, device) and kept, so a step captured as
    a CUDA graph copies nothing from the host; fake and subclassed
    tensors (the dry-run's) get a fresh one."""
    if type(like) is not torch.Tensor:
        return torch.as_tensor(value, dtype=like.dtype, device=like.device)
    key = (value, like.dtype, like.device)
    out = _SCALARS.get(key)
    if out is None:
        with torch.inference_mode(False):
            out = torch.as_tensor(value, dtype=like.dtype, device=like.device)
        if type(out) is torch.Tensor:   # not made under a fake mode
            _SCALARS[key] = out
    return out


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the operands promoted to one dtype, as jnp does."""
    b = LAYOUT.weight(b, a)
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


# ---------------------------------------------------------------------
# Layout hooks
# ---------------------------------------------------------------------

class Layout:
    """The model's layout hooks: one call at each site where a step
    traced under a mesh must place its values (the JAX package leaves
    that to XLA's sharding propagation).  This class is the model on
    plain tensors: every hook is the plain op.
    ``distribution/layout.py``'s ``MeshLayout`` is the same hooks for
    DTensor operands, installed as :data:`LAYOUT` for a traced step."""

    def weight(self, w, x):
        """Weight ``w`` as a matmul with ``x`` uses it."""
        return w

    def residual(self, x, like=None):
        """The residual stream (``like``: the value it follows)."""
        return x

    def pin(self, x):
        """``x``, its gradient held to its layout."""
        return x

    def embed(self, table, ids):
        """``table[ids]``."""
        return table[ids]

    def split_heads(self, t, n_heads: int):
        """``t`` (..., H * hd) as (..., H, hd)."""
        return t.reshape(*t.shape[:-1], n_heads, t.shape[-1] // n_heads)

    def attention_heads(self, q, k, v):
        """q, k, v (B, S, H, hd) as attention takes them."""
        return q, k, v

    def attend(self, fn, q, k, v, **kw):
        """``fn(q, k, v, **kw)``: attention."""
        return fn(q, k, v, **kw)

    def cache_queries(self, q, k):
        """The queries as dense attention over cache ``k`` takes them."""
        return q

    def write_rows_(self, cache, pos, x):
        """``cache[r, pos[r]] = x[r, 0]`` for every row r, in place (the
        decode step's cache write; positions clamped into the cache as
        ``dynamic_update_slice`` clamps its start).  cache (B, S, ...),
        pos (B,), x (B, 1, ...)."""
        pos = torch.clamp(pos, 0, cache.shape[1] - 1).long()
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos] = x[:, 0].to(cache.dtype)

    def write_prefix_(self, cache, x):
        """``cache[:, :S] = x`` in place for x (B, S, ...) (the
        prefill's cache write)."""
        cache[:, :x.shape[1]] = x.to(cache.dtype)

    def nll_sum(self, logits, labels, mask):
        """Sum of the masked next-token negative log-likelihoods."""
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
        return (nll * mask).sum()

    def constrain(self, x, spec):
        """``x`` laid out as the pspec ``spec`` (a sharding constraint)."""
        return x

    def dispatch_buffer(self, xt, rows: int):
        """The zeroed (rows, d) MoE dispatch buffer for tokens ``xt``."""
        return torch.zeros((rows, xt.shape[1]), dtype=xt.dtype,
                           device=xt.device)

    def scatter_add(self, buf, idx, xt, spec=None):
        """``buf`` with ``xt``'s rows added at rows ``idx``, laid out as
        ``spec``."""
        buf.index_add_(0, idx, xt)
        return buf

    def take_rows(self, out_e, out_flat, idx):
        """``out_flat[idx]``, ``out_flat`` the (E * cap, d) view of the
        expert outputs ``out_e``."""
        return out_flat[idx]

    def cumsum(self, x, dim: int = -1):
        return torch.cumsum(x, dim)

    def ssm_readout(self, c, state):
        """The SSM decode readout: c (B, N), state (B, H, P, N) ->
        (B, H, P)."""
        return torch.einsum("bn,bhpn->bhp", c.float(), state)

    def per_shard(self, fn, x):
        """``fn(x)`` for an ``fn`` that maps each block of rows on its
        own."""
        return fn(x)


# The hooks in use; ``distribution.layout.mesh_layout()`` swaps them.
LAYOUT = Layout()


def rms_norm(x, gamma, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding.  x: (..., S, H, hd), positions: (..., S)."""
    half = x.shape[-1] // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(_div(-math.log(theta) * ar, half))
    return rope_rotate(x, positions, freqs)


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's magnitude correction ``0.1 * mscale * ln(scale) + 1`` (1 at
    ``scale <= 1``)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_frequencies(dim: int, theta: float, scaling=None, device=None):
    """The rotary embedding's ``dim // 2`` inverse frequencies (float32,
    on ``device``) and the factor its cos and sin take: plain
    ``theta ** (-2i / dim)`` and 1, or with ``scaling`` (a
    ``configs.base.RopeScaling``) YaRN's, as the published code
    computes them: interpolated by ``factor`` below ``beta_slow``
    rotations over the original context, kept above ``beta_fast``,
    ramped between the two (their dimensions floored and ceiled), and
    the factor ``mscale(factor, mscale) / mscale(factor,
    mscale_all_dim)``."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    pos_freqs = theta ** (ar / dim)
    extrapolated = 1.0 / pos_freqs
    if scaling is None:
        return extrapolated, 1.0
    f = scaling.factor
    base = scaling.original_max_position_embeddings

    def correction_dim(rotations: float) -> float:
        return (dim * math.log(base / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(scaling.beta_fast)), 0)
    high = min(math.ceil(correction_dim(scaling.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1 - ramp
    inv = 1.0 / (f * pos_freqs) * (1 - keep) + extrapolated * keep
    if scaling.mscale and scaling.mscale_all_dim:
        factor = (yarn_mscale(f, scaling.mscale)
                  / yarn_mscale(f, scaling.mscale_all_dim))
    else:
        factor = yarn_mscale(f)
    return inv, factor


def rope_rotate(x, positions, inv_freq, interleave: bool = False,
                factor: float = 1.0):
    """Rotary embedding by given inverse frequencies.  x: (..., S, H,
    hd), positions: (..., S).  ``interleave`` rotates the pairs (x[2i],
    x[2i+1]) and returns the rotated evens, then the rotated odds (the
    published ``rope_interleave`` layout: queries and keys alike, so
    their products are those of the pairs); otherwise the halves.  cos
    and sin are times ``factor``."""
    angles = positions[..., None].float() * inv_freq    # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if factor != 1.0:
        cos, sin = cos * factor, sin * factor
    if interleave:
        x1, x2 = x[..., 0::2], x[..., 1::2]
    else:
        x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------

def dense_attention(q, k, v, *, window=None, q_offset=0, kv_len=None,
                    scale=None):
    """Quadratic-path GQA attention (short sequences / decode).

    q, k: (B, Sq|Sk, Hq|Hkv, hd); v: (B, Sk, Hkv, dv), its width its own
    (the output's).  ``q_offset`` is the
    absolute position of q[0] — scalar, or (B,) for ragged decode slots;
    ``kv_len`` (scalar or (B,)) masks the valid cache prefix when Sk is a
    padded cache.  ``scale``: the scores' factor (None: 1/sqrt(hd)).
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    q = LAYOUT.cache_queries(q, k)
    qg = q.reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd) if scale is None else scale)
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
    return out.reshape(b, sq, hq, v.shape[-1])


def flash_attention(q, k, v, *, window=None, q_offset=0,
                    block_q: int = 512, block_k: int = 512, scale=None):
    """Blockwise streaming-softmax attention (prefill / train on long S).

    Each query block streams over the key blocks in order, as the JAX
    package's nested scans do.  Up to ``FLASH_CHUNK_SCORES`` scores'
    worth of query blocks advance together, one key block a step, so a
    step never materializes more than that many f32 scores (and a short
    sequence takes O(key blocks) ops; ``None``, as the dry-run's trace
    sets it, advances them all).  With ``FLASH_SKIP_BLOCKS``
    (queries from position 0) a key block visits only the query blocks
    whose causal range it overlaps.  v's width is its own (the
    output's).
    """
    b, sq, hq, hd = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
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
    vb = vp.reshape(b, nk, bk, hkv, dv).permute(1, 0, 3, 2, 4)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    skip = FLASH_SKIP_BLOCKS and isinstance(q_offset, int) and q_offset == 0
    qi = (q_offset + torch.arange(nq * bq, device=dev)).reshape(nq, bq)
    chunk = nq if FLASH_CHUNK_SCORES is None else \
        max(1, min(nq, FLASH_CHUNK_SCORES // (b * hq * bq * bk)))

    done = []                   # finished query blocks, in order
    for c0 in range(0, nq, chunk):
        c1 = min(nq, c0 + chunk)
        # the chunk's running max, sum and output; rows [lo, c1)
        m = torch.full((c1 - c0, b, hkv, g, bq), NEG_INF,
                       dtype=torch.float32, device=dev)
        l = torch.zeros((c1 - c0, b, hkv, g, bq), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((c1 - c0, b, hkv, g, bq, dv),
                          dtype=torch.float32, device=dev)
        qf = qb[c0:c1].float()
        lo = c0
        for ki_idx in range(nk):
            # query blocks this key block reaches (all, or the causal tail)
            reach = max(c0, (ki_idx * bk) // bq) if skip else c0
            if reach >= c1:
                break
            if reach > lo:      # blocks [lo, reach) see no later key
                n = reach - lo
                done.append((acc[:n] / torch.clamp_min(l[:n], 1e-30)[
                    ..., None]).to(q.dtype))
                m, l, acc, qf = m[n:], l[n:], acc[n:], qf[n:]
                lo = reach
            kblk, vblk = kb[ki_idx], vb[ki_idx]
            ki = ki_idx * bk + torch.arange(bk, device=dev)
            s = torch.einsum("nbkgqd,bksd->nbkgqs", qf,
                             kblk.float()) * scale
            msk = ki[None, None, :] <= qi[lo:c1, :, None]
            if window is not None:
                msk = msk & ((qi[lo:c1, :, None] - ki[None, None, :])
                             < window)
            msk = msk & (ki < sk)[None, None, :]
            s = torch.where(msk[:, None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "nbkgqs,bksd->nbkgqd", p.to(vblk.dtype), vblk)
            m = m_new
        done.append((acc / torch.clamp_min(l, 1e-30)[..., None])
                    .to(q.dtype))
    ob = done[0] if len(done) == 1 else torch.cat(done)
    out = ob.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * bq, hq, dv)
    return out[:, :sq]


def attention(q, k, v, *, window=None, q_offset=0, kv_len=None,
              flash_threshold: int | None = None, scale=None):
    return LAYOUT.attend(_attention, q, k, v, window=window,
                         q_offset=q_offset, kv_len=kv_len,
                         flash_threshold=flash_threshold, scale=scale)


def _attention(q, k, v, *, window, q_offset, kv_len, flash_threshold,
               scale):
    if flash_threshold is None:
        flash_threshold = FLASH_THRESHOLD
    if q.shape[1] == 1 or k.shape[1] <= flash_threshold:
        return dense_attention(q, k, v, window=window, q_offset=q_offset,
                               kv_len=kv_len, scale=scale)
    assert kv_len is None, "flash path expects unpadded kv"
    return flash_attention(q, k, v, window=window, q_offset=q_offset,
                           scale=scale)


# ---------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------

def mlp_apply(params, x, kind: str):
    if kind == "swiglu":
        h = F.silu(mm(x, params["wg"])) * mm(x, params["wi"])
    else:  # gelu (jax.nn.gelu's default: the tanh approximation)
        h = F.gelu(mm(x, params["wi"]), approximate="tanh")
    return mm(h, params["wo"])


def mlp_logical(kind: str):
    p = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if kind == "swiglu":
        p["wg"] = ("embed", "mlp")
    return p


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

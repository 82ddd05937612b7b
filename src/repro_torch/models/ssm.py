"""Mamba2 / SSD (state-space duality) block, chunked scan + decode step.

Follows the minimal SSD formulation of arXiv:2405.21060: within a chunk
the output is computed in dual (attention-like) form with the decay mask
L, across chunks a small recurrence over the (heads, head_dim, state)
tensor carries the SSM state.  Single B/C group shared across heads.

The decay mask is ``exp`` of segment sums with the upper triangle set to
``-inf`` before the ``exp`` (never a large positive sum times zero), as
in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import SsmConfig
from . import layers as L
from .layers import mm


def ssm_init(draw, d_model, ssm: SsmConfig, lead=()):
    d_in = ssm.expand * d_model
    nh = d_in // ssm.head_dim
    n = ssm.state_dim
    k = ssm.conv_kernel
    si = 1.0 / math.sqrt(d_model)
    conv_dim = d_in + 2 * n
    return {
        # projects to [z | x | B | C | dt]
        "in_proj": draw.normal((*lead, d_model, 2 * d_in + 2 * n + nh), si),
        "conv_w": draw.normal((*lead, k, conv_dim), 0.5),
        "conv_b": draw.zeros((*lead, conv_dim)),
        "a_log": draw.const(
            np.log(np.linspace(1.0, 16.0, nh).astype(np.float32)), lead),
        "d_skip": draw.ones((*lead, nh)),
        "dt_bias": draw.zeros((*lead, nh)),
        "norm": draw.zeros((*lead, d_in)),
        "out_proj": draw.normal((*lead, d_in, d_model),
                                1.0 / math.sqrt(d_in)),
    }


def ssm_logical():
    return {"in_proj": ("embed", "ssm_inner"), "conv_w": (None, "ssm_inner"),
            "conv_b": ("ssm_inner",), "a_log": ("ssm_heads",),
            "d_skip": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "norm": ("ssm_inner",), "out_proj": ("ssm_inner", "embed")}


def _split(params, d_in, n, nh, proj):
    return torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv, kernel k: x (B, S, C), w (k, C)."""
    k = w.shape[0]
    # zeros in front by a concatenation, not F.pad: the same values, and
    # a layout DTensor keeps under a mesh
    xp = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out + b


def _segsum_chunk(dA):
    """dA (..., Q) -> cumulative log-decay L (..., Q, Q), lower-triangular
    (``-inf`` above the diagonal)."""
    q = dA.shape[-1]
    cs = L.LAYOUT.cumsum(dA)
    diff = cs[..., :, None] - cs[..., None, :]          # seg[i] - seg[j]
    i = torch.arange(q, device=dA.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -math.inf)


def ssd_scan(xh, dt, a_log, bmat, cmat, chunk: int):
    """Chunked SSD.  xh (B,S,nh,p), dt (B,S,nh), bmat/cmat (B,S,N).

    Returns y (B,S,nh,p) and final state (B,nh,p,N).
    """
    b, s, nh, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    xc = xh.reshape(b, nc, q, nh, p)
    dtc = dt.reshape(b, nc, q, nh)
    bc = bmat.reshape(b, nc, q, n)
    cc = cmat.reshape(b, nc, q, n)

    a = -torch.exp(a_log.float())                       # (nh,) negative
    dA = dtc.float() * a                                # (b,nc,q,nh)
    dAh = torch.movedim(dA, -1, 2)                      # (b,nc,nh,q)
    lmat = torch.exp(_segsum_chunk(dAh))                # (b,nc,nh,q,q)

    # intra-chunk (dual / attention-like form)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)        # (b,nc,q,q)
    dtx = xc * dtc[..., None]                           # (b,nc,q,nh,p)
    y_intra = torch.einsum("bcqk,bchqk,bckhp->bcqhp", cb.float(), lmat,
                           dtx.float())

    # chunk summaries -> inter-chunk recurrence
    seg = L.LAYOUT.cumsum(dAh)                          # (b,nc,nh,q)
    decay_to_end = torch.exp(seg[..., -1:] - seg)       # (b,nc,nh,q)
    s_chunk = torch.einsum("bchk,bckn,bckhp->bchpn", decay_to_end,
                           bc.float(), dtx.float())     # (b,nc,nh,p,n)
    chunk_decay = torch.exp(seg[..., -1])               # (b,nc,nh)

    h = torch.zeros((b, nh, p, n), dtype=torch.float32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                # state BEFORE chunk
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prev, dim=1)                 # (b,nc,nh,p,n)

    decay_from_start = torch.exp(seg)                   # (b,nc,nh,q)
    y_inter = torch.einsum("bcqn,bchq,bchpn->bcqhp", cc.float(),
                           decay_from_start, h_prev)
    y = (y_intra + y_inter).reshape(b, nc * q, nh, p)[:, :s]
    return y.to(xh.dtype), h


def ssm_block(params, x, ssm: SsmConfig, state=None, conv_state=None):
    """Full Mamba2 mixer.  Train/prefill: state=None -> chunked scan.
    Decode (S==1): pass (state, conv_state), returns updated states.

    Returns (y, new_state, new_conv_state).
    """
    b, s, _ = x.shape
    d_in = params["out_proj"].shape[0]
    nh = params["a_log"].shape[0]
    p = d_in // nh
    n = ssm.state_dim
    proj = mm(x, params["in_proj"])
    z, xin, bmat, cmat, dt = _split(params, d_in, n, nh, proj)
    xbc = torch.cat([xin, bmat, cmat], dim=-1)

    if s == 1 and conv_state is not None:
        # decode: roll the conv window
        wdt = torch.promote_types(conv_state.dtype, xbc.dtype)
        window = torch.cat([conv_state.to(wdt), xbc.to(wdt)], dim=1)
        conv_out = (window * params["conv_w"]).sum(dim=1, keepdim=True) \
            + params["conv_b"]
        new_conv_state = window[:, 1:]
    else:
        conv_out = _causal_conv(xbc, params["conv_w"], params["conv_b"])
        k = params["conv_w"].shape[0]
        tail = torch.cat([torch.zeros((b, k - 1, xbc.shape[-1]),
                                      dtype=xbc.dtype, device=xbc.device),
                          xbc], dim=1)
        new_conv_state = tail[:, -(k - 1):]
    conv_out = F.silu(conv_out)
    xin, bmat, cmat = torch.split(conv_out, [d_in, n, n], dim=-1)

    dt = F.softplus(dt + params["dt_bias"])             # (B,S,nh)
    xh = xin.reshape(b, s, nh, p)
    a = -torch.exp(params["a_log"].float())

    if s == 1 and state is not None:
        # recurrent decode step
        dA = torch.exp(dt[:, 0].float() * a)            # (B,nh)
        dbx = torch.einsum("bn,bhp,bh->bhpn", bmat[:, 0].float(),
                           xh[:, 0].float(), dt[:, 0].float())
        new_state = state * dA[..., None, None] + dbx
        y = L.LAYOUT.ssm_readout(cmat[:, 0], new_state)
        y = y[:, None]                                  # (B,1,nh,p)
    else:
        y, new_state = ssd_scan(xh, dt, params["a_log"], bmat, cmat,
                                ssm.chunk)
    y = y + xh * params["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_in)
    # gated RMSNorm (mamba2)
    var = y.float().square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * (1 + params["norm"])
    y = (y * F.silu(z)).to(x.dtype)
    return mm(y, params["out_proj"]), new_state, new_conv_state

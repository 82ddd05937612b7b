"""Mixture-of-Experts block: top-k routing, dropless by default.

GShard-style position-in-expert dispatch (one (N, E) cumsum per top-k
slot): O(N·E) intermediates, no (N, E, C) dispatch tensors and no global
sort.  Capacity is derived from the flattened token count so it never
binds (routing is batching-invariant: prefill, teacher-forced decode and
B>1 decode steps agree exactly); ``drop_tokens=True`` gives the
capacity-factor-bounded buffer instead.

Top-k takes the largest gates with ties broken by the lower expert
index, as ``jax.lax.top_k`` does (a stable descending sort), so equal
gates route to the same experts in both packages.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers as L
from .layers import mm

# The dispatch buffer's (e*cap, d) layout as a pspec (the dry-run's
# --variant moe-shard sets ("data", None)): None leaves it as its
# operands make it; ("data", None) shards the capacity rows.  It applies
# only under a mesh (``distribution/layout.py``).
DISPATCH_SPEC = None


def moe_logical(mlp_kind: str):
    p = {"router": ("embed", "experts"),
         "wi": ("experts", "embed", "mlp"),
         "wo": ("experts", "mlp", "embed")}
    if mlp_kind == "swiglu":
        p["wg"] = ("experts", "embed", "mlp")
    return p


def moe_init(draw, d, ff, n_experts, mlp_kind, lead=()):
    si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {
        "router": draw.normal((*lead, d, n_experts), si),
        "wi": draw.normal((*lead, n_experts, d, ff), si),
        "wo": draw.normal((*lead, n_experts, ff, d), so),
    }
    if mlp_kind == "swiglu":
        p["wg"] = draw.normal((*lead, n_experts, d, ff), si)
    return p


def stable_top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries along the last axis, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params, x, *, top_k: int, capacity_factor: float,
              mlp_kind: str, drop_tokens: bool = False):
    """x: (B, S, d) -> (B, S, d), plus the aux load-balancing loss.

    Dropless by default: expert capacity is the flattened token count
    ``n``, which holds every assignment (a token reaches an expert
    through at most one of its distinct top-k slots).
    ``drop_tokens=True`` bounds it at ``ceil(n * k * cf / e)`` and drops
    the overflow.
    """
    b, s, d = x.shape
    e = params["router"].shape[-1]
    n = b * s
    dev = x.device
    xt = x.reshape(n, d)
    logits = mm(xt, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = stable_top_k(probs, top_k)     # (N, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    cap = int(max(1, math.ceil(n * top_k * capacity_factor / e))) \
        if drop_tokens else n

    # GShard dispatch: per top-k slot, position-in-expert via cumsum.
    # Row e * cap collects the dropped tokens and is cut off after.
    buf = L.LAYOUT.constrain(L.LAYOUT.dispatch_buffer(xt, e * cap + 1),
                             DISPATCH_SPEC)
    locs = []
    counts = torch.zeros((e,), dtype=torch.int32, device=dev)
    for slot in range(top_k):
        onehot = F.one_hot(gate_idx[:, slot], e).to(torch.int32)
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot \
            + counts[None, :]
        counts = counts + onehot.sum(dim=0, dtype=torch.int32)
        pos_tok = (pos * onehot).sum(-1)                      # (N,)
        ok = pos_tok < cap
        idx = torch.where(ok, gate_idx[:, slot] * cap + pos_tok, e * cap)
        buf = L.LAYOUT.scatter_add(buf, idx, xt, DISPATCH_SPEC)
        locs.append((idx, ok))

    he = L.LAYOUT.pin(buf[: e * cap].reshape(e, cap, d))
    if mlp_kind == "swiglu":
        hid = F.silu(torch.einsum("ecd,edf->ecf", he, params["wg"])) \
            * torch.einsum("ecd,edf->ecf", he, params["wi"])
    else:
        hid = F.gelu(torch.einsum("ecd,edf->ecf", he, params["wi"]),
                     approximate="tanh")
    out_e = torch.einsum("ecf,efd->ecd", hid, params["wo"])
    out_flat = out_e.reshape(e * cap, d)

    y = torch.zeros_like(xt)
    for slot, (idx, ok) in enumerate(locs):
        gathered = L.LAYOUT.take_rows(out_e, out_flat,
                                      torch.clamp_max(idx, e * cap - 1))
        w = (gate_vals[:, slot] * ok).to(y.dtype)
        y = y + gathered * w[:, None]

    # Switch-style load-balance aux loss.
    frac_tokens = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y.reshape(b, s, d), aux


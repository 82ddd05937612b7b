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

:func:`held_moe_apply` is the expert-parallel layer (Granite-4.0-H's and
DeepSeek-V3's): told which experts this chip holds, it routes over all
of them and returns its held experts' part of the result plus a shared
expert.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import trace
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



# ---------------------------------------------------------------------
# Expert parallel: the experts held here, and a shared expert
# ---------------------------------------------------------------------

def held_moe_init(draw, d, ff, moe, lead=()):
    """Router over every expert (``moe.n_routed``), SwiGLU weights of the
    ``moe.n_experts`` experts held here, and the shared SwiGLU expert;
    the sigmoid router's bias (``e_score_correction_bias``, zeros as the
    published model initialises it) beside them."""
    si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    e = moe.n_experts
    p = {
        "router": draw.normal((*lead, d, moe.n_routed), si),
        "wg": draw.normal((*lead, e, d, ff), si),
        "wi": draw.normal((*lead, e, d, ff), si),
        "wo": draw.normal((*lead, e, ff, d), so),
        "shared": L.mlp_init(draw, d, moe.shared_d_ff, "swiglu", lead=lead),
    }
    if moe.scoring_func == "sigmoid":
        p["bias"] = draw.zeros((*lead, moe.n_routed))
    return p


def group_limited_top_k(logits, bias, moe):
    """DeepSeek-V3's router (``noaux_tc``) over logits (N, experts): the
    chosen experts (N, top_k) and their gates.

    Scores are ``sigmoid(logits)``; the choice ranks ``scores + bias``.
    The experts fall into ``moe.n_group`` equal groups, each scored by
    the sum of its two best biased scores; the ``moe.topk_group`` best
    groups are kept (ties to the lower group), the others' experts
    masked to -inf, as the published inference code masks them, and the
    ``moe.top_k`` best biased scores among the rest chosen (ties to the
    lower index).  The gates are the chosen experts' unbiased scores,
    over their sum (plus 1e-20) when ``moe.norm_topk_prob``, times
    ``moe.routed_scaling_factor``.
    """
    n, e = logits.shape
    g = moe.n_group
    scores = torch.sigmoid(logits)
    choice = scores + bias.float()
    best2 = torch.sort(choice.view(n, g, e // g), dim=-1,
                       descending=True).values[..., :2].sum(-1)
    kept = torch.sort(best2, dim=-1, descending=True,
                      stable=True).indices[:, :moe.topk_group]
    allowed = torch.zeros((n, g), dtype=torch.bool, device=logits.device)
    allowed.scatter_(1, kept, True)
    choice = choice.masked_fill(
        ~allowed[:, :, None].expand(n, g, e // g).reshape(n, e),
        float("-inf"))
    _, idx = stable_top_k(choice, moe.top_k)
    gates = scores.gather(1, idx)
    if moe.norm_topk_prob:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return idx, gates * moe.routed_scaling_factor


def held_moe_apply(params, x, moe):
    """x: (B, S, d) -> (B, S, d): this chip's experts' part of the layer,
    plus the shared expert.

    Routing is over every expert: the top ``moe.top_k`` router logits
    (ties to the lower index), their gates the softmax over those k
    logits, or with ``moe.scoring_func == "sigmoid"``
    :func:`group_limited_top_k`.  Assignments to experts held here
    (``[first_expert, first_expert + n_experts)``) are dispatched
    GShard-style into an (experts, capacity, d) buffer and run as three
    batched matmuls; assignments to absent experts add nothing.
    Dropless: in a decode step (S == 1) the capacity is the token count,
    so no count is read back (every held expert's weights are read whole
    anyway); over a prompt it is the largest held expert's count, read
    once, so the matmuls do not run every expert over every token.

    Spans ``moe.route``, ``moe.experts`` (the held and shared experts),
    ``moe.combine``; counters ``moe.assignments`` (tokens x top-k),
    ``moe.assignments_held`` (those on held experts) and
    ``moe.expert_rows`` (rows of the held experts' matmuls, capacity
    padding included).
    """
    b, s, d = x.shape
    n, k, e = b * s, moe.top_k, moe.n_experts
    xt = x.reshape(n, d)
    with trace.span("moe.route"):
        logits = mm(xt, params["router"]).float()
        if moe.scoring_func == "sigmoid":
            idx, gates = group_limited_top_k(logits, params["bias"], moe)
        else:
            top, idx = stable_top_k(logits, k)            # (N, k)
            gates = torch.softmax(top, dim=-1)
        local = idx - moe.first_expert
        held = (local >= 0) & (local < e)
        # expert e's assignments in token order; absent ones to row e
        ex = torch.where(held, local, e).reshape(-1)      # (N*k,)
        onehot = F.one_hot(ex, e + 1)
        slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
        n_held = held.sum()
        if s == 1:
            cap = n
        else:
            cap = max(1, int(onehot[:, :e].sum(0).max()))
        rows = torch.where(held.reshape(-1), ex * cap + slot, e * cap)
    trace.count("moe.assignments", n * k)
    trace.count("moe.assignments_held", n_held)
    trace.count("moe.expert_rows", e * cap)
    with trace.span("moe.experts"):
        buf = xt.new_zeros((e * cap + 1, d))
        buf[rows] = xt.repeat_interleave(k, dim=0)
        he = buf[:e * cap].reshape(e, cap, d)
        hid = F.silu(torch.bmm(he, params["wg"])) \
            * torch.bmm(he, params["wi"])
        out = torch.bmm(hid, params["wo"]).reshape(e * cap, d)
        shared = L.mlp_apply(params["shared"], xt, "swiglu")
    with trace.span("moe.combine"):
        picked = out[torch.clamp_max(rows, e * cap - 1)].reshape(n, k, d)
        w = (gates * held).to(x.dtype)
        y = (picked * w[..., None]).sum(1) + shared
    return y.reshape(b, s, d)

"""Plain float32 forward pass of DeepSeek-V3 (model type ``deepseek_v3``),
for judging the served model.

Written from the published description (the model's ``config.json`` and
its reference modelling code) in plain torch, one layer at a time over
the whole sequence, with no cache and no batching:

* token embedding (no multiplier);
* per layer ``x + mla(rmsnorm(x))``, multi-head latent attention in its
  expanded form at every position:
  - the query ``q_b(rmsnorm(q_a(h)))``, each head's 128 no-rope then 64
    rope dimensions;
  - ``kv_a(h)`` = [512 latent | 64 rotary key]; the latent through its
    RMS norm and ``kv_b`` to each head's 128 key and 128 value
    dimensions; the rotary key shared by every head;
  - rotary embedding on the rope dimensions, as interleaved pairs (the
    published ``rope_interleave``), at YaRN's frequencies
    (``rope_scaling``: interpolated by ``factor`` below ``beta_slow``
    rotations over the original context, kept above ``beta_fast``,
    linearly ramped between) with cos and sin times
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``;
  - causal softmax attention with scores times
    ``(nope + rope) ** -0.5 * mscale(factor, mscale_all_dim) ** 2``,
    ``mscale(s, m) = 0.1 * m * ln(s) + 1``; then ``o_proj``;
* then ``x + ffn(rmsnorm(x))``: a SwiGLU of ``d_ff`` in the first
  ``first_k_dense_replace`` layers, else the MoE: scores
  ``sigmoid(h @ router)``; the choice ranks ``scores + bias``
  (``e_score_correction_bias``) within the ``topk_group`` of ``n_group``
  groups whose two best biased scores sum highest; the gates are the
  chosen experts' unbiased scores over their sum (plus 1e-20), times
  ``routed_scaling_factor``; each routed expert and the shared expert a
  SwiGLU (``silu(x W_g) * (x W_i) W_o``);
* a final RMS norm and the untied output head.

Departures from the published model, each as the configuration runs it:

* The depth and the experts: the weights hold one pipeline stage's
  layers and, of each MoE layer, the experts of one chip's share,
  ``[first_expert, first_expert + n_experts)`` of the router's
  ``router_experts``; the router chooses among all of them (its
  normalisation over every chosen expert), and the experts held
  elsewhere add nothing (the share's part of the layer).  The experts
  run in a plain loop over the held experts.  The output head follows
  the stage's last layer.
* The experts of the groups not kept are masked to -inf, as DeepSeek's
  inference code masks them; ``transformers`` fills 0.0, which chooses
  the same experts whenever the kept groups hold ``top_k`` positive
  biased scores.
* Every norm's scale is stored as an offset from one
  (``x * rsqrt(mean(x^2) + eps) * (1 + g)``); the latent's and the
  query bottleneck's norms take the published modules' epsilon, 1e-6.
* The tree is the program's: per-layer leaves stacked, the dense MLP
  over the dense layers and the MoE over the MoE layers alone, in layer
  order; matrices as (in, out).
* Attention runs over blocks of ``block`` query rows at a time, so a
  long sequence's scores fit beside the model; each row's softmax is
  over its whole causal context.

It reads the weight tensors it is handed and recomputes everything else
itself.  TF32 is off unless ``use_tf32`` asks for it (the control).  It
imports nothing but torch.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(on: bool):
    """Matmul precision for the block: float32 (``on=False``) or TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _norm(x, g, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + g)


def _swiglu(x, wg, wi, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def _mscale(scale: float, m: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn(cfg: dict, device=None):
    """The rope dimensions' inverse frequencies and cos / sin factor."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    pos_freqs = base ** (torch.arange(0, dim, 2, device=device).float()
                         / dim)
    rs = cfg.get("rope_scaling")
    if not rs:
        return 1.0 / pos_freqs, 1.0
    factor = rs["factor"]
    original = rs["original_max_position_embeddings"]

    def dim_of(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(dim_of(rs["beta_fast"])), 0)
    high = min(math.ceil(dim_of(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, device=device).float() - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    inv = (1.0 / (factor * pos_freqs)) * ramp + (1.0 / pos_freqs) * (1 - ramp)
    if rs.get("mscale") and rs.get("mscale_all_dim"):
        att = _mscale(factor, rs["mscale"]) / _mscale(factor,
                                                      rs["mscale_all_dim"])
    else:
        att = _mscale(factor)
    return inv, att


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        scale *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def _rotate(x, cos, sin):
    """x (S, H, D) with interleaved pairs: de-interleaved, then rotated
    by halves (``rotate_half``) as the published code does."""
    s, h, d = x.shape
    x = x.view(s, h, d // 2, 2).transpose(3, 2).reshape(s, h, d)
    half = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * cos[:, None] + half * sin[:, None]


def _mla(cfg: dict, p: dict, h, block: int):
    """Latent attention over the sequence, expanded per head."""
    s = h.shape[0]
    nh, nope, rope = cfg["n_heads"], cfg["qk_nope_head_dim"], \
        cfg["qk_rope_head_dim"]
    kv, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = (_norm(h @ p["wq_a"], p["q_norm"], 1e-6) @ p["wq_b"]).view(
        s, nh, nope + rope)
    ckv = h @ p["wkv_a"]
    kvh = (_norm(ckv[:, :kv], p["kv_norm"], 1e-6) @ p["wkv_b"]).view(
        s, nh, nope + dv)
    inv, att = yarn(cfg, h.device)
    freqs = torch.arange(s, device=h.device).float()[:, None] * inv[None]
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = emb.cos() * att, emb.sin() * att
    q_rot = _rotate(q[..., nope:], cos, sin)
    k_rot = _rotate(ckv[:, None, kv:], cos, sin).expand(s, nh, rope)
    query = torch.cat((q[..., :nope], q_rot), dim=-1)
    key = torch.cat((kvh[..., :nope], k_rot), dim=-1)
    value = kvh[..., nope:]
    scale = softmax_scale(cfg)
    out = []
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        scores = torch.einsum("qhd,khd->hqk", query[lo:hi], key) * scale
        causal = (torch.arange(s, device=h.device)[None]
                  <= torch.arange(lo, hi, device=h.device)[:, None])
        scores = scores.masked_fill(~causal, float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", scores.softmax(-1), value))
    return torch.cat(out).reshape(s, nh * dv) @ p["wo"]


def _route(m: dict, p: dict, h):
    """The chosen experts (S, top_k) and their gates, as published."""
    e = m["router_experts"]
    scores = (h @ p["router"]).sigmoid()
    choice = scores + p["bias"][None]
    grouped = choice.view(-1, m["n_group"], e // m["n_group"])
    group_scores = grouped.topk(2, dim=-1)[0].sum(dim=-1)
    group_idx = torch.topk(group_scores, k=m["topk_group"], dim=-1,
                           sorted=False)[1]
    group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1)
    score_mask = group_mask[:, :, None].expand_as(grouped).reshape(-1, e)
    choice = choice.masked_fill(~score_mask.bool(), float("-inf"))
    idx = torch.topk(choice, k=m["top_k"], dim=-1, sorted=False)[1]
    gates = scores.gather(1, idx)
    if m["norm_topk_prob"]:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, gates * m["routed_scaling_factor"]


def _moe(cfg: dict, p: dict, h, routes=None):
    """This share's routed experts, in a loop, plus the shared expert."""
    m = cfg["moe"]
    idx, gates = _route(m, p, h)
    if routes is not None:
        routes.append(idx.sort(-1).values)
    out = _swiglu(h, p["shared"]["wg"], p["shared"]["wi"], p["shared"]["wo"])
    for e in range(m["n_experts"]):
        hit = idx == m["first_expert"] + e              # (S, k)
        tok = hit.any(-1).nonzero()[:, 0]
        if len(tok):
            g = (gates * hit).sum(-1)[tok, None]
            out = out.index_add(0, tok, g * _swiglu(
                h[tok], p["wg"][e], p["wi"][e], p["wo"][e]))
    return out


@torch.no_grad()
def logits(cfg: dict, params: dict, tokens, rows=None,
           use_tf32: bool = False, routes=None,
           block: int = 512) -> torch.Tensor:
    """Logits (len(rows), vocab) at positions ``rows`` (default: all) of
    one sequence ``tokens`` (S,).  ``routes``: a list that gets each MoE
    layer's (S, top_k) routed expert ids, sorted, in layer order."""
    blk, eps = params["blocks"], cfg["norm_eps"]
    dense = cfg["first_k_dense_replace"]
    with tf32(use_tf32):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        x = params["embed"][tokens.long()]
        for i in range(cfg["n_layers"]):
            h = _norm(x, blk["ln1"][i], eps)
            x = x + _mla(cfg, {k: v[i] for k, v in blk["mla"].items()}, h,
                         block)
            h = _norm(x, blk["ln2"][i], eps)
            if i < dense:
                mlp = {k: v[i] for k, v in blk["mlp"].items()}
                x = x + _swiglu(h, mlp["wg"], mlp["wi"], mlp["wo"])
            else:
                j = i - dense
                moe = {k: (v[j] if k != "shared"
                           else {kk: vv[j] for kk, vv in v.items()})
                       for k, v in blk["moe"].items()}
                x = x + _moe(cfg, moe, h, routes)
        if rows is not None:
            x = x[rows.start:rows.stop]
        return _norm(x, params["ln_f"], eps) @ params["lm_head"]


def served_gaps(cfg: dict, params: dict, prompt, served,
                use_tf32: bool = False) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at its position: ``max(logits) - logits[token]``.

    The sequence is the prompt and every served token but the last; the
    row of position ``len(prompt) - 1 + k`` predicts served token ``k``.
    ``use_tf32`` gives the control's reading instead: the gap, in the
    float32 reference, of the token TF32 puts first."""
    dev = params["embed"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev)
    n0 = len(prompt) - 1
    rows = range(n0, n0 + len(served))
    ref = logits(cfg, params, seq, rows)
    if use_tf32:
        pick = logits(cfg, params, seq, rows, use_tf32=True).argmax(-1)
    else:
        pick = torch.as_tensor(list(served), device=dev)
    best = ref.max(-1).values
    return best - ref.gather(1, pick[:, None].long())[:, 0]

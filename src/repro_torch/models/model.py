"""Model assembly: every supported architecture as one decoder.

A single parameter schema covers all five families (dense / local-global
/ MoE / SSM / hybrid): nested dicts whose per-layer leaves are stacked
along a leading L axis, the JAX package's tree, so its weights carry
across (``models/convert.py``).  The backbone is a Python loop over the
layers; serving writes each layer's slice of the stacked cache in place.
A model whose layers differ in mixer (``cfg.layer_types``, the port's
alone) stacks each mixer's weights and cache over its own layers, and
follows each with the expert-parallel MoE (``moe.held_moe_apply``), or
in its first ``cfg.first_k_dense_replace`` layers with a dense MLP.  Its
mixers are attention, Mamba-2, or multi-head latent attention
(:func:`_mla_apply`), whose cache holds a latent and a rotary key a
position.

Public surface:
  init_params(cfg, generator, device)  -> params tree (stacked layers)
  forward(cfg, params, batch)          -> logits (train/prefill path)
  loss_fn(cfg, params, batch)          -> (loss + 0.01 aux, metrics)
  init_cache(cfg, batch, seq, device=) -> KV/SSM cache tree
  prefill(cfg, params, batch, cache)   -> (logits_last, cache)
  decode_step(cfg, params, cache, token, pos) -> (logits, cache)
  quantize_for_serving(params, w_bits) -> W8/W4 serving tree
  param_logical(cfg)                   -> same-structure tree of logical axes
  param_specs(cfg, dtype)              -> the params as ``meta`` tensors
  input_specs(cfg, shape, dtype)       -> a cell's inputs as ``meta`` tensors

Training recomputes each block in the backward pass under
``REMAT_POLICY`` (``torch.utils.checkpoint``; the selective policies
save what the JAX package's checkpoint policies save).

``init_params`` and ``init_cache`` run on the card unless given
``device="cpu"``; the rest follow their parameters' device.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import trace
from repro_torch.core.engine import resolve_device
from . import layers as L
from . import moe as MOE
from . import quant as Q
from . import ssm as SSM

PyTree = Any

# REMAT_POLICY: "full" = recompute each block in the backward pass (keep
# only its input), "none" = keep every activation, "dots" = keep the
# outputs of matmuls without batch dims, "tp-save" / "moe-save" = keep
# only the values marked "tp_out" / "moe_out" (:func:`checkpoint_name`).
# CE_CHUNKS: > 1 computes the cross-entropy in that many sequence chunks
# without materializing the full (B, S, vocab) logits.
REMAT_POLICY = "full"
CE_CHUNKS = 0

# Quantized serving (the paper's W8-W4 formats): 0 = full-precision
# params; 8/4 = int8 / packed-int4 matmul weights + scales
# (models/quant.py).  Embedding tables stay int8 under w4 (row gather).
QUANT_BITS = 0

# int8 KV cache: per-(layer, batch, head) scales fixed at prefill; decode
# clips to them.
KV_QUANT = False


def _deq(leaf):
    """Dequantize a possibly-quantized parameter leaf on use."""
    if Q.is_bundle(leaf):
        return Q.dequant_leaf(leaf, QUANT_BITS or 8)
    return leaf


def _head(cfg, params, x):
    """The final norm and the output head: logits of ``x`` (divided by
    ``cfg.logits_scaling``)."""
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.mm(x, _head_matrix(cfg, params))
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _head_matrix(cfg, params):
    if cfg.tie_embeddings:
        emb = params["embed"]
        if Q.is_bundle(emb):
            return Q.dequant_leaf(emb, 8).T   # embed is always 8-bit
        return emb.T
    lm = params["lm_head"]
    return Q.dequant_leaf(lm, QUANT_BITS or 8) if Q.is_bundle(lm) else lm


# ---------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------

def _attn_init(draw, cfg: ArchConfig, lead):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": draw.normal((*lead, d, hq * hd), s),
        "wk": draw.normal((*lead, d, hkv * hd), s),
        "wv": draw.normal((*lead, d, hkv * hd), s),
        "wo": draw.normal((*lead, hq * hd, d), 1.0 / math.sqrt(hq * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = draw.zeros((*lead, hq * hd))
        p["bk"] = draw.zeros((*lead, hkv * hd))
        p["bv"] = draw.zeros((*lead, hkv * hd))
    return p


def _layer_init(draw, cfg: ArchConfig, lead):
    if cfg.layer_types:
        return _mixed_layer_init(draw, cfg, lead)
    p: dict = {"ln1": draw.zeros((*lead, cfg.d_model)),
               "ln2": draw.zeros((*lead, cfg.d_model))}
    if not cfg.attention_free:
        p["attn"] = _attn_init(draw, cfg, lead)
    if cfg.family == "moe":
        p["moe"] = MOE.moe_init(draw, cfg.d_model, cfg.d_ff,
                                cfg.moe.n_experts, cfg.mlp, lead=lead)
    elif cfg.d_ff > 0:
        p["mlp"] = L.mlp_init(draw, cfg.d_model, cfg.d_ff, cfg.mlp,
                              lead=lead)
    if cfg.ssm is not None:
        p["ssm"] = SSM.ssm_init(draw, cfg.d_model, cfg.ssm, lead=lead)
    return p


def _mla_init(draw, cfg: ArchConfig, lead):
    """Latent attention's weights, matrices as (in, out): the query's
    bottleneck ``wq_a`` with its norm and ``wq_b`` (each head's
    [no-rope | rope] query), ``wkv_a`` to [latent | rotary key], the
    latent's norm, ``wkv_b`` from the latent to each head's [key |
    value], and ``wo``."""
    d, h = cfg.d_model, cfg.n_heads
    q, kv, rope = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    hv = h * cfg.v_head_dim
    return {
        "wq_a": draw.normal((*lead, d, q), 1.0 / math.sqrt(d)),
        "q_norm": draw.zeros((*lead, q)),
        "wq_b": draw.normal((*lead, q, h * cfg.qk_head_dim),
                            1.0 / math.sqrt(q)),
        "wkv_a": draw.normal((*lead, d, kv + rope), 1.0 / math.sqrt(d)),
        "kv_norm": draw.zeros((*lead, kv)),
        "wkv_b": draw.normal((*lead, kv, h * (cfg.qk_nope_head_dim
                                             + cfg.v_head_dim)),
                             1.0 / math.sqrt(kv)),
        "wo": draw.normal((*lead, hv, d), 1.0 / math.sqrt(hv)),
    }


def _mixed_layer_init(draw, cfg: ArchConfig, lead):
    """Layers of mixed kinds (``cfg.layer_types``): norms stacked over
    every layer, the MoE over the layers past
    ``cfg.first_k_dense_replace`` and the dense MLP over those before,
    and each mixer (attention, Mamba-2, latent attention) over its own
    layers alone, each in layer order."""
    k = cfg.first_k_dense_replace
    p: dict = {"ln1": draw.zeros((*lead, cfg.d_model)),
               "ln2": draw.zeros((*lead, cfg.d_model)),
               "moe": MOE.held_moe_init(draw, cfg.d_model, cfg.expert_d_ff,
                                        cfg.moe,
                                        lead=(cfg.n_layers - k,))}
    if k:
        p["mlp"] = L.mlp_init(draw, cfg.d_model, cfg.d_ff, cfg.mlp,
                              lead=(k,))
    n_attn, n_mamba = cfg.n_layers_of("attention"), cfg.n_layers_of("mamba")
    if n_attn:
        p["attn"] = _attn_init(draw, cfg, (n_attn,))
    if n_mamba:
        p["ssm"] = SSM.ssm_init(draw, cfg.d_model, cfg.ssm, lead=(n_mamba,))
    if cfg.n_layers_of("mla"):
        p["mla"] = _mla_init(draw, cfg, (cfg.n_layers_of("mla"),))
    return p


def mixer_slots(cfg: ArchConfig) -> list[tuple[str, int]]:
    """Each layer's mixer kind and its index among the layers of that
    kind (the row of its stacked mixer weights and of its cache)."""
    seen: dict = {}
    out = []
    for kind in cfg.layer_types:
        out.append((kind, seen.get(kind, 0)))
        seen[kind] = seen.get(kind, 0) + 1
    return out


# a layer_types mixer kind -> its weights' key
_MIXERS = {"attention": "attn", "mamba": "ssm", "mla": "mla"}


def _mixed_layer(cfg: ArchConfig, blocks, i: int, kind: str, j: int):
    """Layer ``i``'s weights of a ``layer_types`` model: its mixer is the
    ``j``-th of its ``kind``; its FFN the dense MLP's row ``i`` before
    ``cfg.first_k_dense_replace``, else the MoE's row past it."""
    k = cfg.first_k_dense_replace
    ffn = ("mlp", i) if i < k else ("moe", i - k)
    mixer = _MIXERS[kind]
    return {"ln1": blocks["ln1"][i], "ln2": blocks["ln2"][i],
            ffn[0]: _layer(blocks[ffn[0]], ffn[1]),
            mixer: _layer(blocks[mixer], j)}


def layer_kinds(cfg: ArchConfig) -> list[int]:
    """Each layer's kind: 1 = global attention, 0 = local (sliding
    window).  Plain ints, so tracing with fake tensors never reads a
    tensor's value."""
    if cfg.sliding_window is None or cfg.global_every == 0:
        return [1] * cfg.n_layers
    return [int(i % cfg.global_every == cfg.global_every - 1)
            for i in range(cfg.n_layers)]


def init_params(cfg: ArchConfig, generator=None, device=None,
                dtype=torch.float32) -> PyTree:
    """Random parameters in the JAX package's tree and scales.

    ``generator``: a ``torch.Generator`` on the parameter device (default:
    a fresh one seeded 0), or a ``layers.NumpyDraw`` for numpy arrays.
    ``device``: default the generator's, else the card.
    """
    if isinstance(generator, (L.NumpyDraw, L.MetaDraw)):
        draw = generator
    else:
        if device is None and generator is not None:
            device = generator.device
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        draw = L.TorchDraw(generator, dtype, dev)
    v = cfg.vocab_padded
    params = {
        "embed": draw.normal((v, cfg.d_model), 0.02),
        "ln_f": draw.zeros((cfg.d_model,)),
        "blocks": _layer_init(draw, cfg, (cfg.n_layers,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = draw.normal((cfg.d_model, v), 0.02)
    if cfg.prefix_patches:
        params["patch_proj"] = draw.normal((cfg.d_model, cfg.d_model), 0.02)
    return params


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked (sub)tree (bundles included)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------

def kv_quant_scale(x: torch.Tensor) -> torch.Tensor:
    """The int8 KV cache's (B, 1, H, 1) scales of a prefill's (B, S, H, D)
    keys or values: max |x| per (batch, head) over 127."""
    return L._div(x.abs().amax(dim=(1, 3), keepdim=True).float(),
                  127) + 1e-8


def kv_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x`` in the int8 KV cache: ``x / scale`` rounded half to even,
    clipped to +-127."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _attn_apply(p, cfg: ArchConfig, x, kind: int, positions, cache_kv=None,
                pos=None, kv_len=None, kv_scale=None):
    """kind: the layer's kind (0 local / 1 global).  ``cache_kv``: the
    layer's (K, V) cache slices, written in place.  Returns (out, (k, v),
    kv_scale)."""
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = L.mm(x, p["wq"])
    k = L.mm(x, p["wk"])
    v = L.mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.LAYOUT.split_heads(q, hq)
    k = L.LAYOUT.split_heads(k, hkv)
    v = L.LAYOUT.split_heads(v, hkv)
    if cfg.position_embedding_type != "nope":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)

    new_scale = kv_scale
    if cache_kv is not None:
        ck, cv = cache_kv
        kv_q = ck.dtype == torch.int8
        if s == 1:
            # decode: per-slot write positions (ragged continuous
            # batching), clamped into the cache as dynamic_update_slice
            # clamps its start
            posv = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                                      (b,)).to(torch.int32)
            if kv_q:
                sk, sv = kv_scale
                kq, vq = kv_quant(k, sk), kv_quant(v, sv)
            else:
                kq, vq = k, v
            L.LAYOUT.write_rows_(ck, posv, kq)
            L.LAYOUT.write_rows_(cv, posv, vq)
            # attend over the cache (padded; mask via kv_len)
            if kv_q:
                k_all = (ck.float() * sk).to(q.dtype)
                v_all = (cv.float() * sv).to(q.dtype)
            else:
                k_all, v_all = ck, cv
            q_offset = posv
            kv_len_eff = posv + 1
        else:
            if kv_q:
                # per-(batch, head) scales fixed at prefill time
                sk, sv = kv_quant_scale(k), kv_quant_scale(v)
                kq, vq = kv_quant(k, sk), kv_quant(v, sv)
                new_scale = (sk, sv)
            else:
                kq, vq = k, v
            L.LAYOUT.write_prefix_(ck, kq)
            L.LAYOUT.write_prefix_(cv, vq)
            # prefill: the fresh k/v ARE the valid cache prefix
            k_all, v_all = k, v
            q_offset = 0
            kv_len_eff = None
        new_cache = (ck, cv)
    else:
        k_all, v_all = k, v
        q_offset = 0
        new_cache = (k, v)
        kv_len_eff = None

    window = None
    if cfg.sliding_window is not None:
        # kind == 1 -> global: disable the window via a huge value.
        window = (1 << 30) if int(kind) == 1 else cfg.sliding_window
    if cache_kv is None or s > 1:
        q, k_all, v_all = L.LAYOUT.attention_heads(q, k_all, v_all)
    out = L.attention(q, k_all.to(q.dtype), v_all.to(q.dtype),
                      window=window, q_offset=q_offset, kv_len=kv_len_eff,
                      scale=cfg.attention_multiplier)
    # pin: the gradient comes back whole over the heads, so the
    # reshape's backward never splits a sharded dim between heads
    return L.mm(L.LAYOUT.pin(out.reshape(b, s, hq * hd)), p["wo"]), \
        new_cache, new_scale


def _block_apply(cfg: ArchConfig, params, kind, x, positions,
                 cache=None, pos=None):
    """One decoder layer.  cache: dict of the layer's state or None."""
    if QUANT_BITS:
        params = Q.dequant_tree(params, QUANT_BITS,
                                dtype=params["ln1"].dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    x = L.LAYOUT.residual(x)
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    mix = 0.0
    if not cfg.attention_free:
        attn_out, kv, kv_scale = _attn_apply(
            params["attn"], cfg, h, kind, positions,
            cache_kv=None if cache is None else cache.get("kv"),
            pos=pos,
            kv_scale=None if cache is None else cache.get("kv_scale"))
        new_cache["kv"] = kv
        if kv_scale is not None:
            new_cache["kv_scale"] = kv_scale
        mix = checkpoint_name(attn_out, "tp_out")
    if cfg.ssm is not None:
        y, st, cst = SSM.ssm_block(
            params["ssm"], h, cfg.ssm,
            state=None if cache is None else cache.get("ssm"),
            conv_state=None if cache is None else cache.get("conv"))
        new_cache["ssm"] = st
        new_cache["conv"] = cst
        if cfg.family == "hybrid":
            # Hymba: parallel attn + SSM heads, normalized mean fusion.
            mix = 0.5 * (_rmsn(mix) + _rmsn(y))
        else:
            mix = y
    x = L.LAYOUT.residual(x + mix)
    h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = MOE.moe_apply(params["moe"], h, top_k=cfg.moe.top_k,
                               capacity_factor=cfg.moe.capacity_factor,
                               mlp_kind=cfg.mlp)
        y = checkpoint_name(y, "moe_out")
    elif cfg.d_ff > 0:
        y = checkpoint_name(L.mlp_apply(params["mlp"], h, cfg.mlp),
                            "tp_out")
    else:
        y = torch.zeros_like(h)
    return L.LAYOUT.residual(x + y), aux, new_cache


def _mixed_block_apply(cfg: ArchConfig, params, x, positions, cache=None,
                       pos=None):
    """One layer of a ``layer_types`` model: its mixer (attention, Mamba
    or latent attention, whichever weights ``params`` holds), then the
    MoE or the dense MLP, each branch of the residual scaled by
    ``cfg.residual_multiplier``.  cache: the layer's KV, SSM / conv
    state or latent cache, or None."""
    cache = cache or {}
    new_cache = {}
    h = L.rms_norm(x, params["ln1"], cfg.norm_eps)
    if "attn" in params:
        y, kv, _ = _attn_apply(params["attn"], cfg, h, 1, positions,
                               cache_kv=cache.get("kv"), pos=pos)
        new_cache["kv"] = kv
    elif "mla" in params:
        y, new_cache["mla"] = _mla_apply(params["mla"], cfg, h, positions,
                                         cache.get("mla"), pos)
    else:
        y, new_cache["ssm"], new_cache["conv"] = SSM.ssm_block(
            params["ssm"], h, cfg.ssm, state=cache.get("ssm"),
            conv_state=cache.get("conv"))
    x = x + cfg.residual_multiplier * y
    h = L.rms_norm(x, params["ln2"], cfg.norm_eps)
    if "moe" in params:
        y = MOE.held_moe_apply(params["moe"], h, cfg.moe)
    else:
        y = L.mlp_apply(params["mlp"], h, cfg.mlp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + cfg.residual_multiplier * y, aux, new_cache


# Latent attention's inner norms (the query's bottleneck, the latent)
# take the published modules' default epsilon.
MLA_NORM_EPS = 1e-6


def mla_softmax_scale(cfg: ArchConfig) -> float:
    """The scores' factor: ``qk_head_dim ** -0.5``, times YaRN's
    ``mscale(factor, mscale_all_dim) ** 2`` where the configuration sets
    ``mscale_all_dim``."""
    scale = cfg.qk_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs is not None and rs.mscale_all_dim:
        scale *= L.yarn_mscale(rs.factor, rs.mscale_all_dim) ** 2
    return scale


def _mla_apply(p, cfg: ArchConfig, x, positions, cache=None, pos=None):
    """Multi-head latent attention (DeepSeek-V3's) over x (B, S, d) at
    ``positions`` (B|1, S).  Returns (out, cache).

    The query: ``wq_b(norm(wq_a x))``, each head's [no-rope | rope]
    parts.  The keys and values come from ``wkv_a x`` = [latent |
    rotary key]: the latent through its norm, the rotary key one for
    every head.  The rope parts rotate by YaRN's frequencies over
    interleaved pairs (``cfg.rope_interleave``); scores are times
    :func:`mla_softmax_scale`.

    ``cache``: the layer's (latent (B, T, kv_lora_rank), rotary key (B,
    T, qk_rope_head_dim)) rows, written in place, and nothing else.
    Without a cache, or over a prompt (S > 1), the expanded form:
    ``wkv_b`` turns the latent into each head's key and value, and
    ``layers.attention`` attends (dense, or blockwise past
    ``FLASH_THRESHOLD``).  A decode step (S == 1) takes the absorbed
    form: the query's no-rope part through each head's key block of
    ``wkv_b`` into the latent's space, scores over the cached latent
    and rotary key, the weighted latent through each head's value block,
    so no per-head key or value is formed (the same products, summed in
    another order).

    Spans ``mla.project`` (projections, norms, rotation, cache writes,
    absorption, ``wo``) and ``mla.attend`` (scores, softmax and the
    weighted sum); counters ``mla.attended_positions`` (key positions
    attended, summed over query rows) and, with a cache,
    ``mla.latent_bytes`` (the cache's bytes the layer reads, the rows
    each decode row attends, and writes).
    """
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kv, dv = cfg.kv_lora_rank, cfg.v_head_dim
    scale = mla_softmax_scale(cfg)
    with trace.span("mla.project"):
        q = L.mm(L.rms_norm(L.mm(x, p["wq_a"]), p["q_norm"], MLA_NORM_EPS),
                 p["wq_b"]).reshape(b, s, h, nope + rope)
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        ckv = L.mm(x, p["wkv_a"])
        latent = L.rms_norm(ckv[..., :kv], p["kv_norm"], MLA_NORM_EPS)
        inv, factor = L.rope_frequencies(rope, cfg.rope_theta,
                                         cfg.rope_scaling, x.device)
        q_rope = L.rope_rotate(q_rope, positions, inv, cfg.rope_interleave,
                               factor)
        k_rope = L.rope_rotate(ckv[..., None, kv:], positions, inv,
                               cfg.rope_interleave, factor)[..., 0, :]
        w_kv = p["wkv_b"].reshape(kv, h, nope + dv)
        if cache is not None and s == 1:
            c_lat, c_rope = cache
            t = c_lat.shape[1]
            posv = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                                      (b,)).to(torch.int32)
            L.LAYOUT.write_rows_(c_lat, posv, latent)
            L.LAYOUT.write_rows_(c_rope, posv, k_rope)
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_kv[..., :nope])
        else:
            kv_h = L.mm(latent, p["wkv_b"]).reshape(b, s, h, nope + dv)
            k = torch.cat([kv_h[..., :nope],
                           k_rope[:, :, None].expand(b, s, h, rope)], dim=-1)
            if cache is not None:
                L.LAYOUT.write_prefix_(cache[0], latent)
                L.LAYOUT.write_prefix_(cache[1], k_rope)
    row = (kv + rope) * latent.element_size()
    with trace.span("mla.attend"):
        if cache is not None and s == 1:
            scores = (torch.einsum("bshr,btr->bsht", q_lat, c_lat)
                      + torch.einsum("bshp,btp->bsht", q_rope, c_rope)
                      ) * scale
            seen = torch.clamp(posv + 1, max=t)
            mask = torch.arange(t, device=x.device)[None] < seen[:, None]
            scores = torch.where(mask[:, None, None], scores, L.NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            o_lat = torch.einsum("bsht,btr->bshr", probs, c_lat)
            trace.count("mla.attended_positions", seen.sum())
            trace.count("mla.latent_bytes", (seen.sum() + b) * row)
        else:
            o = L.attention(torch.cat([q_nope, q_rope], dim=-1), k,
                            kv_h[..., nope:], scale=scale)
            trace.count("mla.attended_positions", b * s * (s + 1) // 2)
            if cache is not None:
                trace.count("mla.latent_bytes", b * s * row)
    with trace.span("mla.project"):
        if cache is not None and s == 1:
            o = torch.einsum("bshr,rhv->bshv", o_lat, w_kv[..., nope:])
        out = L.mm(o.reshape(b, s, h * dv), p["wo"])
    return out, cache


def _rmsn(x):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _embed_inputs(cfg: ArchConfig, params, batch):
    """tokens and/or stub-modality embeddings -> (B, S, d), positions."""
    if cfg.input_mode == "embeddings":
        x = batch["embeds"]
    else:
        x = _embed_tokens(params, batch["tokens"], cfg)
        if cfg.prefix_patches:
            patches = L.mm(batch["patches"], _deq(params["patch_proj"]))
            x = torch.cat([patches.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.broadcast_to(torch.arange(s, device=x.device), (b, s))
    return x, positions


def _embed_tokens(params, tokens, cfg: ArchConfig):
    emb = params["embed"]
    tokens = torch.as_tensor(tokens, device=params["ln_f"].device).long()
    if Q.is_bundle(emb):
        rows = L.LAYOUT.embed(emb["q"], tokens)
        x = (rows.float() * emb["s"]).to(params["ln_f"].dtype)
    else:
        x = L.LAYOUT.embed(emb, tokens)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return L.LAYOUT.residual(x, like=tokens)


def _block_train(cfg: ArchConfig, kind: int, positions, x, blk):
    if cfg.layer_types:
        x, a, _ = _mixed_block_apply(cfg, blk, x, positions)
    else:
        x, a, _ = _block_apply(cfg, blk, kind, x, positions)
    return x, a


_SAVED_NAMES = {"tp-save": "tp_out", "moe-save": "moe_out"}
_NAMING: list[str] = []


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Mark ``x`` as ``name`` for a selective remat policy (the JAX
    package's ``checkpoint_name``).  Under a policy that saves names the
    marker is a copy the policy can see; otherwise ``x`` itself.  It
    never changes a number."""
    if REMAT_POLICY not in _SAVED_NAMES:
        return x
    _NAMING.append(name)
    try:
        return x.clone()
    finally:
        _NAMING.pop()


def _policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if REMAT_POLICY == "dots":
        save = op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    else:
        save = (op is torch.ops.aten.clone.default and bool(_NAMING)
                and _NAMING[-1] == _SAVED_NAMES[REMAT_POLICY])
    return (CheckpointPolicy.MUST_SAVE if save
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(body):
    if REMAT_POLICY not in ("full", "none", "dots", "tp-save", "moe-save"):
        raise ValueError(f"unknown REMAT_POLICY {REMAT_POLICY!r}")
    if REMAT_POLICY == "none" or not torch.is_grad_enabled():
        return body
    if REMAT_POLICY == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return functools.partial(
        checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _policy))


def _backbone(cfg: ArchConfig, params, x, positions, remat: bool = True):
    kinds = layer_kinds(cfg)
    slots = mixer_slots(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        body = functools.partial(_block_train, cfg, kinds[i], positions)
        if remat:
            body = _remat_wrap(body)
        blk = (_mixed_layer(cfg, params["blocks"], i, *slots[i]) if slots
               else _layer(params["blocks"], i))
        x, a = body(x, blk)
        aux = aux + a
    return x, aux


def forward(cfg: ArchConfig, params, batch, remat: bool = True):
    """Full-sequence forward -> (logits (B, S, vocab), aux_loss).
    ``remat``: recompute each block in the backward pass
    (``REMAT_POLICY``); without grad enabled it changes nothing."""
    x, positions = _embed_inputs(cfg, params, batch)
    x, aux = _backbone(cfg, params, x, positions, remat)
    logits = _head(cfg, params, x)
    if cfg.prefix_patches:
        logits = logits[:, cfg.prefix_patches:]
    return logits, aux


# ---------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------

def loss_fn(cfg: ArchConfig, params, batch, remat: bool = True):
    """Mean next-token cross-entropy over ``labels >= 0`` plus 0.01 x the
    MoE aux loss -> (total, {"loss", "aux"})."""
    labels = torch.as_tensor(batch["labels"],
                             device=params["ln_f"].device).long()
    mask = (labels >= 0).float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    if CE_CHUNKS > 1:
        # chunked CE: never materialize the full (B, S, vocab) logits.
        x, positions = _embed_inputs(cfg, params, batch)
        x, aux = _backbone(cfg, params, x, positions, remat)
        x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
        if cfg.prefix_patches:
            x = x[:, cfg.prefix_patches:]
        head = _head_matrix(cfg, params)
        s = x.shape[1]
        csz = -(-s // CE_CHUNKS)
        nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(CE_CHUNKS):
            sl = slice(i * csz, (i + 1) * csz)
            if x[:, sl].shape[1] == 0:
                continue
            logits = L.mm(x[:, sl], head)
            if cfg.logits_scaling != 1.0:
                logits = logits / cfg.logits_scaling
            nll_sum = nll_sum + L.LAYOUT.nll_sum(
                logits, labels[:, sl], mask[:, sl])
        loss = nll_sum / denom
    else:
        logits, aux = forward(cfg, params, batch, remat)
        loss = L.LAYOUT.nll_sum(logits, labels, mask) / denom
    return loss + 0.01 * aux, dict(loss=loss, aux=aux)


def _attn_logical(cfg: ArchConfig):
    p = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        p.update({"bq": ("heads",), "bk": ("kv_heads",),
                  "bv": ("kv_heads",)})
    return p


def param_logical(cfg: ArchConfig) -> PyTree:
    """The params' tree with each leaf's logical axis names (the JAX
    package's tree: ``distribution/sharding.py`` maps them to a mesh)."""
    def stacked(tree):
        return {k: ("layers",) + v for k, v in tree.items()}

    blk: dict = {"ln1": ("layers", "embed"), "ln2": ("layers", "embed")}
    if not cfg.attention_free:
        blk["attn"] = stacked(_attn_logical(cfg))
    if cfg.family == "moe":
        blk["moe"] = stacked(MOE.moe_logical(cfg.mlp))
    elif cfg.d_ff > 0:
        blk["mlp"] = stacked(L.mlp_logical(cfg.mlp))
    if cfg.ssm is not None:
        blk["ssm"] = stacked(SSM.ssm_logical())
    out = {"embed": ("vocab", "embed"), "ln_f": ("embed",),
           "blocks": blk}
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    if cfg.prefix_patches:
        out["patch_proj"] = ("embed", "embed2")
    return out


def param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> PyTree:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    storage), quantized as serving would when ``QUANT_BITS`` is set."""
    p = init_params(cfg, generator=L.MetaDraw(dtype))
    return quantize_for_serving(p, QUANT_BITS) if QUANT_BITS else p


def input_specs(cfg: ArchConfig, shape, param_dtype=torch.bfloat16) -> dict:
    """A cell's model inputs as ``meta`` tensors: ``batch`` (train,
    prefill), ``token`` and ``pos`` (decode) and the bf16 ``cache``
    (prefill, decode)."""
    b, s = shape.global_batch, shape.seq_len

    def f(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    out: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeddings":
            batch = {"embeds": f((b, s, cfg.d_model), param_dtype)}
        else:
            toks = s - cfg.prefix_patches
            batch = {"tokens": f((b, toks), torch.int32)}
            if cfg.prefix_patches:
                batch["patches"] = f((b, cfg.prefix_patches, cfg.d_model),
                                     param_dtype)
        if shape.kind == "train":
            batch["labels"] = f((b, s if cfg.input_mode == "embeddings"
                                 else s - cfg.prefix_patches), torch.int32)
        out["batch"] = batch
    else:
        out["token"] = (f((b, 1, cfg.d_model), param_dtype)
                        if cfg.input_mode == "embeddings"
                        else f((b, 1), torch.int32))
        out["pos"] = f((), torch.int32)
    if shape.kind != "train":
        out["cache"] = init_cache(cfg, b, s, torch.bfloat16, device="meta")
    return out


# ---------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device=None) -> PyTree:
    """Per layer its KV cache, its SSM and conv state, or both (Hymba).
    A ``layer_types`` model holds KV for its attention layers alone, SSM
    / conv state for its Mamba layers alone, and for its latent-attention
    layers alone ``"mla"``: (latent (L, batch, seq, kv_lora_rank), rotary
    key (L, batch, seq, qk_rope_head_dim)), each stacked in layer
    order."""
    dev = resolve_device(device)
    cache = {}
    nl = cfg.n_layers
    n_attn = cfg.n_layers_of("attention") if cfg.layer_types else nl
    n_ssm = cfg.n_layers_of("mamba") if cfg.layer_types else nl
    if not cfg.attention_free and n_attn:
        kv_shape = (n_attn, batch, seq, cfg.n_kv_heads, cfg.d_head)
        kv_dtype = torch.int8 if KV_QUANT else dtype
        cache["kv"] = (torch.zeros(kv_shape, dtype=kv_dtype, device=dev),
                       torch.zeros(kv_shape, dtype=kv_dtype, device=dev))
        if KV_QUANT:
            s_shape = (nl, batch, 1, cfg.n_kv_heads, 1)
            cache["kv_scale"] = (
                torch.ones(s_shape, dtype=torch.float32, device=dev),
                torch.ones(s_shape, dtype=torch.float32, device=dev))
    if cfg.ssm is not None and n_ssm:
        nh = cfg.n_ssm_heads
        p = cfg.ssm.head_dim
        cache["ssm"] = torch.zeros((n_ssm, batch, nh, p, cfg.ssm.state_dim),
                                   dtype=torch.float32, device=dev)
        conv_dim = cfg.d_inner + 2 * cfg.ssm.state_dim
        cache["conv"] = torch.zeros(
            (n_ssm, batch, cfg.ssm.conv_kernel - 1, conv_dim), dtype=dtype,
            device=dev)
    n_mla = cfg.n_layers_of("mla")
    if n_mla:
        cache["mla"] = tuple(
            torch.zeros((n_mla, batch, seq, w), dtype=dtype, device=dev)
            for w in (cfg.kv_lora_rank, cfg.qk_rope_head_dim))
    return cache


def _serve_scan(cfg: ArchConfig, params, x, positions, cache, pos):
    """The layers over ``x`` with each layer's cache slice updated in
    place; returns (x, cache)."""
    if cfg.layer_types:
        return _mixed_serve_scan(cfg, params, x, positions, cache, pos)
    kinds = layer_kinds(cfg)
    for i in range(cfg.n_layers):
        lc = {}
        if "kv" in cache:
            lc["kv"] = (cache["kv"][0][i], cache["kv"][1][i])
            if "kv_scale" in cache:
                lc["kv_scale"] = (cache["kv_scale"][0][i],
                                  cache["kv_scale"][1][i])
        if "ssm" in cache:
            lc["ssm"] = cache["ssm"][i]
            lc["conv"] = cache["conv"][i]
        x, _, new_lc = _block_apply(cfg, _layer(params["blocks"], i),
                                    kinds[i], x, positions, cache=lc,
                                    pos=pos)
        if "kv_scale" in new_lc and new_lc["kv_scale"] is not \
                lc["kv_scale"]:
            for dst, src in zip(lc["kv_scale"], new_lc["kv_scale"]):
                dst.copy_(src)
        if "ssm" in new_lc:
            lc["ssm"].copy_(new_lc["ssm"])
            lc["conv"].copy_(new_lc["conv"])
    return x, cache


def _mixed_serve_scan(cfg: ArchConfig, params, x, positions, cache, pos):
    """:func:`_serve_scan` for a ``layer_types`` model: an attention layer
    writes its row of the KV cache, a Mamba layer its row of the SSM and
    conv state, a latent-attention layer its row of the latent cache."""
    for i, (kind, j) in enumerate(mixer_slots(cfg)):
        if kind == "attention":
            lc = {"kv": (cache["kv"][0][j], cache["kv"][1][j])}
        elif kind == "mla":
            lc = {"mla": (cache["mla"][0][j], cache["mla"][1][j])}
        else:
            lc = {"ssm": cache["ssm"][j], "conv": cache["conv"][j]}
        x, _, new_lc = _mixed_block_apply(
            cfg, _mixed_layer(cfg, params["blocks"], i, kind, j), x,
            positions, cache=lc, pos=pos)
        if "ssm" in new_lc:
            lc["ssm"].copy_(new_lc["ssm"])
            lc["conv"].copy_(new_lc["conv"])
    return x, cache


def prefill(cfg: ArchConfig, params, batch, cache):
    """Process the prompt, fill the cache.  Returns (last_logits, cache)."""
    x, positions = _embed_inputs(cfg, params, batch)
    x, cache = _serve_scan(cfg, params, x, positions, cache, pos=0)
    return _head(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ArchConfig, params, cache, token, pos):
    """One decode step.  token (B, 1) int or embeds (B, 1, d); pos a
    scalar or one position per row (B,).

    This is the PIM-offload target: with batch B it is a batch of GEMVs
    against every projection matrix (see serving/offload.py).
    """
    if cfg.input_mode == "embeddings":
        x = token  # (B, 1, d) frame embedding (modality stub)
    else:
        x = _embed_tokens(params, token, cfg)
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    positions = torch.broadcast_to(pos[None], (b, 1)) if pos.ndim == 0 \
        else pos[:, None]
    x, cache = _serve_scan(cfg, params, x, positions, cache, pos=pos)
    return _head(cfg, params, x)[:, 0], cache


def quantize_for_serving(params, w_bits: int):
    """Quantize matmul weights (embedding stays 8-bit for row gather)."""
    emb = params.get("embed")
    out = Q.quantize_params(params, w_bits)
    if w_bits == 4 and emb is not None:
        out["embed"] = Q.quantize_params({"embed": emb}, 8)["embed"]
    return out

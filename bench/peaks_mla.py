"""The model FLOPs of DeepSeek-V3's served tokens (latent attention in
every layer, dense layers, then expert-parallel MoE layers with a shared
expert), computed from its shapes.

Everything but the routed experts and attention is counted per token
from the configuration: latent attention's projections (``q_a``,
``q_b``, ``kv_a``, ``o``, and ``kv_b``'s expansion over a prompt or the
absorbed decode's two per-head products, the same count), the dense
layers' SwiGLU, the MoE layers' router and shared expert, and the
output head (a prefill's last token only).  Attention is counted from
the program's ``mla.attended_positions`` counter (key positions
attended, over query rows and layers): a prompt's positions, counted
here from its length, at the expanded form's ``2 * heads * (qk + v)``
a position, the rest (decode's) at the absorbed form's
``2 * heads * (2 * latent + rope)``.  The routed experts are
``6 * d_model * expert width`` for each assignment to an expert held
here (``moe.assignments_held``), so the dropless buffer's padding rows,
which the matmuls also compute, are not counted.
"""
from __future__ import annotations


def _mla(cfg: dict) -> tuple:
    return (cfg["n_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["kv_lora_rank"], cfg["v_head_dim"], cfg["q_lora_rank"])


def token_flops(cfg: dict) -> int:
    """One token through every layer, routed experts, attention and the
    head aside."""
    h, nope, rope, kv, dv, q = _mla(cfg)
    d, L = cfg["d_model"], cfg["n_layers"]
    dense = cfg["first_k_dense_replace"]
    m = cfg["moe"]
    mla = 2 * (d * q + q * h * (nope + rope) + d * (kv + rope)
               + kv * h * (nope + dv) + h * dv * d)
    moe = 2 * d * m["router_experts"] + 6 * d * m["shared_d_ff"]
    return L * mla + dense * 6 * d * cfg["d_ff"] + (L - dense) * moe


def head_flops(cfg: dict) -> int:
    return 2 * cfg["d_model"] * (-(-cfg["vocab"] // 256) * 256)


def prompt_positions(cfg: dict, prompt: int) -> int:
    """Key positions a prompt's causal attention attends, every layer."""
    return cfg["n_layers"] * prompt * (prompt + 1) // 2


def attention_flops(cfg: dict, prompt_positions: int,
                    decode_positions: int) -> int:
    """Scores and weighted values over attended positions: a prompt's in
    the expanded form, decode's in the absorbed form."""
    h, nope, rope, kv, dv, _q = _mla(cfg)
    return (2 * h * (nope + rope + dv) * int(prompt_positions)
            + 2 * h * (2 * kv + rope) * int(decode_positions))


def prefill_flops(cfg: dict, prompt: int) -> int:
    """A prompt's prefill, routed experts and attention aside."""
    return token_flops(cfg) * prompt + head_flops(cfg)


def decode_flops(cfg: dict, active: int) -> int:
    """One decode step over ``active`` slots, routed experts and
    attention aside."""
    return active * (token_flops(cfg) + head_flops(cfg))


def expert_flops(cfg: dict, assignments_held: int) -> int:
    """The routed experts' SwiGLU for each assignment held here."""
    return 6 * cfg["d_model"] * cfg["moe"]["expert_d_ff"] * int(
        assignments_held)

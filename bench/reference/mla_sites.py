"""The decode GEMV sites of DeepSeek-V3 (latent attention in every layer,
dense layers, then MoE layers with a shared expert), priced as
``sim.plan`` prices a dense model's: each site on PIM (reshaped below
2048 rows) and on the host.

The sites are the published model's, read from the configuration file:
its whole depth (``total_layers``, every layer latent attention), the
dense MLP in its first ``first_k_dense_replace`` layers, and in every
other layer the router over every expert (``moe.router_experts``), the
top-k routed experts and the shared expert; what share of the layers
and experts a chip holds does not change them.  Latent attention's
decode multiplies the query projections (``q_a``, ``q_b``), ``kv_a``,
each head's query into the latent (``q_absorb``: kv_lora_rank x
qk_nope_head_dim) and its weighted latent out of it (``v_absorb``:
v_head_dim x kv_lora_rank), and ``o``: the absorbed form needs no
``kv_b`` pass.
"""
from __future__ import annotations

from . import sim


def decode_sites(cfg: dict) -> list:
    """The weight matrices one decode token multiplies, layers folded."""
    L = cfg["total_layers"] or cfg["n_layers"]
    dense = cfg["first_k_dense_replace"]
    d, ff, h = cfg["d_model"], cfg["d_ff"], cfg["n_heads"]
    m = cfg["moe"]
    k, e_ff, shared = m["top_k"], m["expert_d_ff"], m["shared_d_ff"]
    q, kv = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    moe = L - dense
    return [sim.Site("mla.q_a", q, d, L),
            sim.Site("mla.q_b", h * (nope + rope), q, L),
            sim.Site("mla.kv_a", kv + rope, d, L),
            sim.Site("mla.q_absorb", kv, nope, L * h),
            sim.Site("mla.v_absorb", dv, kv, L * h),
            sim.Site("mla.o", d, h * dv, L),
            sim.Site("mlp.w0", ff, d, dense),
            sim.Site("mlp.w1", ff, d, dense),
            sim.Site("mlp.wo", d, ff, dense),
            sim.Site("moe.router", m["router_experts"], d, moe),
            sim.Site("moe.w0", e_ff, d, moe * k),
            sim.Site("moe.w1", e_ff, d, moe * k),
            sim.Site("moe.wo", d, e_ff, moe * k),
            sim.Site("moe.shared.w0", shared, d, moe),
            sim.Site("moe.shared.w1", shared, d, moe),
            sim.Site("moe.shared.wo", d, shared, moe),
            sim.Site("lm_head", -(-cfg["vocab"] // 256) * 256, d, 1)]


def plan(cfg: dict, spec: sim.Spec, dtype: str = "W8A8", fence: bool = True,
         float_bits: int = 64) -> list:
    """A spec's decision for every site, in site order (``sim.plan``'s
    rule); ``float_bits=32`` prices in float32 (the control)."""
    out = []
    for site in decode_sites(cfg):
        reshape = site.h < 2048
        pim = sim.point("pim", site.h, site.w, dtype, spec, fence, reshape,
                        float_bits)
        base = sim.point("baseline", site.h, site.w, dtype, spec,
                         float_bits=float_bits)
        out.append(sim.Decision(site, pim.ns, base.ns, reshape,
                                max(1, int(base.ns / pim.ns))))
    return out

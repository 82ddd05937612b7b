"""DeepSeek-V3 [hf:deepseek-ai/DeepSeek-V3] — multi-head latent attention
in every layer (128 heads; queries through a 1536 bottleneck, keys and
values from a 512 latent and one 64-wide rotary key, YaRN x40), three
dense SwiGLU layers (18432), then MoE layers of 256 routed experts
(2048), top-8 by the sigmoid group-limited router (8 groups, the best 4
kept, gates normalised and x2.5), and one shared expert.

This chip's share of a deployment of 4 pipeline stages (layers 16 / 15
/ 15 / 15) x 32-way expert parallelism, 128 chips: stage 1 (layers
0-15: the three dense layers and 13 MoE layers) and experts 0-7 of each
of its MoE layers.  Latent attention, the dense layers, the router and
the shared expert are whole; the embedding is here, and so is the
output head (stage 4's), so logits can be judged.  The router keeps
its 256 outputs, its groups and its top-8; the multi-token prediction
module is not served.
"""
from .base import ArchConfig, MoeConfig, RopeScaling

CONFIG = ArchConfig(
    name="deepseek-v3", family="moe_mla",
    n_layers=16, d_model=7168, n_heads=128, n_kv_heads=128, d_head=192,
    d_ff=18432, vocab=129280, mlp="swiglu", tie_embeddings=False,
    rope_theta=10000.0, norm_eps=1e-6,
    moe=MoeConfig(n_experts=8, top_k=8, router_experts=256,
                  first_expert=0, shared_d_ff=2048, expert_d_ff=2048,
                  scoring_func="sigmoid", n_group=8, topk_group=4,
                  norm_topk_prob=True, routed_scaling_factor=2.5),
    layer_types=("mla",) * 16, first_k_dense_replace=3,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, rope_interleave=True,
    rope_scaling=RopeScaling(type="yarn", factor=40.0,
                             original_max_position_embeddings=4096,
                             beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                             mscale_all_dim=1.0),
    total_layers=61,
    source="hf:deepseek-ai/DeepSeek-V3",
    notes="latent attention (512 latent + 64 rotary key cached a "
          "position) in every layer; 3 dense layers, then 256-expert "
          "top-8 sigmoid group-limited MoE layers with a shared expert; "
          "pipeline stage 1 (16 of 61 layers) holding experts 0-7 of 256 "
          "(32-way expert parallel)",
)

"""DBRX-132B [hf:databricks/dbrx-base; unverified] — 16e top-4 MoE."""
from .base import ArchConfig, MoeConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=10752, vocab=100352, mlp="swiglu",
    moe=MoeConfig(n_experts=16, top_k=4),
    source="hf:databricks/dbrx-base; unverified",
    notes="fine-grained 16-expert top-4",
)

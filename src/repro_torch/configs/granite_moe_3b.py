"""Granite-MoE-3B-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ArchConfig, MoeConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155, mlp="swiglu",
    moe=MoeConfig(n_experts=40, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    notes="fine-grained 40-expert top-8 MoE; per-expert d_ff=512 is the "
          "paper's reshape-optimization regime (W<2048)",
)

"""Hymba-1.5B [arXiv:2411.13676; hf] — parallel attention + mamba heads."""
from .base import ArchConfig, SsmConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab=32001, mlp="swiglu",
    sliding_window=2048, global_every=16,  # a few global layers
    ssm=SsmConfig(state_dim=16, head_dim=64, expand=1),
    source="arXiv:2411.13676; hf",
    notes="parallel attn+mamba heads per layer; SWA + sparse global",
)

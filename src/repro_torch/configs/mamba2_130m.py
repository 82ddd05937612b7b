"""Mamba2-130M [arXiv:2405.21060; unverified] — SSD, attention-free."""
from .base import ArchConfig, SsmConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=50280, mlp="swiglu",
    ssm=SsmConfig(state_dim=128, head_dim=64, expand=2),
    source="arXiv:2405.21060; unverified",
    notes="SSD (state-space duality); attn-free, d_ff=0 (no MLP block)",
)

"""InternVL2-26B [arXiv:2404.16821; hf] — InternViT + InternLM2 backbone.

Backbone only (InternLM2-20B-style GQA decoder); the InternViT frontend is
a stub supplying `prefix_patches` precomputed patch embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=92553, mlp="swiglu",
    prefix_patches=256,
    source="arXiv:2404.16821; hf",
    notes="VLM backbone; patch embeddings stubbed via input_specs()",
)

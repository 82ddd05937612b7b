"""Gemma3-4B [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=10240, vocab=262144, mlp="swiglu", tie_embeddings=True,
    sliding_window=1024, global_every=6,  # 5 local : 1 global
    rope_theta=1e6,
    source="hf:google/gemma-3-1b-pt; unverified",
    notes="5:1 local:global sliding window, 128k context",
)

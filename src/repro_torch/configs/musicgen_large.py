"""MusicGen-large [arXiv:2306.05284; hf] — decoder over EnCodec tokens.

Backbone only: the EnCodec frontend is a stub; ``input_specs`` feeds
precomputed frame embeddings (input_mode='embeddings')."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="dense",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048, mlp="gelu", input_mode="embeddings",
    source="arXiv:2306.05284; hf",
    notes="audio decoder-only over EnCodec tokens; frontend stubbed",
)

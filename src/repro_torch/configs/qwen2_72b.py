"""Qwen2-72B [arXiv:2407.10671; hf] — dense GQA with QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=29568, vocab=152064, qkv_bias=True, mlp="swiglu",
    rope_theta=1e6, source="arXiv:2407.10671; hf",
    notes="GQA kv=8, QKV bias",
)

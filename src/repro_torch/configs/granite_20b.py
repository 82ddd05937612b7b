"""Granite-20B code [arXiv:2405.04324; hf] — MQA (kv=1)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab=49152, mlp="gelu",
    source="arXiv:2405.04324; hf",
    notes="gpt_bigcode-style: MQA (kv=1), GELU FFN (d_ff=4d); RoPE used "
          "in place of learned positions (documented deviation)",
)

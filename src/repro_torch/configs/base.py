"""Architecture / run configuration dataclasses.

Every supported architecture is an :class:`ArchConfig` in its own module
(``configs/<id>.py``); the offload planner reads its GEMV shapes.  The
input shapes are :class:`ShapeConfig` entries; which shapes an arch
supports (decode vs train, sub-quadratic requirements) is derived here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    state_dim: int
    head_dim: int = 64
    conv_kernel: int = 4
    expand: int = 2          # d_inner = expand * d_model
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    mlp: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    # sliding-window pattern: window size + every Nth layer global
    sliding_window: Optional[int] = None
    global_every: int = 0           # 0 = all layers global (full attn)
    moe: Optional[MoeConfig] = None
    ssm: Optional[SsmConfig] = None
    input_mode: str = "tokens"      # tokens | embeddings (modality stub)
    prefix_patches: int = 0         # VLM: patch embeddings before tokens
    # annotations
    source: str = ""
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window-local)."""
        return self.family in ("ssm", "hybrid") or \
            self.sliding_window is not None

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        per = 2 * d  # norms
        if not self.attention_free:
            per += d * self.n_heads * self.d_head   # q
            per += 2 * d * self.n_kv_heads * self.d_head  # k, v
            per += self.n_heads * self.d_head * d   # o
        if self.family == "moe":
            e = self.moe.n_experts
            per += d * e  # router
            per += e * 3 * d * self.d_ff
        elif self.d_ff > 0:
            mult = 3 if self.mlp == "swiglu" else 2
            per += mult * d * self.d_ff
        if self.ssm is not None:
            di = self.d_inner
            s = self.ssm.state_dim
            per += d * (2 * di + 2 * s + self.n_ssm_heads)  # in_proj
            per += di * d                                   # out_proj
            per += self.ssm.conv_kernel * (di + 2 * s)      # conv
            per += 2 * self.n_ssm_heads                     # A, D
        return n + L * per

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6*N_active*D)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        total = self.param_count()
        e, k = self.moe.n_experts, self.moe.top_k
        expert_params = L * e * 3 * d * self.d_ff
        return total - expert_params + expert_params * k // e


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> list[str]:
    """The shapes an arch runs: all but ``long_500k``, which needs a
    sub-quadratic arch."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=2,
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=32,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab=512,
        prefix_patches=8 if cfg.prefix_patches else 0,
    )
    if cfg.moe:
        changes["moe"] = MoeConfig(n_experts=4, top_k=2,
                                   capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm:
        changes["ssm"] = SsmConfig(state_dim=16, head_dim=32,
                                   conv_kernel=cfg.ssm.conv_kernel,
                                   expand=2, chunk=32)
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    return dataclasses.replace(cfg, **changes)

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
    n_experts: int                  # experts held here
    top_k: int
    capacity_factor: float = 1.25
    # Expert parallelism: the router's width (every expert of the layer;
    # None: the experts held here are all of them) and the first expert
    # held here, so this chip holds experts
    # [first_expert, first_expert + n_experts).
    router_experts: Optional[int] = None
    first_expert: int = 0
    # width of the shared SwiGLU expert every token passes (0: none)
    shared_d_ff: int = 0
    # width of one routed expert (0: the model's d_ff)
    expert_d_ff: int = 0
    # The router's rule.  "softmax": the top_k logits, their gates the
    # softmax over those k.  "sigmoid" (DeepSeek-V3's noaux_tc): scores
    # sigmoid(logit); the choice ranks score + a per-expert bias, among
    # the topk_group of n_group groups whose two best biased scores sum
    # highest; the gates are the chosen experts' unbiased scores,
    # normalised to sum 1 when norm_topk_prob, times
    # routed_scaling_factor.  The names are the published configs' keys.
    scoring_func: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0

    @property
    def n_routed(self) -> int:
        """Experts the router chooses among."""
        return self.router_experts or self.n_experts


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    state_dim: int
    head_dim: int = 64
    conv_kernel: int = 4
    expand: int = 2          # d_inner = expand * d_model
    chunk: int = 256
    # gated RMSNorm: False normalizes y, then multiplies by silu(z);
    # True multiplies first (Mamba-2's published order)
    gate_before_norm: bool = False
    norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN's context extension of rotary embeddings (the published
    configs' ``rope_scaling`` group, under its keys): frequencies
    interpolated by ``factor`` below ``beta_slow`` rotations over
    ``original_max_position_embeddings`` positions, kept above
    ``beta_fast``, ramped between; attention scores times
    ``(0.1 * mscale_all_dim * ln(factor) + 1) ** 2``."""
    type: str = "yarn"
    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


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
    # Layers of mixed kinds: each layer's mixer, "mamba", "attention" or
    # "mla", followed by the MoE, or by a dense MLP of d_ff in the first
    # first_k_dense_replace layers (empty: every layer is the family's
    # one kind).  The names below are the published configs' keys.
    layer_types: tuple = ()
    first_k_dense_replace: int = 0
    # Multi-head latent attention (mixer "mla", DeepSeek-V2/V3): queries
    # through a q_lora_rank bottleneck; keys and values from one
    # kv_lora_rank latent a position, which the cache holds with one
    # rotary key of qk_rope_head_dim shared by every head.  A head's
    # query and key are qk_nope_head_dim + qk_rope_head_dim wide, its
    # value v_head_dim.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # rotary over interleaved pairs (x[2i], x[2i+1]) rather than halves
    rope_interleave: bool = False
    rope_scaling: Optional[RopeScaling] = None
    # The whole model's depth where this configuration holds one
    # pipeline stage's layers (0: it holds them all); layers past the
    # stage are of its last layer's kind.  The planner prices the whole
    # model's decode GEMVs.
    total_layers: int = 0
    position_embedding_type: str = "rope"   # rope | nope
    # muP scalars: embeddings times embedding_multiplier, each branch
    # times residual_multiplier, attention scores times
    # attention_multiplier (None: 1/sqrt(d_head)), logits divided by
    # logits_scaling
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0
    # annotations
    source: str = ""
    notes: str = ""

    def __post_init__(self):
        # built from plain data too (a JSON config): groups as dicts,
        # sequences as lists
        if isinstance(self.moe, dict):
            object.__setattr__(self, "moe", MoeConfig(**self.moe))
        if isinstance(self.ssm, dict):
            object.__setattr__(self, "ssm", SsmConfig(**self.ssm))
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               RopeScaling(**self.rope_scaling))
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.layer_types and len(self.layer_types) != self.n_layers:
            raise ValueError(f"{self.name}: {len(self.layer_types)} "
                             f"layer types for {self.n_layers} layers")

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

    def n_layers_of(self, kind: str) -> int:
        """Layers whose mixer is ``kind`` ("mamba" / "attention" /
        "mla")."""
        return sum(t == kind for t in self.layer_types)

    def total_layers_of(self, kind: str) -> int:
        """:meth:`n_layers_of` over the whole model (``total_layers``)."""
        past = max(0, self.total_layers - self.n_layers)
        return self.n_layers_of(kind) + past * (
            bool(self.layer_types) and self.layer_types[-1] == kind)

    @property
    def expert_d_ff(self) -> int:
        """The width of one routed expert."""
        return (self.moe.expert_d_ff if self.moe else 0) or self.d_ff

    @property
    def qk_head_dim(self) -> int:
        """A latent-attention head's query and key width."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        if self.layer_types:
            return n + d + self._mixed_layer_params()    # d: final norm
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

    def _attn_params(self) -> int:
        d, hq, hkv, hd = self.d_model, self.n_heads, self.n_kv_heads, \
            self.d_head
        return 2 * d * hq * hd + 2 * d * hkv * hd

    def _ssm_params(self) -> int:
        d, di, s, nh = self.d_model, self.d_inner, self.ssm.state_dim, \
            self.n_ssm_heads
        conv = (self.ssm.conv_kernel + 1) * (di + 2 * s)
        return d * (2 * di + 2 * s + nh) + di * d + conv + 3 * nh + di

    def _mla_params(self) -> int:
        d, h, q, kv = self.d_model, self.n_heads, self.q_lora_rank, \
            self.kv_lora_rank
        return (d * q + q + q * h * self.qk_head_dim
                + d * (kv + self.qk_rope_head_dim) + kv
                + kv * h * (self.qk_nope_head_dim + self.v_head_dim)
                + h * self.v_head_dim * d)

    def _mixed_layer_params(self) -> int:
        """Every layer of a ``layer_types`` model: its mixer, its FFN
        (the dense MLP, or the MoE: the experts held here, the router,
        the router's bias, the shared expert) and norms."""
        d, m, k = self.d_model, self.moe, self.first_k_dense_replace
        moe = d * m.n_routed + 3 * d * (m.n_experts * self.expert_d_ff
                                        + m.shared_d_ff)
        if m.scoring_func == "sigmoid":
            moe += m.n_routed
        mixers = {"attention": self._attn_params, "mamba": self._ssm_params,
                  "mla": self._mla_params}
        return (self.n_layers * 2 * d + (self.n_layers - k) * moe
                + k * 3 * d * self.d_ff
                + sum(n * mixers[kind]() for kind in mixers
                      if (n := self.n_layers_of(kind))))

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
        if cfg.moe.router_experts:
            # half of 8 routed experts held, beside a shared expert
            changes["moe"] = dataclasses.replace(
                changes["moe"], router_experts=8,
                shared_d_ff=min(cfg.moe.shared_d_ff, 512))
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=32, expand=2, chunk=32)
    if cfg.kv_lora_rank:
        # a dense layer, then three MoE layers, every one latent
        # attention with both bottlenecks; 16 routed experts in 4 groups
        # (the best 2 kept), top-4, experts 4-7 held here
        changes.update(
            n_layers=4, layer_types=("mla",) * 4, first_k_dense_replace=1,
            n_kv_heads=changes["n_heads"], q_lora_rank=48, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            d_head=24, total_layers=0)
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=4, router_experts=16,
            first_expert=4, shared_d_ff=64, expert_d_ff=64, n_group=4,
            topk_group=2)
    elif cfg.layer_types:
        # the published pattern around its first attention layer: two
        # mamba layers, the attention layer, a mamba layer
        a = cfg.layer_types.index("attention")
        changes["layer_types"] = cfg.layer_types[max(0, a - 2):a + 2]
        changes["n_layers"] = len(changes["layer_types"])
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    return dataclasses.replace(cfg, **changes)

"""Roofline math: an NVIDIA H100 hardware model + analytic MODEL_FLOPS.

Terms (per device, seconds):
    compute    = traced FLOPs / (chips * PEAK_FLOPS)     [bf16 tensor cores]
    memory     = traced bytes / (chips * HBM_BW)         [HBM bandwidth]
    collective = collective bytes / (chips * LINK_BW)    [one link]

MODEL_FLOPS is the *useful* work: 6·N_active·tokens for training,
2·N_active·tokens (+ attention and SSD terms) for inference — the ratio
MODEL_FLOPS / HLO_FLOPs exposes remat/redundancy waste.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig

# Spec-sheet figures for an NVIDIA H100 80GB HBM3 (SXM, 700 W), not
# measurements.
PEAK_FLOPS = 989e12       # bf16 dense tensor cores, FLOP/s per GPU
HBM_BW = 3.35e12          # bytes/s per GPU
# The collective link (the counterpart of a TPU's ICI_BW): one 400 Gb/s
# NDR InfiniBand port per GPU.  The 16-way "model" axis spans two 8-GPU
# NVLink nodes, so the inter-node link bounds it.
LINK_BW = 50e9            # bytes/s per link


def attention_context(cfg: ArchConfig, s: int) -> float:
    """Mean effective context per layer (sliding windows clamp it)."""
    if cfg.attention_free:
        return 0.0
    import numpy as _np
    kinds = _np.arange(cfg.n_layers)
    if cfg.sliding_window is None or cfg.global_every == 0:
        return float(s) * cfg.n_layers
    is_global = (kinds % cfg.global_every) == cfg.global_every - 1
    ctx = _np.where(is_global, s, min(s, cfg.sliding_window))
    return float(ctx.sum())


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    b, s = shape.global_batch, shape.seq_len
    n_act = cfg.active_param_count()
    hq, hd = cfg.n_heads, cfg.d_head
    if shape.kind == "train":
        tokens = b * s
        flops = 6.0 * n_act * tokens
        # causal attention fwd+bwd: 12 * B * S * ctx/2 * H * hd
        flops += 12.0 * b * s * attention_context(cfg, s) / 2 * hq * hd
        if cfg.ssm is not None:
            flops += 30.0 * b * s * cfg.n_layers * cfg.n_ssm_heads * \
                cfg.ssm.head_dim * cfg.ssm.state_dim
        return flops
    if shape.kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_act * tokens
        flops += 4.0 * b * s * attention_context(cfg, s) / 2 * hq * hd
        if cfg.ssm is not None:
            flops += 10.0 * b * s * cfg.n_layers * cfg.n_ssm_heads * \
                cfg.ssm.head_dim * cfg.ssm.state_dim
        return flops
    # decode: one token over a seq_len cache
    flops = 2.0 * n_act * b
    flops += 4.0 * b * attention_context(cfg, s) * hq * hd
    if cfg.ssm is not None:
        flops += 10.0 * b * cfg.n_layers * cfg.n_ssm_heads * \
            cfg.ssm.head_dim * cfg.ssm.state_dim
    return flops


FLASH_BLOCK = 512          # layers.flash_attention default block size
FLASH_SKIP_BLOCKS = False  # Perf knob: causal/window block skipping


def attention_hlo_flops(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """White-box account of the blockwise-attention FLOPs.

    ``cost_analysis`` counts the flash inner scans once; the *executed*
    work is ``n_executed_blocks x per-block``.  Without block skipping
    the implementation computes every (q-block, k-block) pair (masking
    only); with FLASH_SKIP_BLOCKS the causal upper triangle and
    out-of-window blocks are skipped — this function is the measurement
    hook that makes that optimization visible in the roofline.

    Returns global-FLOP figures: total, counted-once (already inside the
    probe numbers), and the delta to add.
    """
    b, s = shape.global_batch, shape.seq_len
    if cfg.attention_free or shape.kind == "decode" or \
            s <= 2048:  # dense path: probes count it exactly
        return dict(total_global=0.0, counted_once_global=0.0,
                    added_global=0.0)
    bq = bk = FLASH_BLOCK
    nq = -(-s // bq)
    nk = -(-s // bk)
    per_block = 4.0 * b * bq * bk * cfg.n_heads * cfg.d_head
    mult = 4.0 if shape.kind == "train" else 1.0   # remat + bwd
    total = 0.0
    import numpy as _np
    kinds = _np.arange(cfg.n_layers)
    if cfg.sliding_window is not None and cfg.global_every:
        is_global = (kinds % cfg.global_every) == cfg.global_every - 1
    else:
        is_global = _np.ones(cfg.n_layers, dtype=bool)
    for g in is_global:
        if not FLASH_SKIP_BLOCKS:
            nblk = nq * nk
        else:
            nblk = nq * (nq + 1) // 2              # causal triangle
        total += nblk * per_block * mult
    # cost_analysis counts each lax.scan body once: the rolled variant
    # has ONE inner scan; the static-q skip variant has nq of them.
    bodies = nq if FLASH_SKIP_BLOCKS else 1
    counted_once = cfg.n_layers * bodies * per_block * mult
    return dict(total_global=total, counted_once_global=counted_once,
                added_global=total - counted_once)


def min_traffic_bytes(cfg: ArchConfig, shape: ShapeConfig,
                      data_axis: int = 16, remat: str = "full") -> float:
    """Per-device lower-bound HBM traffic of one step (bytes).

    State footprints come from the *actual sharding rules*
    (``sharding.state_bytes_per_device``): each device reads its param /
    opt / cache shard (replicated state is read per device — small archs
    without FSDP pay it) and writes the updated state; saved layer inputs
    under the remat policy add write+read traffic.  This is the
    fusion-independent floor the memory roofline term uses (XLA's 'bytes
    accessed' is a no-fusion upper bound, reported separately).
    """
    from repro_torch.distribution.sharding import (MeshShape,
                                             state_bytes_per_device,
                                             tp_rules)
    st = state_bytes_per_device(cfg, shape)
    mesh = MeshShape({"data": 16, "model": 16})
    rules = tp_rules(cfg, mesh, shape.kind)
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    # FSDP gathers materialize model-sharded full weights in HBM each
    # step: write + read of params_total / model_axis per device.
    gathered = 0.0
    if rules.get("embed") == "data":
        gathered = cfg.param_count() * 2 / mesh.shape["model"]
    if shape.kind == "train":
        total = 2 * (st["params"] + st["opt"]) + st["grads"]
        total += 3 * gathered        # fwd + remat recompute + bwd use
        # saved activations: layer inputs (remat full) or all residuals
        mult = 2 if remat != "none" else 8
        total += mult * cfg.n_layers * b * s * d * 2 / data_axis
        total += 2 * b * s * 4 / data_axis
    elif shape.kind == "prefill":
        total = st["params"] + 2 * gathered + 2 * st["cache"] \
            + b * s * d * 2 / data_axis
    else:  # decode: read params + cache once, write one cache slot
        total = st["params"] + 2 * gathered + st["cache"] + b * d * 2
    return float(total)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # traced FLOPs (the JAX package's HLO FLOPs)
    hlo_bytes: float          # traced bytes accessed (no-fusion UPPER bound)
    coll_bytes: float
    model_flops: float
    traffic_dev: float = 0.0  # per-device min-traffic floor (memory term)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        if self.traffic_dev > 0:
            return self.traffic_dev / HBM_BW
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput / peak, if bound by the dominant term."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / max(t, 1e-30)

    def row(self) -> dict:
        return dict(arch=self.arch, shape=self.shape, mesh=self.mesh,
                    chips=self.chips,
                    t_compute_s=self.t_compute, t_memory_s=self.t_memory,
                    t_collective_s=self.t_collective,
                    bottleneck=self.bottleneck,
                    model_flops=self.model_flops, hlo_flops=self.hlo_flops,
                    hlo_bytes=self.hlo_bytes, coll_bytes=self.coll_bytes,
                    traffic_dev=self.traffic_dev,
                    useful_ratio=self.useful_ratio,
                    roofline_fraction=self.roofline_fraction)

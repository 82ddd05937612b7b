"""The yardstick: published peaks of the card, and the operations and
bytes the measured work needs, computed from its shapes.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full 700 W
power limit, dense (no sparsity).  A share of a peak is stated with the
card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # device memory
FP32_FLOPS = 67e12               # float32 outside the tensor cores

LANE_ROW_BYTES = 16              # one command: four int32 fields
LANE_CYC_BYTES = 28 * 4          # one lane's packed timing row


def lane_scan_bytes(lengths, need_issue: bool = False) -> int:
    """Bytes one lane-scan launch needs, each read or written once: every
    lane's true commands, its timing row and length, its total, and its
    issue cycles when asked for.  NOP padding is not needed work."""
    commands = int(sum(int(n) for n in lengths))
    f = len(lengths)
    out = commands * LANE_ROW_BYTES + f * (LANE_CYC_BYTES + 4 + 4)
    if need_issue:
        out += commands * 4
    return out


def matmul_params(cfg: dict) -> tuple[int, int]:
    """(weights multiplied per token in the layers, in the output head)
    of a dense decoder."""
    d, L = cfg["d_model"], cfg["n_layers"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    mult = 3 if cfg.get("mlp", "swiglu") == "swiglu" else 2
    layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + mult * d * cfg["d_ff"]
    vocab = -(-cfg["vocab"] // 256) * 256
    return L * layer, d * vocab


def attention_flops(cfg: dict, context: int) -> int:
    """Scores and weighted values of one query token over ``context``
    positions, every layer."""
    return 4 * cfg["n_layers"] * cfg["n_heads"] * cfg["d_head"] * context


def prefill_flops(cfg: dict, prompt: int) -> int:
    """A prompt's prefill: every token through the layers over its causal
    context, and the output head for the last token only."""
    layers, head = matmul_params(cfg)
    attn = attention_flops(cfg, 1) * prompt * (prompt + 1) // 2
    return 2 * layers * prompt + attn + 2 * head


def decode_flops(cfg: dict, positions) -> int:
    """One decode step: each active slot's token through the layers and
    the head, attending over its context (its position plus one)."""
    layers, head = matmul_params(cfg)
    return sum(2 * (layers + head) + attention_flops(cfg, int(p) + 1)
               for p in positions)

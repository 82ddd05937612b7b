"""Plain float32 forward pass of a dense decoder (granite-8b's
architecture), for judging served tokens.

Written from the published description in plain torch: token embedding;
per layer an RMS-normed residual branch of grouped-query causal attention
with rotary position embeddings (the two halves of each head rotated),
then an RMS-normed SwiGLU MLP; a final RMS norm and an untied output
head.  The configuration as run stores each norm's scale as an offset
from one (``x * rsqrt(mean(x^2) + eps) * (1 + g)``), and its rotary base
is ``rope_theta``.  It reads the same weight tensors the benchmark hands
the program, in the program's tree (stacked per layer), recomputes
everything else itself, and runs one layer at a time over the whole
sequence: no cache and no batching.  TF32 is off unless ``tf32`` asks
for it (the control).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(on: bool):
    """Matmul precision for the block: float32 (``on=False``) or TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + g)


def _rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, D); position i rotates pair (j, j + D/2) by
    i * theta^(-j / (D/2))."""
    s, _h, d = x.shape
    half = d // 2
    inv = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal grouped-query attention: q (S, Hq, D), k / v (S, Hkv, D)."""
    s, hq, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    return torch.einsum("hqk,khd->qhd", scores.softmax(-1), v)


@torch.no_grad()
def logits(cfg: dict, params: dict, tokens: torch.Tensor, rows: range,
           use_tf32: bool = False) -> torch.Tensor:
    """Logits (len(rows), vocab) at positions ``rows`` of one sequence
    ``tokens`` (S,)."""
    hd = cfg["d_head"]
    hq, hkv, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["norm_eps"]
    blk = params["blocks"]
    with tf32(use_tf32):
        x = params["embed"][tokens.long()]
        s = x.shape[0]
        for i in range(cfg["n_layers"]):
            a = blk["attn"]
            h = _norm(x, blk["ln1"][i], eps)
            q = _rotary((h @ a["wq"][i]).view(s, hq, hd), cfg["rope_theta"])
            k = _rotary((h @ a["wk"][i]).view(s, hkv, hd), cfg["rope_theta"])
            v = (h @ a["wv"][i]).view(s, hkv, hd)
            x = x + _attention(q, k, v).reshape(s, hq * hd) @ a["wo"][i]
            m = blk["mlp"]
            h = _norm(x, blk["ln2"][i], eps)
            x = x + (F.silu(h @ m["wg"][i]) * (h @ m["wi"][i])) @ m["wo"][i]
        h = _norm(x[rows.start:rows.stop], params["ln_f"], eps)
        return h @ params["lm_head"]


def served_gaps(cfg: dict, params: dict, prompt, served,
                use_tf32: bool = False) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at its position: ``max(logits) - logits[token]``.

    The sequence is the prompt and every served token but the last; the
    row of position ``len(prompt) - 1 + k`` predicts served token ``k``.
    ``use_tf32`` gives the control's reading instead: the gap, in the
    float32 reference, of the token TF32 puts first."""
    dev = params["embed"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev)
    n0 = len(prompt) - 1
    rows = range(n0, n0 + len(served))
    ref = logits(cfg, params, seq, rows)
    if use_tf32:
        pick = logits(cfg, params, seq, rows, use_tf32=True).argmax(-1)
    else:
        pick = torch.as_tensor(list(served), device=dev)
    best = ref.max(-1).values
    return best - ref.gather(1, pick[:, None].long())[:, 0]

"""Plain torch oracles for the PIM-tile quantized GEMV/GEMM kernels.

The numerics contract shared with the kernels (``pim_gemv.py``,
``pim_gemm.py``) and with the JAX package:

* int paths (W8/W4 x A8/A16/A4): exact integer MACs summed in int32,
  which wraps (the sum is taken mod 2**32), then one dequantization in
  float32.  The oracles here scale as ``(acc * w_scale[row]) * x_scale``;
  the kernels multiply by the precomputed row scale
  ``w_scale * x_scale`` instead, which can differ by one ulp.
* fp paths (fp8-e4m3 weights x fp8/bf16 activations): operands upcast to
  float32, accumulated in float32 (no scales).

W4 weights travel *packed*, two signed nibbles per int8 byte (the low
nibble is the even column), the byte layout the Data Mapper writes.

:func:`to_e4m3fn` is the one cast to fp8 the port uses: it gives the
bytes of the JAX package's ``astype(float8_e4m3fn)``, which rounds
magnitudes above 464 and infinities to NaN where torch's own cast
saturates them to +-448.
"""
from __future__ import annotations

import torch

# Half-way between e4m3fn's largest finite value (448) and the next step
# (480, which the format spends on NaN): anything larger rounds to NaN.
E4M3_ROUND_LIMIT = 464.0
E4M3_NAN = 0x7F


def to_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """float -> ``float8_e4m3fn`` with round-to-nearest-even, NaN past
    the format's range (sign kept), as JAX / ml_dtypes cast."""
    x = x.to(torch.float32)
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = (torch.signbit(x).to(torch.uint8) << 7) | E4M3_NAN
    out_of_range = ~(x.abs() <= E4M3_ROUND_LIMIT)      # also NaN inputs
    return torch.where(out_of_range, nan, bits).view(torch.float8_e4m3fn)


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32 (two's complement), as int32 sums wrap."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of integer tensors, summed mod 2**32 -> int32.

    The product is taken in float64 (the card has no integer matmul):
    every product of int8/int16 operands and every partial sum is an
    integer below 2**53, so the float64 result is exact in any order.
    """
    if a.shape[-1] >= 1 << 30:
        raise ValueError("reduction too long for an exact float64 sum")
    return wrap_int32((a.double() @ b.double()).to(torch.int64))


def _over_qmax(v: torch.Tensor, bits: int) -> torch.Tensor:
    """``v / (2**(bits-1) - 1)`` as a true float32 division.  The divisor
    is a tensor on ``v``'s device: torch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can be an ulp off."""
    qmax = torch.full((), 2 ** (bits - 1) - 1, dtype=torch.float32,
                      device=v.device)
    return v / qmax


def pack_w4(q: torch.Tensor) -> torch.Tensor:
    """(H, W) int values in [-8, 7] -> (H, W//2) packed int8."""
    q = torch.as_tensor(q).to(torch.int8)
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even width, got "
                         f"{q.shape[-1]}")
    lo = q[..., 0::2] & 0xF
    hi = q[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_w4(packed: torch.Tensor) -> torch.Tensor:
    """(..., W//2) packed int8 -> (..., W) int8 (sign-extended nibbles)."""
    p = torch.as_tensor(packed).to(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    hi = torch.bitwise_right_shift(p, 4)         # arithmetic: sign-extend
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


def quantize_weights(w: torch.Tensor, w_bits: int = 8
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization: ``(q int8 (H, W), scale (H,))``.

    For w_bits=4 the caller packs with :func:`pack_w4`.
    """
    w = torch.as_tensor(w).to(torch.float32)
    qmax = 2 ** (w_bits - 1) - 1
    scale = _over_qmax(w.abs().amax(dim=-1, keepdim=True), w_bits)
    scale = scale.clamp_min(1e-12)
    q = torch.round(w / scale).clamp(-qmax - 1, qmax).to(torch.int8)
    return q, scale[:, 0]


def quantize_acts(x: torch.Tensor, a_bits: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor activation quantization -> ``(q, scale)``,
    ``q`` int8 (a_bits <= 8) or int16, ``scale`` a 0-d float32."""
    x = torch.as_tensor(x).to(torch.float32)
    qmax = 2 ** (a_bits - 1) - 1
    scale = _over_qmax(x.abs().amax(), a_bits).clamp_min(1e-12)
    q = torch.round(x / scale).clamp(-qmax - 1, qmax)
    return q.to(torch.int8 if a_bits <= 8 else torch.int16), scale


def _weights_int(wq: torch.Tensor, w_bits: int) -> torch.Tensor:
    return unpack_w4(wq) if w_bits == 4 else wq.to(torch.int8)


def ref_gemv_int(wq, x_q, w_scale, x_scale, w_bits: int = 8
                 ) -> torch.Tensor:
    """Oracle for the int GEMV: (H, [W or W/2]) x (W,) -> f32 (H,)."""
    acc = int_matmul(_weights_int(wq, w_bits), x_q)
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=acc.device)
    return acc.float() * w_scale.to(torch.float32) * xs


def ref_gemm_int(wq, xb_q, w_scale, x_scale, w_bits: int = 8
                 ) -> torch.Tensor:
    """Oracle for the batched int GEMM: (B, W) x (H, W) -> f32 (B, H)."""
    acc = int_matmul(xb_q, _weights_int(wq, w_bits).T)
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=acc.device)
    return acc.float() * w_scale.to(torch.float32)[None] * xs


def ref_gemv_fp(w_fp8, x) -> torch.Tensor:
    """Oracle for the fp path: fp8 weights x fp8/bf16 acts -> f32."""
    return w_fp8.to(torch.float32) @ x.to(torch.float32)


def ref_gemm_fp(w_fp8, xb) -> torch.Tensor:
    return xb.to(torch.float32) @ w_fp8.to(torch.float32).T

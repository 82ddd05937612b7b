"""Batched PIM-tile quantized GEMM as CUDA kernels (``csrc/pim_gemm.cu``).

The serving hot path is a batch of GEMVs, one token per active request
against the same weight matrix: ``(B, W) x (H, W) -> (B, H)``.  The TPU
kernels this replaces (``repro/kernels/pim_gemm.py``) reuse one
activation block across every H tile.  On the card both GEMMs run on
the tensor cores (``mma.sync``, weight rows as M, the batch as N) when
their operands are 16-byte aligned and each weight row is a multiple of
16 bytes: the int GEMM as exact 8-bit integer tiles (int16 activations
split into two byte planes, int4 weights unpacked in registers), the fp
GEMM as f16 / bf16 tiles.  Other operands go byte by byte, one warp per
weight row.  :func:`int_variant` and :func:`fp_variant` make that choice
by shape and alignment alone, and each launch adds one to the tracer's
``pim_gemm_int.launches.<variant>`` or ``pim_gemm_fp.launches.<variant>``.

Plain versions, dispatch and counting follow ``pim_gemv.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core import trace

from .pim_gemv import (FP_X_DTYPES, INT_X_DTYPES, check_operands, row_scale,
                       vector_ok, weight_width)
from .ref import int_matmul, unpack_w4


def _check_int(wq, xb_q, w_scale, w_bits) -> torch.device:
    dev = check_operands("pim_gemm_int", dict(wq=wq, xb_q=xb_q,
                                              w_scale=w_scale),
                         dict(wq={torch.int8}, xb_q=set(INT_X_DTYPES),
                              w_scale={torch.float32}))
    if wq.dim() != 2 or xb_q.dim() != 2:
        raise ValueError(f"wq (H, W[/2]) and xb_q (B, W) expected, got "
                         f"{tuple(wq.shape)} and {tuple(xb_q.shape)}")
    w = weight_width(wq, w_bits)
    if xb_q.shape[1] != w:
        raise ValueError(f"xb_q must be (B, {w}), got "
                         f"{tuple(xb_q.shape)}")
    if tuple(w_scale.shape) != (wq.shape[0],):
        raise ValueError(f"w_scale must be ({wq.shape[0]},), got "
                         f"{tuple(w_scale.shape)}")
    return dev


def int_variant(wq: torch.Tensor, xb_q: torch.Tensor) -> str:
    """The ``pim_gemm_int`` kernel these operands take on the card:
    ``"mma"`` (tensor-core tiles, 16-byte loads) when both are 16-byte
    aligned and a (packed) weight row is a multiple of 16 bytes (W % 16
    for int8, W % 32 for int4), else ``"bytes"`` (one byte at a time)."""
    return "mma" if vector_ok(wq.shape[1], wq, xb_q) else "bytes"


def pim_gemm_int_plain(wq, xb_q, w_scale, x_scale, *, w_bits: int = 8
                       ) -> torch.Tensor:
    """The int GEMM in torch ops: f32 ``(B, H)``, the kernel's
    arithmetic."""
    w = unpack_w4(wq) if w_bits == 4 else wq
    return (int_matmul(xb_q, w.T).float()
            * row_scale(w_scale, x_scale)[None])


def pim_gemm_int(wq: torch.Tensor, xb_q: torch.Tensor,
                 w_scale: torch.Tensor, x_scale, *, w_bits: int = 8
                 ) -> torch.Tensor:
    """Quantized GEMM: (B, W) int8/int16 x (H, W[/2]) int8 -> f32 (B, H).

    CPU tensors run :func:`pim_gemm_int_plain`; CUDA tensors launch the
    kernel on the current stream or raise.
    """
    dev = _check_int(wq, xb_q, w_scale, w_bits)
    if dev.type == "cpu":
        return pim_gemm_int_plain(wq, xb_q, w_scale, x_scale,
                                  w_bits=w_bits)
    from repro_torch.kernels import build

    b, w = xb_q.shape
    h = wq.shape[0]
    ws = row_scale(w_scale, x_scale)
    out = torch.empty((b, h), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return out
    variant = int_variant(wq, xb_q)
    with torch.cuda.device(dev):
        build.launch("pim_gemm_int_launch", wq.data_ptr(), xb_q.data_ptr(),
                     ws.data_ptr(), out.data_ptr(), b, h, w, w_bits,
                     INT_X_DTYPES[xb_q.dtype], int(variant == "mma"),
                     torch.cuda.current_stream().cuda_stream)
    trace.count(f"pim_gemm_int.launches.{variant}")
    return out


def _check_fp(w_fp8, xb) -> torch.device:
    dev = check_operands("pim_gemm_fp", dict(w_fp8=w_fp8, xb=xb),
                         dict(w_fp8={torch.float8_e4m3fn},
                              xb=set(FP_X_DTYPES)))
    if (w_fp8.dim() != 2 or xb.dim() != 2
            or xb.shape[1] != w_fp8.shape[1]):
        raise ValueError(f"w_fp8 (H, W) and xb (B, W) expected, got "
                         f"{tuple(w_fp8.shape)} and {tuple(xb.shape)}")
    return dev


def fp_variant(w_fp8: torch.Tensor, xb: torch.Tensor) -> str:
    """The ``pim_gemm_fp`` kernel these operands take on the card:
    ``"mma"`` (tensor-core tiles, 16-byte loads) when both are 16-byte
    aligned and the width is a multiple of 16, else ``"bytes"`` (one
    byte at a time)."""
    return "mma" if vector_ok(w_fp8.shape[1], w_fp8, xb) else "bytes"


def pim_gemm_fp_plain(w_fp8, xb) -> torch.Tensor:
    """The fp GEMM in torch ops: f32 operands, f32 sums."""
    return xb.to(torch.float32) @ w_fp8.to(torch.float32).T


def pim_gemm_fp(w_fp8: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """fp8-e4m3 weight GEMM: (B, W) fp8/bf16 x (H, W) -> f32 (B, H).

    CPU tensors run :func:`pim_gemm_fp_plain`; CUDA tensors launch the
    kernel on the current stream or raise.
    """
    dev = _check_fp(w_fp8, xb)
    if dev.type == "cpu":
        return pim_gemm_fp_plain(w_fp8, xb)
    from repro_torch.kernels import build

    b, w = xb.shape
    h = w_fp8.shape[0]
    out = torch.empty((b, h), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return out
    variant = fp_variant(w_fp8, xb)
    with torch.cuda.device(dev):
        build.launch("pim_gemm_fp_launch", w_fp8.data_ptr(), xb.data_ptr(),
                     out.data_ptr(), b, h, w, FP_X_DTYPES[xb.dtype],
                     int(variant == "mma"),
                     torch.cuda.current_stream().cuda_stream)
    trace.count(f"pim_gemm_fp.launches.{variant}")
    return out

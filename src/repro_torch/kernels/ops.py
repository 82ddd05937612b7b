"""The PIM-tile quantized linear layer: weights prepared once, then
``pim_linear`` per call through the GEMV/GEMM kernels.

:func:`prepare_weights` quantizes a float weight matrix for one
:class:`PimDType` (per-row int8 or packed int4 with a float32 row scale,
or fp8-e4m3 with no scale).  :func:`pim_linear` quantizes (int) or casts
(fp) the activations on the fly and dispatches: a 1-D ``x`` goes to the
GEMV kernels, a 2-D ``x`` to the GEMM kernels.  The device of the
weights decides the route: weights on the card launch the kernels, CPU
weights run their plain versions.  :func:`prepare_weights` runs on the
card unless asked for the CPU, like every entry point of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.timing import PimSpec
from repro_torch.pimkernel.tileconfig import PimDType, TileConfig
from . import pim_gemm, pim_gemv, ref


def pim_block_shape(dtype: PimDType,
                    pim: PimSpec = PimSpec()) -> tuple[int, int]:
    """PIM tile -> the TPU kernels' MXU-aligned block ``(BH, BW)``.

    Kept for parity with the JAX package: the card's kernels tile by
    warp rows and take no block.
    """
    tc = TileConfig.make(dtype, pim)
    bh = max(128, -(-tc.t_h // 128) * 128)
    bw = max(128, -(-tc.t_w // 128) * 128)
    return (min(bh, 512), min(bw, 1024))


def _parse(dtype: PimDType | str) -> PimDType:
    return PimDType.parse(dtype) if isinstance(dtype, str) else dtype


@dataclasses.dataclass
class QuantWeights:
    """A weight matrix prepared for the PIM-tile kernels."""

    dtype: PimDType
    q: torch.Tensor            # int8 (H, W[/2]) or float8_e4m3fn (H, W)
    scale: torch.Tensor | None  # (H,) f32, int paths only
    shape: tuple[int, int]     # logical (H, W)

    @classmethod
    def from_numpy(cls, dtype: PimDType | str, q: np.ndarray,
                   scale: np.ndarray | None, shape, device=None
                   ) -> "QuantWeights":
        """The bundle from another package's arrays, byte for byte:
        ``q`` int8, or for fp dtypes the uint8 bit pattern of e4m3fn."""
        dtype = _parse(dtype)
        dev = resolve_device(device)
        q = np.asarray(q)
        if dtype.is_fp:
            if q.dtype != np.uint8 or scale is not None:
                raise TypeError("fp weights travel as uint8 e4m3fn bits "
                                "with no scale")
            qt = torch.tensor(q, device=dev).view(torch.float8_e4m3fn)
            st = None
        else:
            if q.dtype != np.int8 or scale is None:
                raise TypeError("int weights travel as int8 with a scale")
            qt = torch.tensor(q, device=dev)
            st = torch.tensor(np.asarray(scale, dtype=np.float32),
                              device=dev)
        return cls(dtype, qt, st, tuple(int(s) for s in shape))


def prepare_weights(w, dtype: PimDType | str, device=None) -> QuantWeights:
    """Quantize a float ``(H, W)`` weight matrix for ``dtype`` on
    ``device`` (by default the card; pass ``device="cpu"`` for the plain
    path)."""
    dtype = _parse(dtype)
    w = torch.as_tensor(w, device=resolve_device(device)).to(torch.float32)
    if dtype.is_fp:
        return QuantWeights(dtype, ref.to_e4m3fn(w), None, tuple(w.shape))
    q, scale = ref.quantize_weights(w, dtype.w_bits)
    if dtype.w_bits == 4:
        q = ref.pack_w4(q)
    return QuantWeights(dtype, q.contiguous(), scale.contiguous(),
                        tuple(w.shape))


def _fp_acts(xb: torch.Tensor, dtype: PimDType) -> torch.Tensor:
    return (ref.to_e4m3fn(xb) if dtype.a_bits == 8
            else xb.to(torch.bfloat16)).contiguous()


def pim_linear(x, qw: QuantWeights, *, block=None,
               interpret: bool | None = None) -> torch.Tensor:
    """``y = x @ W^T`` through the PIM-tile kernels; ``x`` is ``(W,)`` or
    ``(B, W)`` float, ``y`` float32 ``(H,)`` or ``(B, H)``.

    ``block`` and ``interpret`` are accepted for signature parity with
    the JAX package and change no result: the card's kernels do not tile
    by ``block``, and a CUDA kernel has no interpret mode (CPU tensors
    take the plain versions whatever ``interpret`` says).
    """
    del block, interpret
    x = torch.as_tensor(x, device=qw.q.device).to(torch.float32)
    squeeze = x.dim() == 1
    xb = x[None] if squeeze else x
    if qw.dtype.is_fp:
        xk = _fp_acts(xb, qw.dtype)
        if squeeze:
            return pim_gemv.pim_gemv_fp(qw.q, xk[0])
        return pim_gemm.pim_gemm_fp(qw.q, xk)
    xq, xs = ref.quantize_acts(xb, qw.dtype.a_bits)
    if squeeze:
        return pim_gemv.pim_gemv_int(qw.q, xq[0], qw.scale, xs,
                                     w_bits=qw.dtype.w_bits)
    return pim_gemm.pim_gemm_int(qw.q, xq, qw.scale, xs,
                                 w_bits=qw.dtype.w_bits)


def pim_linear_ref(x, qw: QuantWeights) -> torch.Tensor:
    """Oracle path with the identical numerics contract (the oracles'
    scaling order)."""
    x = torch.as_tensor(x, device=qw.q.device).to(torch.float32)
    squeeze = x.dim() == 1
    xb = x[None] if squeeze else x
    if qw.dtype.is_fp:
        out = ref.ref_gemm_fp(qw.q, _fp_acts(xb, qw.dtype))
    else:
        xq, xs = ref.quantize_acts(xb, qw.dtype.a_bits)
        out = ref.ref_gemm_int(qw.q, xq, qw.scale, xs,
                               w_bits=qw.dtype.w_bits)
    return out[0] if squeeze else out

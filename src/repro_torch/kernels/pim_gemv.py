"""PIM-tile quantized GEMV as CUDA kernels (``csrc/pim_gemv.cu``).

The TPU kernels this replaces (``repro/kernels/pim_gemv.py``) walk
``(BH, BW)`` VMEM blocks with an int32/float32 scratch accumulator
revisited across the reduction grid axis, and dequantize in the final
step's flush.  On the card the fp GEMV gives each output row a warp that
streams the weight row in 16-byte loads.  The int GEMV's vector kernel
gives a warp R rows, whose lanes load and rearrange each activation
chunk once for all R; :func:`gemv_int_variant` picks R by format and
``H`` (``"rows1"``, ``"rows2"`` or ``"rows4"``), and operands that are
not 16-byte aligned go ``"bytes"``, a byte at a time.  Each launch
adds one to a tracer counter (``core/trace.py``): the int GEMV's to
``pim_gemv_int.launches.<variant>``, the fp GEMV's to
``pim_gemv_fp.launches``; the plain versions never count.  The
kernels mask the ragged edge themselves; nothing is padded or copied.

Each kernel sits beside its plain torch version, which repeats its
arithmetic (int sums exact mod 2**32, then ``acc * (w_scale * x_scale)``
in float32; fp operands upcast to float32 and summed in float32).  CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import trace

from .ref import int_matmul, unpack_w4

# Weight rows per warp of the int GEMV's vector kernel, by (w_bits,
# activation bytes): (R for small H, R for large H), the only ones the
# kernel library builds (``Rows`` in csrc/pim_gemv.cu).  Large: H fills at
# least two blocks of 8 warps x R rows per SM (gemv_int_large_h).  Timed
# at the granite-8b decode sites on an H100 (PERF.md, the R table):
# sharing each activation load among R rows pays at W4A16 at every size,
# at W8A16 and int4 x int8 only where many rows keep the card full.
GEMV_INT_ROWS = {(8, 1): (1, 1), (8, 2): (1, 4), (4, 1): (1, 4),
                 (4, 2): (2, 2)}
# SMs of the card the CPU variant choice assumes: an H100 SXM's.
H100_SMS = 132

INT_X_DTYPES = {torch.int8: 1, torch.int16: 2}
FP_X_DTYPES = {torch.float8_e4m3fn: 1, torch.bfloat16: 2}


def scalar_scale(x_scale, device) -> torch.Tensor:
    """``x_scale`` as a 0-d float32 tensor on ``device``."""
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=device)
    if xs.numel() != 1:
        raise ValueError(f"x_scale must be a scalar, got shape "
                         f"{tuple(xs.shape)}")
    return xs.reshape(())


def row_scale(w_scale: torch.Tensor, x_scale) -> torch.Tensor:
    """The dequantizing factor per row, ``w_scale * x_scale`` in float32
    (computed once, before the sum, as the TPU kernel's wrapper does)."""
    return (w_scale * scalar_scale(x_scale, w_scale.device)).contiguous()


def weight_width(wq: torch.Tensor, w_bits: int) -> int:
    """Logical width W of a (packed) weight matrix."""
    if w_bits not in (4, 8):
        raise ValueError(f"w_bits must be 4 or 8, got {w_bits}")
    return wq.shape[1] * (2 if w_bits == 4 else 1)


def check_operands(name: str, tensors: dict, dtypes: dict) -> torch.device:
    """Shared wrapper checks: dtype, contiguity and one device for all.

    ``tensors`` maps an operand's name to the tensor, ``dtypes`` maps it
    to the dtypes the kernel takes.  Returns the common device.
    """
    dev = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        dev = t.device if dev is None else dev
        if t.dtype not in dtypes[arg]:
            raise TypeError(f"{name}: {arg} must be one of "
                            f"{sorted(map(str, dtypes[arg]))}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {dev}")
    return dev


def vector_ok(row_bytes: int, *tensors: torch.Tensor) -> int:
    """1 when every weight row starts on a 16-byte boundary and the
    operands are 16-byte aligned (the kernels' vector loads), else 0
    (the kernels then read one byte at a time)."""
    return int(row_bytes % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_int(wq, x_q, w_scale, w_bits) -> torch.device:
    dev = check_operands("pim_gemv_int", dict(wq=wq, x_q=x_q,
                                              w_scale=w_scale),
                         dict(wq={torch.int8}, x_q=set(INT_X_DTYPES),
                              w_scale={torch.float32}))
    if wq.dim() != 2:
        raise ValueError(f"wq must be (H, W) or (H, W/2), got "
                         f"{tuple(wq.shape)}")
    w = weight_width(wq, w_bits)
    if tuple(x_q.shape) != (w,):
        raise ValueError(f"x_q must be ({w},), got {tuple(x_q.shape)}")
    if tuple(w_scale.shape) != (wq.shape[0],):
        raise ValueError(f"w_scale must be ({wq.shape[0]},), got "
                         f"{tuple(w_scale.shape)}")
    return dev


def pim_gemv_int_plain(wq, x_q, w_scale, x_scale, *, w_bits: int = 8
                       ) -> torch.Tensor:
    """The int GEMV in torch ops: f32 ``(H,)``, the kernel's arithmetic."""
    w = unpack_w4(wq) if w_bits == 4 else wq
    return int_matmul(w, x_q).float() * row_scale(w_scale, x_scale)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else H100_SMS)


def gemv_int_large_h(w_bits: int, x_bytes: int,
                     device: torch.device) -> int:
    """The least H that takes the int GEMV's large-H R for this format
    on ``device``: two blocks of 8 warps x R rows per SM of the card (of
    an H100 for CPU operands)."""
    return 2 * _sms(device) * 8 * GEMV_INT_ROWS[(w_bits, x_bytes)][1]


def gemv_int_variant(wq: torch.Tensor, x_q: torch.Tensor,
                     w_bits: int) -> str:
    """The ``pim_gemv_int`` kernel these operands take on the card, by
    shape and alignment alone: ``"bytes"`` (one byte at a time) unless
    both are 16-byte aligned and a (packed) weight row is a multiple of
    16 bytes; else ``"rowsR"``, the vector kernel with R rows per warp
    from :data:`GEMV_INT_ROWS`."""
    if not vector_ok(wq.shape[1], wq, x_q):
        return "bytes"
    x_bytes = INT_X_DTYPES[x_q.dtype]
    small, large = GEMV_INT_ROWS[(w_bits, x_bytes)]
    full = wq.shape[0] >= gemv_int_large_h(w_bits, x_bytes, wq.device)
    return f"rows{large if full else small}"


def pim_gemv_int(wq: torch.Tensor, x_q: torch.Tensor,
                 w_scale: torch.Tensor, x_scale, *, w_bits: int = 8
                 ) -> torch.Tensor:
    """Quantized GEMV: (H, W[/2]) int8 x (W,) int8/int16 -> f32 (H,).

    ``y[h] = f32(sum_w Wq[h, w] * x_q[w] mod 2**32) * (w_scale[h] *
    x_scale)``.  CPU tensors run :func:`pim_gemv_int_plain`; CUDA tensors
    launch the kernel on the current stream or raise (the kernel forms
    the row scale ``w_scale * x_scale`` itself, as :func:`row_scale`
    does).
    """
    dev = _check_int(wq, x_q, w_scale, w_bits)
    if dev.type == "cpu":
        return pim_gemv_int_plain(wq, x_q, w_scale, x_scale, w_bits=w_bits)
    from repro_torch.kernels import build

    variant = gemv_int_variant(wq, x_q, w_bits)
    xs = scalar_scale(x_scale, dev)
    h, w = wq.shape[0], weight_width(wq, w_bits)
    out = torch.empty(h, dtype=torch.float32, device=dev)
    if h == 0:
        return out
    with torch.cuda.device(dev):
        build.launch("pim_gemv_int_launch", wq.data_ptr(), x_q.data_ptr(),
                     w_scale.data_ptr(), xs.data_ptr(), out.data_ptr(), h, w,
                     w_bits, INT_X_DTYPES[x_q.dtype],
                     0 if variant == "bytes" else int(variant[4:]),
                     torch.cuda.current_stream().cuda_stream)
    trace.count(f"pim_gemv_int.launches.{variant}")
    return out


def _check_fp(w_fp8, x) -> torch.device:
    dev = check_operands("pim_gemv_fp", dict(w_fp8=w_fp8, x=x),
                         dict(w_fp8={torch.float8_e4m3fn},
                              x=set(FP_X_DTYPES)))
    if w_fp8.dim() != 2 or tuple(x.shape) != (w_fp8.shape[1],):
        raise ValueError(f"w_fp8 (H, W) and x (W,) expected, got "
                         f"{tuple(w_fp8.shape)} and {tuple(x.shape)}")
    return dev


def pim_gemv_fp_plain(w_fp8, x) -> torch.Tensor:
    """The fp GEMV in torch ops: f32 operands, f32 sums."""
    return w_fp8.to(torch.float32) @ x.to(torch.float32)


def pim_gemv_fp(w_fp8: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fp8-e4m3 weight GEMV: (H, W) x (W,) fp8/bf16 -> f32 (H,).

    CPU tensors run :func:`pim_gemv_fp_plain`; CUDA tensors launch the
    kernel on the current stream or raise.
    """
    dev = _check_fp(w_fp8, x)
    if dev.type == "cpu":
        return pim_gemv_fp_plain(w_fp8, x)
    from repro_torch.kernels import build

    h, w = w_fp8.shape
    out = torch.empty(h, dtype=torch.float32, device=dev)
    if h == 0:
        return out
    with torch.cuda.device(dev):
        build.launch("pim_gemv_fp_launch", w_fp8.data_ptr(), x.data_ptr(),
                     out.data_ptr(), h, w, FP_X_DTYPES[x.dtype],
                     vector_ok(w, w_fp8, x),
                     torch.cuda.current_stream().cuda_stream)
    trace.count("pim_gemv_fp.launches")
    return out

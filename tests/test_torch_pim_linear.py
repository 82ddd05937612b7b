"""The port's PIM-tile quantized linear layer, held to the JAX package.

``repro_torch.kernels.{ref,pim_gemv,pim_gemm,ops}`` run here on CPU
tensors, which take each kernel's plain torch version; the reference
runs its Pallas kernels in interpret mode on JAX's CPU backend.  Inputs
come from numpy seeds; fp8 crosses between the packages as its uint8
bit pattern.

* int paths are bit for bit (integer sums wrap mod 2**32 alike, and the
  port's plain versions scale in the kernels' order);
* fp paths agree to rtol 1e-5 / atol 1e-4 (``tests/test_kernels.py``'s
  tolerance: float32 sums taken in another order);
* the cast to fp8 gives JAX's bytes, NaN past the format's range.

``tests/golden/torch_pim_linear.json`` pins one granite-8b layer plus
``lm_head`` at full width, all 7 dtypes, batch 1 and 8, as the JAX
package computes them; ``chip_smoke.py`` and ``tests/test_torch_gpu.py``
reproduce it on the card.  Regenerate it deliberately with
``PYTHONPATH=src python tests/test_torch_pim_linear.py`` (some minutes
and a few GB of host memory: ``lm_head`` is 49152 x 4096).
"""
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (first: the reference's import order)
import jax.numpy as jnp
from repro.configs import granite_8b as ref_granite
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pim_gemm import pim_gemm_fp as jax_gemm_fp
from repro.kernels.pim_gemm import pim_gemm_int as jax_gemm_int
from repro.kernels.pim_gemv import pim_gemv_fp as jax_gemv_fp
from repro.kernels.pim_gemv import pim_gemv_int as jax_gemv_int
from repro.serving.offload import decode_gemv_sites as ref_sites

from repro_torch.kernels import ops, pim_gemm, pim_gemv, ref
from repro_torch.pimkernel.tileconfig import ALL_DTYPES

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = pathlib.Path(__file__).parent / "golden" / "torch_pim_linear.json"
SHAPES = [(128, 256), (256, 512), (384, 640), (130, 258), (64, 1024)]
BLOCK = (128, 256)
FP_TOL = dict(rtol=1e-5, atol=1e-4)

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def t(a) -> torch.Tensor:
    """numpy (or a JAX array) -> CPU tensor; fp8 goes as its bytes."""
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _rand_int(rng, shape, bits):
    m = 2 ** (bits - 1) - 1
    return rng.integers(-m - 1, m + 1, size=shape)


def _int_operands(rng, h, w, b, w_bits, a_bits):
    wq = _rand_int(rng, (h, w), w_bits).astype(np.int8)
    xq = _rand_int(rng, (w,) if b is None else (b, w), a_bits)
    xq = xq.astype(np.int8 if a_bits == 8 else np.int16)
    ws = rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    wk = np.asarray(jref.pack_w4(wq)) if w_bits == 4 else wq
    return wk, xq, ws, np.float32(0.03)


# ---------------------------------------------------------------------
# Kernels and oracles against the JAX package
# ---------------------------------------------------------------------

def _put_extremes(wk, xq, w_bits, a_bits):
    """A row of -128 / 127 (int4 -8 / 7) weights, and the activation type's
    extremes (int16: also the byte planes' -1, 255 and 256) at both ends."""
    lo, hi = -2 ** (w_bits - 1), 2 ** (w_bits - 1) - 1
    wq = np.array(jref.unpack_w4(wk)) if w_bits == 4 else wk.copy()
    wq[wq.shape[0] // 2] = np.where(np.arange(wq.shape[1]) % 2, hi, lo)
    wk = np.asarray(jref.pack_w4(wq)) if w_bits == 4 else wq
    edge = [-2 ** (a_bits - 1), 2 ** (a_bits - 1) - 1, -1, 0]
    edge += [255, 256] if a_bits == 16 else []
    xq = xq.copy()
    xq[:len(edge)] = edge
    xq[-len(edge):] = edge
    return wk, xq


# The card's int GEMV gives a warp R rows (1, 2 or 4): H = 1, 2, 3, 5, 15,
# 17, 1024, 1025 and widths up to mlp.wo's 14336, with the extremes of
# _put_extremes.
GEMV_EDGE_SHAPES = [(h, w) for h in (1, 2, 3, 5, 15, 17, 1024, 1025)
                    for w in (32, 64, 4096, 4128, 14336)]


@pytest.mark.parametrize("h,w", SHAPES + GEMV_EDGE_SHAPES)
@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("a_bits", [8, 16])
def test_gemv_int_bit_for_bit(h, w, w_bits, a_bits):
    rng = np.random.default_rng(h * 1000 + w + w_bits + a_bits)
    wk, xq, ws, xs = _int_operands(rng, h, w, None, w_bits, a_bits)
    if (h, w) in GEMV_EDGE_SHAPES:
        wk, xq = _put_extremes(wk, xq, w_bits, a_bits)
    want = jax_gemv_int(jnp.asarray(wk), jnp.asarray(xq), jnp.asarray(ws),
                        xs, w_bits=w_bits, block=BLOCK, interpret=True)
    before = dict(pim_gemv.LAUNCHES)
    got = pim_gemv.pim_gemv_int(t(wk), t(xq), t(ws), xs, w_bits=w_bits)
    assert pim_gemv.LAUNCHES == before          # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.ref_gemv_int(t(wk), t(xq), t(ws), xs, w_bits=w_bits).numpy(),
        np.asarray(jref.ref_gemv_int(wk, xq, ws, xs, w_bits=w_bits)))


# The last two shapes and batches 2 and 17 are the edges of the card's
# int tensor-core tiles (rows past a 16-row tile, batch past 8 and 16);
# on CPU tensors the wrapper takes its plain version.
@pytest.mark.parametrize("h,w", [(192, 384), (130, 258), (15, 1040),
                                 (17, 2080)])
@pytest.mark.parametrize("b", [1, 2, 4, 9, 17])
@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("a_bits", [8, 16])
def test_gemm_int_bit_for_bit(h, w, b, w_bits, a_bits):
    rng = np.random.default_rng(b * 7 + w_bits + a_bits + h)
    wk, xq, ws, xs = _int_operands(rng, h, w, b, w_bits, a_bits)
    want = jax_gemm_int(jnp.asarray(wk), jnp.asarray(xq), jnp.asarray(ws),
                        xs, w_bits=w_bits, block=(8,) + BLOCK,
                        interpret=True)
    got = pim_gemm.pim_gemm_int(t(wk), t(xq), t(ws), xs, w_bits=w_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.ref_gemm_int(t(wk), t(xq), t(ws), xs, w_bits=w_bits).numpy(),
        np.asarray(jref.ref_gemm_int(wk, xq, ws, xs, w_bits=w_bits)))


def test_int32_sum_wraps_like_jax():
    """127 * 32767 * 16384 = 68,180,525,056 wraps mod 2**32."""
    wq = np.full((8, 16384), 127, np.int8)
    xq = np.full((16384,), 32767, np.int16)
    ws = np.linspace(0.5, 1.5, 8).astype(np.float32)
    xs = np.float32(1.0)
    want = np.asarray(jax_gemv_int(jnp.asarray(wq), jnp.asarray(xq),
                                   jnp.asarray(ws), xs, interpret=True))
    got = pim_gemv.pim_gemv_int(t(wq), t(xq), t(ws), xs).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(-538951680.0) * ws[0]    # wrapped, not 6.8e10
    xb = np.stack([xq, -xq])
    want = np.asarray(jax_gemm_int(jnp.asarray(wq), jnp.asarray(xb),
                                   jnp.asarray(ws), xs, interpret=True))
    got = pim_gemm.pim_gemm_int(t(wq), t(xb), t(ws), xs).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", [(128, 256), (130, 300)])
@pytest.mark.parametrize("act", ["fp8", "bf16"])
def test_gemv_fp_matches_jax(h, w, act):
    rng = np.random.default_rng(h + w)
    w8 = jnp.asarray((rng.standard_normal((h, w)) * 0.5).astype(np.float32)
                     ).astype(jnp.float8_e4m3fn)
    x = jnp.asarray((rng.standard_normal((w,)) * 0.5).astype(np.float32)
                    ).astype(jnp.float8_e4m3fn if act == "fp8"
                             else jnp.bfloat16)
    want = jax_gemv_fp(w8, x, block=BLOCK, interpret=True)
    got = pim_gemv.pim_gemv_fp(t(w8), t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP_TOL)
    np.testing.assert_allclose(ref.ref_gemv_fp(t(w8), t(x)).numpy(),
                               np.asarray(jref.ref_gemv_fp(w8, x)), **FP_TOL)


@pytest.mark.parametrize("act", ["fp8", "bf16"])
def test_gemm_fp_matches_jax(act):
    rng = np.random.default_rng(3)
    w8 = jnp.asarray((rng.standard_normal((192, 384)) * 0.5)
                     .astype(np.float32)).astype(jnp.float8_e4m3fn)
    xb = jnp.asarray((rng.standard_normal((5, 384)) * 0.5)
                     .astype(np.float32)).astype(
                         jnp.float8_e4m3fn if act == "fp8" else jnp.bfloat16)
    want = jax_gemm_fp(w8, xb, block=(8, 128, 256), interpret=True)
    got = pim_gemm.pim_gemm_fp(t(w8), t(xb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP_TOL)
    np.testing.assert_allclose(ref.ref_gemm_fp(t(w8), t(xb)).numpy(),
                               np.asarray(jref.ref_gemm_fp(w8, xb)), **FP_TOL)


@pytest.mark.parametrize("b,h,w", [(9, 17, 48), (17, 33, 4128), (2, 15, 16)])
@pytest.mark.parametrize("act", ["fp8", "bf16"])
def test_gemm_fp_tile_edges_match_jax(b, h, w, act):
    """The shapes at the edges of the card kernel's tiles (batch past 8
    and 16, rows past a 16-row tile, widths ending inside a 128-column
    span), with a +-448 weight row and a NaN activation, through the
    port's wrapper and the JAX package's kernel."""
    rng = np.random.default_rng(b * h + w)
    wf = (rng.standard_normal((h, w)) * 3.0).astype(np.float32)
    wf[h // 2] = np.where(np.arange(w) % 2, 448.0, -448.0)
    xf = (rng.standard_normal((b, w)) * 3.0).astype(np.float32)
    xf[b - 1, w // 3] = np.nan
    w8 = jnp.asarray(wf).astype(jnp.float8_e4m3fn)
    xb = jnp.asarray(xf).astype(jnp.float8_e4m3fn if act == "fp8"
                                else jnp.bfloat16)
    want = np.asarray(jax_gemm_fp(w8, xb, block=(8, 128, 256),
                                  interpret=True))
    got = pim_gemm.pim_gemm_fp(t(w8), t(xb)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[b - 1]).all()
    np.testing.assert_allclose(got, want, **FP_TOL)


def test_int4_packing_matches_jax():
    q = np.arange(-8, 8, dtype=np.int8)[None].repeat(3, 0)
    q = np.concatenate([q, q[:, ::-1]], axis=1)
    packed = ref.pack_w4(t(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jref.pack_w4(q)))
    np.testing.assert_array_equal(ref.unpack_w4(packed).numpy(), q)


# ---------------------------------------------------------------------
# The fp8 cast
# ---------------------------------------------------------------------

def test_fp8_cast_gives_jax_bytes():
    edges = np.array([0.0, -0.0, 2.0 ** -10, 2.0 ** -9, 1.5 * 2.0 ** -9,
                      -3 * 2.0 ** -10, 2.0 ** -6, 447.9, 448.0, 464.0,
                      464.01, -464.01, 480.0, 1000.0, -1000.0, np.inf,
                      -np.inf, np.nan, -np.nan], np.float32)
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal(100_000) * np.exp2(
        rng.integers(-14, 10, 100_000))).astype(np.float32)
    for v in (edges, wide):
        want = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn)
                          ).view(np.uint8)
        got = ref.to_e4m3fn(torch.from_numpy(v)).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)


def test_fp_w8a8_overflow_is_nan_in_both_packages():
    rng = np.random.default_rng(1)
    wf = (rng.standard_normal((40, 64)) * 0.3).astype(np.float32)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    x[1, 5] = 500.0                   # JAX: NaN; a saturating cast: 448
    jq = jops.prepare_weights(wf, "FP_W8A8")
    pq = ops.prepare_weights(wf, "FP_W8A8", device="cpu")
    for xx in (x, x[1]):
        want = np.asarray(jops.pim_linear(xx, jq, block=(128, 128),
                                          interpret=True))
        got = ops.pim_linear(xx, pq).numpy()
        assert np.isnan(want).any()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **FP_TOL)   # NaN == NaN


# ---------------------------------------------------------------------
# The layer: prepare_weights + pim_linear, all dtypes
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: d.name)
@pytest.mark.parametrize("ndim", [1, 2])
def test_pim_linear_matches_jax(dtype, ndim):
    rng = np.random.default_rng(sum(map(ord, dtype.name)) + ndim)
    wf = (rng.standard_normal((96, 192)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((3, 192)) * 0.8).astype(np.float32)
    x = x[0] if ndim == 1 else x
    jq = jops.prepare_weights(wf, dtype.name)
    pq = ops.prepare_weights(wf, dtype, device="cpu")
    carried = ops.QuantWeights.from_numpy(
        dtype.name, t(jq.q).view(torch.uint8).numpy() if dtype.is_fp
        else np.asarray(jq.q), None if jq.scale is None
        else np.asarray(jq.scale), jq.shape, device="cpu")
    assert pq.shape == carried.shape == tuple(jq.shape)
    for qw in (pq, carried):            # the same bytes either way
        assert torch.equal(qw.q.view(torch.uint8),
                           t(jq.q).view(torch.uint8))
        if dtype.is_fp:
            assert qw.scale is None
        else:
            np.testing.assert_array_equal(qw.scale.numpy(),
                                          np.asarray(jq.scale))
    want = np.asarray(jops.pim_linear(x, jq, block=(128, 128),
                                      interpret=True))
    want_ref = np.asarray(jops.pim_linear_ref(x, jq))
    got = ops.pim_linear(x, pq, block=(128, 128)).numpy()
    got_ref = ops.pim_linear_ref(x, pq).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype.is_fp:
        np.testing.assert_allclose(got, want, **FP_TOL)
        np.testing.assert_allclose(got_ref, want_ref, **FP_TOL)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_ref, want_ref)
    assert ops.pim_block_shape(dtype) == jops.pim_block_shape(
        jops.PimDType[dtype.name])


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("dtype", ["W8A8", "W4A16", "FP_W8A16"])
def test_pim_linear_takes_the_reference_signature(dtype, interpret):
    """A call written for the reference (``block=``, ``interpret=``)
    runs on the port and gives the output of the call without them, and
    the JAX package's output in interpret mode."""
    rng = np.random.default_rng(len(dtype))
    wf = (rng.standard_normal((40, 160)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((2, 160)) * 0.8).astype(np.float32)
    jq = jops.prepare_weights(wf, dtype)
    pq = ops.prepare_weights(wf, dtype, device="cpu")
    block = jops.pim_block_shape(jq.dtype)
    for xi in (x, x[0]):
        got = ops.pim_linear(xi, pq, block=block, interpret=interpret)
        assert torch.equal(got, ops.pim_linear(xi, pq))
        want = np.asarray(jops.pim_linear(xi, jq, block=block,
                                          interpret=True))
        if pq.dtype.is_fp:
            np.testing.assert_allclose(got.numpy(), want, **FP_TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    wq = torch.zeros((4, 32), dtype=torch.int8)
    ws = torch.ones(4)
    with pytest.raises(TypeError, match="x_q"):
        pim_gemv.pim_gemv_int(wq, torch.zeros(32), ws, 1.0)
    with pytest.raises(ValueError, match=r"x_q must be \(64,\)"):
        pim_gemv.pim_gemv_int(wq, torch.zeros(32, dtype=torch.int8), ws,
                              1.0, w_bits=4)
    with pytest.raises(ValueError, match="w_bits"):
        pim_gemm.pim_gemm_int(wq, torch.zeros((2, 32), dtype=torch.int8),
                              ws, 1.0, w_bits=2)
    with pytest.raises(ValueError, match="contiguous"):
        pim_gemm.pim_gemm_int(wq, torch.zeros((32, 2), dtype=torch.int8).T,
                              ws, 1.0)
    with pytest.raises(ValueError, match="x_scale"):
        pim_gemv.pim_gemv_int(wq, torch.zeros(32, dtype=torch.int8), ws,
                              torch.ones(2))
    w8 = torch.zeros((4, 32)).to(torch.float8_e4m3fn)
    with pytest.raises(TypeError, match="xb"):
        pim_gemm.pim_gemm_fp(w8, torch.zeros((2, 32)))
    with pytest.raises(ValueError, match="meta"):
        pim_gemv.pim_gemv_fp(w8.to("meta"),
                             torch.zeros(32, dtype=torch.bfloat16,
                                         device="meta"))
    with pytest.raises(TypeError, match="uint8"):
        ops.QuantWeights.from_numpy("FP_W8A8", np.zeros((4, 32), np.int8),
                                    None, (4, 32), device="cpu")


@pytest.mark.parametrize("w,x_dtype,skew,want", [
    (4096, torch.float8_e4m3fn, None, "mma"),
    (4096, torch.bfloat16, None, "mma"),
    (4128, torch.bfloat16, None, "mma"),
    (16, torch.float8_e4m3fn, None, "mma"),
    (200, torch.float8_e4m3fn, None, "bytes"),
    (4104, torch.bfloat16, None, "bytes"),
    (4096, torch.float8_e4m3fn, "w", "bytes"),
    (4096, torch.bfloat16, "x", "bytes"),
])
def test_fp_gemm_variant_is_chosen_by_shape_and_alignment(w, x_dtype, skew,
                                                          want):
    """The tensor-core fp GEMM takes 16-byte aligned operands whose width
    is a multiple of 16; everything else goes byte by byte.  On CPU
    tensors the wrapper runs the plain version and counts nothing."""
    w8 = torch.zeros((17, w)).to(torch.float8_e4m3fn)
    xb = torch.zeros((9, w)).to(x_dtype)
    if skew == "w":
        w8 = chip_smoke.misaligned(w8)
    if skew == "x":
        xb = chip_smoke.misaligned(xb)
    assert pim_gemm.fp_variant(w8, xb) == want
    before = dict(pim_gemm.FP_VARIANT_LAUNCHES)
    out = pim_gemm.pim_gemm_fp(w8, xb)
    assert out.shape == (9, 17)
    assert pim_gemm.FP_VARIANT_LAUNCHES == before


@pytest.mark.parametrize("w_bits,w,x_dtype,skew,want", [
    (8, 16, torch.int8, None, "mma"),
    (8, 4096, torch.int8, None, "mma"),
    (8, 4128, torch.int16, None, "mma"),
    (8, 200, torch.int8, None, "bytes"),
    (4, 32, torch.int8, None, "mma"),
    (4, 4128, torch.int16, None, "mma"),
    (4, 48, torch.int16, None, "bytes"),
    (8, 4096, torch.int8, "w", "bytes"),
    (4, 4096, torch.int16, "x", "bytes"),
])
def test_int_gemm_variant_is_chosen_by_shape_and_alignment(w_bits, w,
                                                           x_dtype, skew,
                                                           want):
    """The tensor-core int GEMM takes 16-byte aligned operands whose
    (packed) weight rows are a multiple of 16 bytes -- W % 16 for int8,
    W % 32 for int4; everything else goes byte by byte.  On CPU tensors
    the wrapper runs the plain version and counts nothing."""
    wq = torch.ones((17, w * w_bits // 8), dtype=torch.int8)
    xb = torch.ones((9, w), dtype=x_dtype)
    if skew == "w":
        wq = chip_smoke.misaligned(wq)
    if skew == "x":
        xb = chip_smoke.misaligned(xb)
    assert pim_gemm.int_variant(wq, xb) == want
    before = dict(pim_gemm.INT_VARIANT_LAUNCHES)
    out = pim_gemm.pim_gemm_int(wq, xb, torch.ones(17), 0.5, w_bits=w_bits)
    assert out.shape == (9, 17)
    assert pim_gemm.INT_VARIANT_LAUNCHES == before


@pytest.mark.parametrize("w_bits,x_dtype,h,w,skew,want", [
    (8, torch.int8, 49152, 32, None, "rows1"),         # lm_head
    (8, torch.int16, 8448, 32, None, "rows4"),         # 264 blocks of 32
    (8, torch.int16, 8447, 32, None, "rows1"),
    (8, torch.int16, 4096, 4096, None, "rows1"),       # attn.wq, attn.wo
    (4, torch.int8, 14336, 64, None, "rows4"),         # mlp.w0 / w1
    (4, torch.int8, 1024, 4096, None, "rows1"),        # attn.wk / wv
    (4, torch.int16, 49152, 32, None, "rows2"),
    (4, torch.int16, 1, 32, None, "rows2"),
    (4, torch.int16, 17, 48, None, "bytes"),           # 24-byte rows
    (8, torch.int8, 17, 200, None, "bytes"),
    (8, torch.int8, 8448, 32, "w", "bytes"),
    (4, torch.int16, 17, 4096, "x", "bytes"),
])
def test_gemv_int_variant_is_chosen_by_shape_and_alignment(w_bits, x_dtype,
                                                           h, w, skew, want):
    """The int GEMV's kernel on the card: R rows per warp by format, the
    larger R where H fills two blocks of 8 x R per SM (an H100's 132);
    "bytes" for misaligned operands or rows that are not a multiple of
    16 bytes.  On CPU tensors the wrapper runs the plain version and
    counts nothing."""
    wq = torch.ones((h, w * w_bits // 8), dtype=torch.int8)
    x = torch.ones(w, dtype=x_dtype)
    if skew == "w":
        wq = chip_smoke.misaligned(wq)
    if skew == "x":
        x = chip_smoke.misaligned(x)
    assert pim_gemv.gemv_int_variant(wq, x, w_bits) == want
    before = (dict(pim_gemv.GEMV_INT_VARIANT_LAUNCHES),
              dict(pim_gemv.LAUNCHES))
    out = pim_gemv.pim_gemv_int(wq, x, torch.ones(h), 0.5, w_bits=w_bits)
    assert out.shape == (h,)
    assert (dict(pim_gemv.GEMV_INT_VARIANT_LAUNCHES),
            dict(pim_gemv.LAUNCHES)) == before


# ---------------------------------------------------------------------
# The full-width fixture (granite-8b, one layer + lm_head)
# ---------------------------------------------------------------------

def test_fixture_reproduced_at_one_full_width_site():
    """The smallest site (attn.wk, 1024 x 4096) through the port's
    plain path: int hashes equal, fp within the fixture's tolerance."""
    fixture = json.loads(FIXTURE.read_text())
    index, site = next((i, s) for i, s in enumerate(fixture["sites"])
                       if s["name"] == "attn.wk")
    wts, acts = chip_smoke.site_inputs(fixture["seed"], index, site["h"],
                                       site["w"])
    for dtype in ALL_DTYPES:
        qw = ops.prepare_weights(wts, dtype, device="cpu")
        for b in (1, 8):
            y = ops.pim_linear(acts[0] if b == 1 else acts, qw).numpy()
            key = f"{site['name']}/{dtype.name}/b{b}"
            assert chip_smoke.fixture_mismatch(
                fixture["results"][key], y, fixture["fp_rel_tol"]) is None


def test_fixture_covers_the_granite_sites():
    fixture = json.loads(FIXTURE.read_text())
    sites = ref_sites(ref_granite.CONFIG)
    assert [(s["name"], s["h"], s["w"]) for s in fixture["sites"]] \
        == [(s.name, s.h, s.w) for s in sites]
    assert len(fixture["results"]) == len(sites) * len(ALL_DTYPES) * 2


FP_REL_TOL = 1e-4


def _fixture() -> dict:
    import hashlib

    seed = 0
    sites = ref_sites(ref_granite.CONFIG)
    out = {"about": "tests/test_torch_pim_linear.py: one granite-8b layer "
                    "plus lm_head at full width through the JAX package's "
                    "pim_linear (int: Pallas interpret mode, sha256 of the "
                    "float32 output bytes) and pim_linear_ref (fp: a "
                    "strided sample, its sums of |w*x|, the output's sum "
                    "and largest magnitude). Inputs: chip_smoke.site_inputs"
                    "(seed, site index, h, w).",
           "seed": seed,
           "fp_rel_tol": FP_REL_TOL,
           "fp_tolerance": "|y - y_ref| <= fp_rel_tol * sum_w |w*x| per "
                           "sampled output; the sum within fp_rel_tol * "
                           "total_abs; max |y| within fp_rel_tol * "
                           "max_abs_sum",
           "sites": [dict(name=s.name, h=s.h, w=s.w) for s in sites],
           "results": {}}
    for index, s in enumerate(sites):
        wts, acts = chip_smoke.site_inputs(seed, index, s.h, s.w)
        for dtype in ALL_DTYPES:
            t0 = time.perf_counter()
            qw = jops.prepare_weights(wts, dtype.name)
            wabs = (np.abs(np.asarray(qw.q).astype(np.float32))
                    if dtype.is_fp else None)
            for b in (1, 8):
                x = acts[0] if b == 1 else acts
                key = f"{s.name}/{dtype.name}/b{b}"
                if not dtype.is_fp:
                    y = np.asarray(jops.pim_linear(x, qw, interpret=True),
                                   np.float32)
                    out["results"][key] = {"sha256": hashlib.sha256(
                        y.tobytes()).hexdigest()}
                    continue
                y = np.asarray(jops.pim_linear_ref(x, qw), np.float32)
                xk = np.abs(np.asarray(
                    jnp.asarray(x).astype(jnp.float8_e4m3fn if dtype.a_bits
                                          == 8 else jnp.bfloat16)
                ).astype(np.float32)).reshape(-1, s.w)
                abs_all = (xk @ wabs.T).reshape(-1)        # (B * H,)
                idx = chip_smoke.sample_index(y.size)
                rows = idx % s.h
                abs_s = np.einsum("kw,kw->k", wabs[rows].astype(np.float64),
                                  xk[idx // s.h].astype(np.float64))
                flat = y.reshape(-1).astype(np.float64)
                out["results"][key] = {
                    "idx": idx.tolist(), "y": flat[idx].tolist(),
                    "abs_sum": abs_s.tolist(), "sum": float(flat.sum()),
                    "max_abs": float(np.abs(flat).max()),
                    "total_abs": float(abs_all.astype(np.float64).sum()),
                    "max_abs_sum": float(abs_all.max())}
            print(f"{s.name} {s.h}x{s.w} {dtype.name}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


if __name__ == "__main__":          # regenerate the committed fixture
    FIXTURE.write_text(json.dumps(_fixture(), indent=1, sort_keys=True))
    print(f"wrote {FIXTURE}")

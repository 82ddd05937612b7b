// PIM-tile quantized GEMV for Hopper (sm_90a): y = W x, one output row per
// warp.
//
// Replaces the TPU kernels src/repro/kernels/pim_gemv.py:_gemv_int_kernel
// (int8 / packed int4 weights x int8 / int16 activations, int32 sums,
// dequantized by w_scale[h] * x_scale in the flush) and
// src/repro/kernels/pim_gemv.py:_gemv_fp_kernel (fp8-e4m3 weights x fp8 /
// bf16 activations, float32 sums).
//
// What bounds it on this card: bytes.  A GEMV does 2 operations per weight
// element, about 2 per weight byte against the ~590 int8 operations per
// byte at which the H100's tensor cores, not its memory, would be the
// limit; so the weight matrix streamed once from device memory is the
// whole cost.  The design reads each weight byte once with 16-byte loads
// (lane-strided, four in flight per lane, marked streaming so they do not
// evict x from L1), unpacks int4 and decodes fp8 in registers, keeps the
// small x vector in L1 via the read-only path, and writes one float per
// row.  No shared memory, no tensor cores: at 2 ops/byte they would idle.
#include "pim_tile.cuh"

namespace {

using namespace pim;

template <int WBITS, int XBYTES, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemv_int_kernel(const uint8_t* __restrict__ w,
                    const typename IntOp<WBITS, XBYTES>::X* __restrict__ x,
                    const float* __restrict__ ws, float* __restrict__ out,
                    int H, long long W) {
  const long long h =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (h >= H) return;                         // whole warps leave together
  const long long row_bytes = W * WBITS / 8;
  uint32_t acc[1] = {0u};
  row_dot<IntOp<WBITS, XBYTES>, 1, VEC>(w + h * row_bytes, row_bytes, x, 0, 1,
                                        acc);
  const uint32_t sum = warp_sum(acc[0]);
  if (threadIdx.x % kWarp == 0) out[h] = dequant(sum, ws[h]);
}

template <int XBYTES, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemv_fp_kernel(const uint8_t* __restrict__ w,
                   const typename FpOp<XBYTES>::X* __restrict__ x,
                   float* __restrict__ out, int H, long long W) {
  const long long h =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (h >= H) return;
  float acc[1] = {0.f};
  row_dot<FpOp<XBYTES>, 1, VEC>(w + h * W, W, x, 0, 1, acc);
  const float sum = warp_sum(acc[0]);
  if (threadIdx.x % kWarp == 0) out[h] = sum;
}

template <int WBITS, int XBYTES>
cudaError_t launch_int(const void* w, const void* x, const float* ws,
                       float* out, int H, long long W, bool vec,
                       cudaStream_t s) {
  using X = typename IntOp<WBITS, XBYTES>::X;
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* xp = static_cast<const X*>(x);
  if (vec)
    gemv_int_kernel<WBITS, XBYTES, true>
        <<<grid_for(H), kThreads, 0, s>>>(wp, xp, ws, out, H, W);
  else
    gemv_int_kernel<WBITS, XBYTES, false>
        <<<grid_for(H), kThreads, 0, s>>>(wp, xp, ws, out, H, W);
  return cudaGetLastError();
}

template <int XBYTES>
cudaError_t launch_fp(const void* w, const void* x, float* out, int H,
                      long long W, bool vec, cudaStream_t s) {
  using X = typename FpOp<XBYTES>::X;
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* xp = static_cast<const X*>(x);
  if (vec)
    gemv_fp_kernel<XBYTES, true>
        <<<grid_for(H), kThreads, 0, s>>>(wp, xp, out, H, W);
  else
    gemv_fp_kernel<XBYTES, false>
        <<<grid_for(H), kThreads, 0, s>>>(wp, xp, out, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y[h] = f32(sum_w W[h, w] * x[w] mod 2^32) * ws[h] for h < H.
// w: int8 (H, W) for w_bits 8, packed int4 (H, W/2) for w_bits 4;
// x: int8 (x_bytes 1) or int16 (x_bytes 2), (W,); ws, out: float32 (H,).
// vec: rows and x are 16-byte aligned and the row bytes a multiple of 16.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported format.
int pim_gemv_int_launch(const void* w, const void* x, const float* ws,
                        float* out, int H, long long W, int w_bits,
                        int x_bytes, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bits == 8 && x_bytes == 1)
    return launch_int<8, 1>(w, x, ws, out, H, W, vec, s);
  if (w_bits == 8 && x_bytes == 2)
    return launch_int<8, 2>(w, x, ws, out, H, W, vec, s);
  if (w_bits == 4 && x_bytes == 1)
    return launch_int<4, 1>(w, x, ws, out, H, W, vec, s);
  if (w_bits == 4 && x_bytes == 2)
    return launch_int<4, 2>(w, x, ws, out, H, W, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y[h] = sum_w f32(W[h, w]) * f32(x[w]), float32 sums.  w: fp8-e4m3 bits
// (H, W); x: fp8-e4m3 (x_bytes 1) or bf16 (x_bytes 2) bits, (W,).
int pim_gemv_fp_launch(const void* w, const void* x, float* out, int H,
                       long long W, int x_bytes, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bytes == 1) return launch_fp<1>(w, x, out, H, W, vec, s);
  if (x_bytes == 2) return launch_fp<2>(w, x, out, H, W, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

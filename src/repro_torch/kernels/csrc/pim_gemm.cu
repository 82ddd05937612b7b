// Batched PIM-tile quantized GEMM for Hopper (sm_90a): Y = X W^T for a
// decode batch, (B, W) x (H, W) -> (B, H).
//
// Replaces the TPU kernels src/repro/kernels/pim_gemm.py:_gemm_int_kernel
// (int8 / packed int4 weights x int8 / int16 activations, int32 sums,
// dequantized by the (1, H) scale row in the flush) and
// src/repro/kernels/pim_gemm.py:_gemm_fp_kernel (fp8-e4m3 weights x fp8 /
// bf16 activations, float32 sums).
//
// What bounds it on this card: bytes.  At a decode batch of B <= 8 rows the
// product does 2 B operations per weight byte (W8; 4 B for W4), far below
// the ~590 int8 operations per byte where the tensor cores would become
// the limit, so streaming the weights once is the cost.  The design is the
// GEMV's (one warp per weight row, 16-byte streaming loads, four in
// flight per lane, int4 / fp8 decoded in registers) with up to 8 batch
// rows' sums held in each lane's registers: a weight chunk is decoded
// once and multiplied against every row of the batch tile, so the weights
// cross device memory once per tile of 8.  Larger batches loop over tiles
// in the kernel (the weight row then comes back from L2).  The activation
// rows are read through L1; at 8 rows and bf16 that L1 traffic, not device
// memory, may bind first -- a later, faster version would stage them in
// shared memory or move to wgmma tiles.
#include "pim_tile.cuh"

namespace {

using namespace pim;

template <int WBITS, int XBYTES, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemm_int_kernel(const uint8_t* __restrict__ w,
                    const typename IntOp<WBITS, XBYTES>::X* __restrict__ x,
                    const float* __restrict__ ws, float* __restrict__ out,
                    int B, int H, long long W) {
  const long long h =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (h >= H) return;                         // whole warps leave together
  const long long row_bytes = W * WBITS / 8;
  const float scale = ws[h];
  for (int b0 = 0; b0 < B; b0 += kBatchTile) {
    const int nb = min(kBatchTile, B - b0);
    uint32_t acc[kBatchTile] = {};
    row_dot<IntOp<WBITS, XBYTES>, kBatchTile, VEC>(
        w + h * row_bytes, row_bytes, x + b0 * W, W, nb, acc);
#pragma unroll
    for (int b = 0; b < kBatchTile; ++b) {
      if (b < nb) {
        const uint32_t sum = warp_sum(acc[b]);
        if (threadIdx.x % kWarp == 0)
          out[(b0 + b) * static_cast<long long>(H) + h] = dequant(sum, scale);
      }
    }
  }
}

template <int XBYTES, bool VEC>
__global__ void __launch_bounds__(kThreads)
    gemm_fp_kernel(const uint8_t* __restrict__ w,
                   const typename FpOp<XBYTES>::X* __restrict__ x,
                   float* __restrict__ out, int B, int H, long long W) {
  const long long h =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (h >= H) return;
  for (int b0 = 0; b0 < B; b0 += kBatchTile) {
    const int nb = min(kBatchTile, B - b0);
    float acc[kBatchTile] = {};
    row_dot<FpOp<XBYTES>, kBatchTile, VEC>(w + h * W, W, x + b0 * W, W, nb,
                                           acc);
#pragma unroll
    for (int b = 0; b < kBatchTile; ++b) {
      if (b < nb) {
        const float sum = warp_sum(acc[b]);
        if (threadIdx.x % kWarp == 0)
          out[(b0 + b) * static_cast<long long>(H) + h] = sum;
      }
    }
  }
}

template <int WBITS, int XBYTES>
cudaError_t launch_int(const void* w, const void* x, const float* ws,
                       float* out, int B, int H, long long W, bool vec,
                       cudaStream_t s) {
  using X = typename IntOp<WBITS, XBYTES>::X;
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* xp = static_cast<const X*>(x);
  if (vec)
    gemm_int_kernel<WBITS, XBYTES, true>
        <<<grid_for(H), kThreads, 0, s>>>(wp, xp, ws, out, B, H, W);
  else
    gemm_int_kernel<WBITS, XBYTES, false>
        <<<grid_for(H), kThreads, 0, s>>>(wp, xp, ws, out, B, H, W);
  return cudaGetLastError();
}

template <int XBYTES>
cudaError_t launch_fp(const void* w, const void* x, float* out, int B, int H,
                      long long W, bool vec, cudaStream_t s) {
  using X = typename FpOp<XBYTES>::X;
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* xp = static_cast<const X*>(x);
  if (vec)
    gemm_fp_kernel<XBYTES, true>
        <<<grid_for(H), kThreads, 0, s>>>(wp, xp, out, B, H, W);
  else
    gemm_fp_kernel<XBYTES, false>
        <<<grid_for(H), kThreads, 0, s>>>(wp, xp, out, B, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[b, h] = f32(sum_w X[b, w] * W[h, w] mod 2^32) * ws[h].  w: int8
// (H, W) for w_bits 8, packed int4 (H, W/2) for w_bits 4; x: int8
// (x_bytes 1) or int16 (x_bytes 2), (B, W); ws: float32 (H,); out: float32
// (B, H).  vec as in pim_gemv_int_launch.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported format.
int pim_gemm_int_launch(const void* w, const void* x, const float* ws,
                        float* out, int B, int H, long long W, int w_bits,
                        int x_bytes, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bits == 8 && x_bytes == 1)
    return launch_int<8, 1>(w, x, ws, out, B, H, W, vec, s);
  if (w_bits == 8 && x_bytes == 2)
    return launch_int<8, 2>(w, x, ws, out, B, H, W, vec, s);
  if (w_bits == 4 && x_bytes == 1)
    return launch_int<4, 1>(w, x, ws, out, B, H, W, vec, s);
  if (w_bits == 4 && x_bytes == 2)
    return launch_int<4, 2>(w, x, ws, out, B, H, W, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[b, h] = sum_w f32(X[b, w]) * f32(W[h, w]), float32 sums.  w:
// fp8-e4m3 bits (H, W); x: fp8-e4m3 (x_bytes 1) or bf16 (x_bytes 2) bits,
// (B, W).
int pim_gemm_fp_launch(const void* w, const void* x, float* out, int B,
                       int H, long long W, int x_bytes, int vec,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bytes == 1) return launch_fp<1>(w, x, out, B, H, W, vec, s);
  if (x_bytes == 2) return launch_fp<2>(w, x, out, B, H, W, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

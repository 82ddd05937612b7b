// PIM-tile quantized GEMV for Hopper (sm_90a): y = W x.
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
// whole cost, and what must not bind first is the work per weight byte on
// the SM.  No shared memory pipeline, no tensor cores: at 2 ops/byte they
// would idle.
//
// int, vector path (gemv_int_rows_kernel): a warp takes R weight rows.
// Lane l loads the same 16-byte chunk columns of all R rows (streaming
// loads that ask L2 for 256-byte blocks, R x U in flight), loads and
// rearranges the matching activations once, and applies them to the R
// rows with dp4a (pim_tile.cuh, GemvChunk): int16 activations as two byte
// planes, int4 weights decoded in place by one or two ops per word.  So
// the activation loads and work per weight byte fall R-fold, and a warp
// keeps R times the bytes in flight; but R rows per warp also mean R
// times fewer warps and more registers, so the wrapper picks R by format
// and H (pim_gemv.py, gemv_int_variant; R = 1 fills the card best when H
// is small).  A lane's pointers step by whole passes, so the loop does no
// index arithmetic, and only the last pass checks the row's end.  The
// flush is the TPU kernel's: float32(int32 sum) times
// float32(w_scale[h] * x_scale), that product taken here rather than in a
// separate launch.
//
// int, byte-wise path (gemv_int_kernel): misaligned operands, or rows
// that are not a multiple of 16 bytes; one warp per row, one byte at a
// time.
//
// fp (gemv_fp_kernel): one warp per row; each lane streams 16-byte chunks
// (four in flight), decodes fp8 in registers, keeps the small x vector in
// L1 via the read-only path, and writes one float per row.
#include "pim_tile.cuh"

namespace {

using namespace pim;

template <int WBITS, int XBYTES>
__global__ void __launch_bounds__(kThreads)
    gemv_int_kernel(const uint8_t* __restrict__ w,
                    const typename IntOp<WBITS, XBYTES>::X* __restrict__ x,
                    const float* __restrict__ ws,
                    const float* __restrict__ xs, float* __restrict__ out,
                    int H, long long W) {
  const long long h =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (h >= H) return;                         // whole warps leave together
  const long long row_bytes = W * WBITS / 8;
  uint32_t acc[1] = {0u};
  row_dot<IntOp<WBITS, XBYTES>, 1, false>(w + h * row_bytes, row_bytes, x, 0,
                                          1, acc);
  const uint32_t sum = warp_sum(acc[0]);
  if (threadIdx.x % kWarp == 0) out[h] = dequant(sum, __fmul_rn(ws[h], *xs));
}

// One pass of a lane over U = kUnroll chunk columns (a warp's width
// apart) of its R rows: every load first, then the math; then the
// pointers move on.  A full pass loads all U; the last, partial one only
// the chunks before `left` and the rest not at all.
template <class Op, int R, bool kFull, int XBYTES>
__device__ __forceinline__ void rows_pass(const int4* (&wp)[R],
                                          const int4*& xp, long long left,
                                          uint32_t (&acc)[R][XBYTES],
                                          uint32_t (&xsum)[XBYTES]) {
  constexpr int kP = Op::kPieces, U = kUnroll;
  int4 wv[U][R];
  int4 xv[U][kP];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (kFull || u * kWarp < left) {
#pragma unroll
      for (int r = 0; r < R; ++r) wv[u][r] = ld_stream_256(wp[r] + u * kWarp);
#pragma unroll
      for (int p = 0; p < kP; ++p) xv[u][p] = __ldg(xp + u * kWarp * kP + p);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) wp[r] += U * kWarp;
  xp += U * kWarp * kP;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (kFull || u * kWarp < left) {
      const typename Op::XS xs = Op::split(xv[u], xsum);
#pragma unroll
      for (int r = 0; r < R; ++r) Op::mac(wv[u][r], xs, acc[r]);
    }
  }
}

// Rows past H read row H - 1 and are not stored.
template <int WBITS, int XBYTES, int R>
__global__ void __launch_bounds__(kThreads)
    gemv_int_rows_kernel(const uint8_t* __restrict__ w,
                         const uint8_t* __restrict__ x,
                         const float* __restrict__ ws,
                         const float* __restrict__ xs, float* __restrict__ out,
                         int H, long long W) {
  using Op = GemvChunk<WBITS, XBYTES>;
  constexpr int U = kUnroll;
  const int lane = threadIdx.x % kWarp;
  const long long h0 =
      (static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp)
      * R;
  if (h0 >= H) return;                        // whole warps leave together
  const long long row_bytes = W * WBITS / 8;
  const int4* wp[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    wp[r] = reinterpret_cast<const int4*>(
                w + (h0 + r < H ? h0 + r : H - 1) * row_bytes) + lane;
  const int4* xp = reinterpret_cast<const int4*>(x) + lane * Op::kPieces;
  uint32_t acc[R][XBYTES] = {};
  uint32_t xsum[XBYTES] = {};
  long long left = row_bytes / 16 - lane;     // chunks from this one on
  for (; left > (U - 1) * kWarp; left -= U * kWarp)
    rows_pass<Op, R, true>(wp, xp, left, acc, xsum);
  if (left > 0) rows_pass<Op, R, false>(wp, xp, left, acc, xsum);

  const float x_scale = *xs;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t sum = warp_sum(Op::finish(acc[r], xsum));
    if (lane == 0 && h0 + r < H)
      out[h0 + r] = dequant(sum, __fmul_rn(ws[h0 + r], x_scale));
  }
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

template <int WBITS, int XBYTES, int R>
cudaError_t launch_rows(const void* w, const void* x, const float* ws,
                        const float* xs, float* out, int H, long long W,
                        cudaStream_t s) {
  const int rows = kRowsPerBlock * R;
  gemv_int_rows_kernel<WBITS, XBYTES, R><<<(H + rows - 1) / rows, kThreads,
                                           0, s>>>(
      static_cast<const uint8_t*>(w), static_cast<const uint8_t*>(x), ws, xs,
      out, H, W);
  return cudaGetLastError();
}

// Weight rows per warp of the vector kernel, by format: R for small H and
// for large H, as the wrapper picks them (pim_gemv.py, GEMV_INT_ROWS);
// only these are built.
template <int WBITS, int XBYTES> struct Rows;
template <> struct Rows<8, 1> { static constexpr int kSmall = 1, kLarge = 1; };
template <> struct Rows<8, 2> { static constexpr int kSmall = 1, kLarge = 4; };
template <> struct Rows<4, 1> { static constexpr int kSmall = 1, kLarge = 4; };
template <> struct Rows<4, 2> { static constexpr int kSmall = 2, kLarge = 2; };

template <int WBITS, int XBYTES>
cudaError_t launch_int(const void* w, const void* x, const float* ws,
                       const float* xs, float* out, int H, long long W,
                       int rows, cudaStream_t s) {
  using R = Rows<WBITS, XBYTES>;
  if (rows == 0) {
    gemv_int_kernel<WBITS, XBYTES><<<grid_for(H), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(w),
        static_cast<const typename IntOp<WBITS, XBYTES>::X*>(x), ws, xs, out,
        H, W);
    return cudaGetLastError();
  }
  if (rows == R::kSmall)
    return launch_rows<WBITS, XBYTES, R::kSmall>(w, x, ws, xs, out, H, W, s);
  if (rows == R::kLarge)
    return launch_rows<WBITS, XBYTES, R::kLarge>(w, x, ws, xs, out, H, W, s);
  return cudaErrorInvalidValue;
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

// y[h] = f32(sum_w W[h, w] * x[w] mod 2^32) * f32(ws[h] * xs[0]) for
// h < H.  w: int8 (H, W) for w_bits 8, packed int4 (H, W/2) for w_bits 4;
// x: int8 (x_bytes 1) or int16 (x_bytes 2), (W,); ws, out: float32 (H,);
// xs: one float32.  rows 0: the byte-wise kernel (any alignment); else the
// vector kernel with that many rows per warp (one of the format's Rows),
// which needs w and x 16-byte aligned and the row bytes a multiple of 16.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported format or rows.
int pim_gemv_int_launch(const void* w, const void* x, const float* ws,
                        const float* xs, float* out, int H, long long W,
                        int w_bits, int x_bytes, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bits == 8 && x_bytes == 1)
    return launch_int<8, 1>(w, x, ws, xs, out, H, W, rows, s);
  if (w_bits == 8 && x_bytes == 2)
    return launch_int<8, 2>(w, x, ws, xs, out, H, W, rows, s);
  if (w_bits == 4 && x_bytes == 1)
    return launch_int<4, 1>(w, x, ws, xs, out, H, W, rows, s);
  if (w_bits == 4 && x_bytes == 2)
    return launch_int<4, 2>(w, x, ws, xs, out, H, W, rows, s);
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

// Batched PIM-tile quantized GEMM for Hopper (sm_90a): Y = X W^T for a
// decode batch, (B, W) x (H, W) -> (B, H).
//
// Replaces the TPU kernels src/repro/kernels/pim_gemm.py:22
// _gemm_int_kernel (int8 / packed int4 weights x int8 / int16
// activations, int32 sums, dequantized by the (1, H) scale row in the
// flush) and src/repro/kernels/pim_gemm.py:46 _gemm_fp_kernel (fp8-e4m3
// weights x fp8 / bf16 activations, float32 sums).
//
// What bounds it on this card: bytes.  At a decode batch of B <= 8 rows
// the product does 2 B operations per weight byte, far below the ~295
// per byte where even the bf16 tensor cores would become the limit, so
// streaming the weights once is the cost.  What must not bind first is
// the work per weight byte on the SM, so both GEMMs multiply on the
// tensor cores.
//
// int (gemm_int_mma_kernel): exact 8-bit integer tiles, mma.sync
// m16n8k32 .s8 with s32 accumulators, on the fp kernel's layout below
// (8 warps splitting the width in steps of 128 columns, the batch as N,
// 8 rows per tile, two N tiles per pass for B in 9-16), with one M tile
// of 16 weight rows per block for 8-bit weights and two for int4, whose
// rows are half as many bytes.  A lane loads 16 bytes of weight rows g
// and g + 8 and the matching activation bytes of batch row g; each MMA
// step takes 8 of its columns.
// W8A8 feeds the bytes as they are: two MMAs per 16-byte load and no
// decode.  Int4 weights are unpacked in registers to int8 in column
// order (a byte perm and a sign extension per 4 weights).  int16
// activations have no MMA: each is split x = 256 hi + lo into its signed
// high and unsigned low byte (a byte perm each), two MMAs (.s8.s8 and
// .s8.u8) take the same weight fragment, and the sums combine as
// (hi << 8) + lo in uint32_t.  Without .satfinite every s32 sum wraps
// mod 2^32 like the TPU's int32 accumulator, and the 8 warps' partial
// tiles are summed as uint32_t through shared memory, so every result is
// bit-exact and independent of the order of the sums.  The flush is the
// TPU kernel's: float32(int32 sum) times the row scale.  Nine other tile
// shapes (M tiles per block, loads per row and lane, 4 or 8 warps),
// timed on an H100 at lm_head, B = 8, gained at most 3 % with 8-bit
// weights; with int4 each with one M tile per block was 1-29 % slower.
//
// fp (gemm_fp_mma_kernel): the multiply moves to the tensor cores, so
// the work per weight byte falls from 8 scalar FMAs plus decode and L1
// loads to about one instruction.  A block owns one m16n8k16 M tile (16
// weight rows); its 8 warps split the width in spans of 128 columns; the
// batch is N, 8 rows per tile, and a batch larger than 8 takes two N
// tiles per pass (each decoded weight fragment feeds both) and further
// passes beyond 16.  Each lane loads 16 bytes of weight rows g and g + 8
// at columns 16t and 64 + 16t of its span -- four lanes read a row's
// whole 128-byte line -- with streaming loads that ask L2 for 256-byte
// blocks, all four in flight before any math, and decodes them in
// registers (pim_tile.cuh has the fragment layout and why no shared
// memory is needed).  FP_W8A8 runs the f16 MMA on e4m3 decoded to f16;
// FP_W8A16 the bf16 MMA on e4m3 decoded to bf16; both exact, with
// float32 accumulators.  The 8 warps' partial tiles are summed through
// shared memory in a fixed order, so results are deterministic.  Columns
// past W (W % 128 != 0), rows past H and batch rows past B load zeros in
// both operands' places and are never stored.  Two M tiles per block
// (sharing each activation fragment), four, 16 warps, L2 prefetches of
// the next span and 256-column spans all measured slower on the card.
//
// Operands that are not 16-byte aligned, or weight rows that are not a
// multiple of 16 bytes, take gemm_int_kernel / gemm_fp_kernel: one warp
// per weight row, one byte at a time, up to 8 batch rows' sums in each
// lane's registers.  The wrapper chooses by shape and alignment.
#include "pim_tile.cuh"

namespace {

using namespace pim;

template <int WBITS, int XBYTES>
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
    row_dot<IntOp<WBITS, XBYTES>, kBatchTile, false>(
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

template <int XBYTES>
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
    row_dot<FpOp<XBYTES>, kBatchTile, false>(w + h * W, W, x + b0 * W, W,
                                             nb, acc);
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

constexpr int kMmaWarps = 8;                 // split the width
constexpr int kMmaThreads = kWarp * kMmaWarps;
constexpr int kMmaRows = 16;                 // one M tile per block
constexpr int kMmaSpan = 128;                // columns per warp step

// NT: N tiles (8 batch rows each) per pass over the weights.
template <int XBYTES, int NT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    gemm_fp_mma_kernel(const uint8_t* __restrict__ w,
                       const uint8_t* __restrict__ x,
                       float* __restrict__ out, int B, int H, long long W) {
  __shared__ float part[kMmaWarps][NT * 4][kWarp];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kMmaRows;
  const long long spans = (W + kMmaSpan - 1) / kMmaSpan;
  const int4 zero = make_int4(0, 0, 0, 0);

  for (int b0 = 0; b0 < B; b0 += 8 * NT) {
    float acc[NT][4] = {};
    for (long long sp = warp; sp < spans; sp += kMmaWarps) {
      const long long col0 = sp * kMmaSpan + 16 * t;
      int4 wv[2][2];                         // [row g, g + 8][half]
      int4 xv[NT][2][XBYTES];                // [N tile][half][16 B piece]
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long long row = row0 + 8 * r + g;
          const long long col = col0 + 64 * hf;
          wv[r][hf] = row < H && col < W ? ld_stream_256(w + row * W + col)
                                         : zero;
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int p = 0; p < XBYTES; ++p) {
            const long long b = b0 + 8 * nt + g;
            const long long col = col0 + 64 * hf;
            xv[nt][hf][p] =
                b < B && col < W
                    ? __ldg(reinterpret_cast<const int4*>(
                                x + (b * W + col) * XBYTES) + p)
                    : zero;
          }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int s = 0; s < 4; ++s) {        // MMA step: columns 4s..4s+3
          const uint32_t lo = word(wv[0][hf], s), hi = word(wv[1][hf], s);
          uint32_t a[4];
          if constexpr (XBYTES == 1) {
            a[0] = e4m3x2_f16x2(lo);
            a[1] = e4m3x2_f16x2(hi);
            a[2] = e4m3x2_f16x2(lo >> 16);
            a[3] = e4m3x2_f16x2(hi >> 16);
          } else {
            a[0] = e4m3x2_bf16x2(lo);
            a[1] = e4m3x2_bf16x2(hi);
            a[2] = e4m3x2_bf16x2(lo >> 16);
            a[3] = e4m3x2_bf16x2(hi >> 16);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (NT > 1 && b0 + 8 * nt >= B) continue;  // warp-uniform
            uint32_t b[2];
            if constexpr (XBYTES == 1) {
              const uint32_t xw = word(xv[nt][hf][0], s);
              b[0] = e4m3x2_f16x2(xw);
              b[1] = e4m3x2_f16x2(xw >> 16);
            } else {                         // bf16: already the MMA type
              b[0] = word(xv[nt][hf][s / 2], 2 * (s % 2));
              b[1] = word(xv[nt][hf][s / 2], 2 * (s % 2) + 1);
            }
            mma_16816<XBYTES == 2>(acc[nt], a, b[0], b[1]);
          }
        }
    }

    // The block's 8 partial tiles, summed in warp order.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[warp][nt * 4 + j][lane] = acc[nt][j];
    __syncthreads();
    for (int i = threadIdx.x; i < NT * 4 * kWarp; i += kMmaThreads) {
      const int reg = i / kWarp, ln = i % kWarp;
      float sum = part[0][reg][ln];
#pragma unroll
      for (int k = 1; k < kMmaWarps; ++k) sum += part[k][reg][ln];
      const int nt = reg / 4, j = reg % 4;
      const long long h = row0 + ln / 4 + 8 * (j / 2);
      const long long b = b0 + 8 * nt + 2 * (ln % 4) + j % 2;
      if (h < H && b < B) out[b * H + h] = sum;
    }
    __syncthreads();                         // part is reused next pass
  }
}

// MMA step s of a lane's 16 weight bytes covers its columns 8s ... 8s+7,
// in natural order: a0 / a1 (rows g, g + 8) and b0 hold columns 8s ...
// 8s+3, a2 / a3 and b1 columns 8s+4 ... 8s+7.  W8: weight words 2s and
// 2s+1 as they are.  W4: weight word s holds the eight nibbles (the low
// one the even column); __byte_perm puts each column's nibble in the low
// half of its own byte, in column order, and nibs_lo4 sign-extends them.
template <int WBITS>
__device__ __forceinline__ void int_a_frag(const int4& r0, const int4& r1,
                                           int s, uint32_t (&a)[4]) {
  if constexpr (WBITS == 8) {
    a[0] = word(r0, 2 * s);
    a[1] = word(r1, 2 * s);
    a[2] = word(r0, 2 * s + 1);
    a[3] = word(r1, 2 * s + 1);
  } else {
    const uint32_t w0 = word(r0, s), w1 = word(r1, s);
    a[0] = nibs_lo4(__byte_perm(w0, w0 >> 4, 0x5140));
    a[1] = nibs_lo4(__byte_perm(w1, w1 >> 4, 0x5140));
    a[2] = nibs_lo4(__byte_perm(w0, w0 >> 4, 0x7362));
    a[3] = nibs_lo4(__byte_perm(w1, w1 >> 4, 0x7362));
  }
}

// 32-bit word i of a lane's activation pieces (16 bytes each).
template <int N>
__device__ __forceinline__ uint32_t piece_word(const int4 (&p)[N], int i) {
  return word(p[i / 4], i % 4);
}

// M tiles (16 weight rows each) per block.  A warp step covers 128
// columns: for 8-bit weights two 16-byte loads per row and lane of one M
// tile, as in the fp kernel; int4 rows hold those columns in 64 bytes, so
// a block takes two M tiles and each activation fragment feeds both.
template <int WBITS>
constexpr int kIntMmaTiles = 8 / WBITS;

// NT: N tiles (8 batch rows each) per pass over the weights.
template <int WBITS, int XBYTES, int NT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    gemm_int_mma_kernel(const uint8_t* __restrict__ w,
                        const uint8_t* __restrict__ x,
                        const float* __restrict__ ws, float* __restrict__ out,
                        int B, int H, long long W) {
  constexpr int MT = kIntMmaTiles<WBITS>;
  constexpr int HF = WBITS / 4;              // 16 B loads per row and lane
  constexpr int kCols = 8 / WBITS;           // columns per weight byte
  constexpr int kSteps = 2 * kCols;          // MMA steps per 16 weight bytes
  constexpr int kPieces = kCols * XBYTES;    // 16 B activation pieces per 16
  constexpr int kSpan = 64 * HF;             // weight bytes per warp step
  __shared__ uint32_t part[kMmaWarps][MT * NT * 4][kWarp];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * kMmaRows * MT;
  const long long row_bytes = W * WBITS / 8;
  const long long spans = (row_bytes + kSpan - 1) / kSpan;
  const int4 zero = make_int4(0, 0, 0, 0);

  for (int b0 = 0; b0 < B; b0 += 8 * NT) {
    uint32_t acc[MT][NT][XBYTES][4] = {};    // A16: [hi, lo] byte planes
    for (long long sp = warp; sp < spans; sp += kMmaWarps) {
      const long long off0 = sp * kSpan + 16 * t;
      int4 wv[MT][2][HF];                    // [M tile][row g, g + 8][load]
      int4 xv[NT][HF][kPieces];              // [N tile][load][16 B piece]
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int hf = 0; hf < HF; ++hf) {
            const long long row = row0 + kMmaRows * m + 8 * r + g;
            const long long off = off0 + 64 * hf;
            wv[m][r][hf] = row < H && off < row_bytes
                               ? ld_stream_256(w + row * row_bytes + off)
                               : zero;
          }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hf = 0; hf < HF; ++hf)
#pragma unroll
          for (int p = 0; p < kPieces; ++p) {
            const long long b = b0 + 8 * nt + g;
            const long long off = off0 + 64 * hf;
            xv[nt][hf][p] =
                b < B && off < row_bytes
                    ? __ldg(reinterpret_cast<const int4*>(
                                x + (b * W + off * kCols) * XBYTES) + p)
                    : zero;
          }
#pragma unroll
      for (int hf = 0; hf < HF; ++hf)
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {   // columns 8s ... 8s+7
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            int_a_frag<WBITS>(wv[m][0][hf], wv[m][1][hf], s, a[m]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (NT > 1 && b0 + 8 * nt >= B) continue;  // warp-uniform
            const int4(&xp)[kPieces] = xv[nt][hf];
            if constexpr (XBYTES == 1) {     // activation words 2s, 2s+1
              const uint32_t x0 = piece_word(xp, 2 * s);
              const uint32_t x1 = piece_word(xp, 2 * s + 1);
#pragma unroll
              for (int m = 0; m < MT; ++m)
                mma_16832_s8<true>(acc[m][nt][0], a[m], x0, x1);
            } else {
              // int16 x = 256 hi + lo, hi the signed high byte, lo the
              // unsigned low one.  The step's columns 8s ... 8s+3 (b0)
              // are activation words 4s, 4s+1, and 8s+4 ... 8s+7 (b1)
              // words 4s+2, 4s+3: an 8-bit weight word q (columns 4q ...
              // 4q+3) pairs with activation words 2q and 2q+1.
              const uint32_t x0 = piece_word(xp, 4 * s);
              const uint32_t x1 = piece_word(xp, 4 * s + 1);
              const uint32_t x2 = piece_word(xp, 4 * s + 2);
              const uint32_t x3 = piece_word(xp, 4 * s + 3);
              const uint32_t hi0 = __byte_perm(x0, x1, 0x7531);
              const uint32_t hi1 = __byte_perm(x2, x3, 0x7531);
              const uint32_t lo0 = __byte_perm(x0, x1, 0x6420);
              const uint32_t lo1 = __byte_perm(x2, x3, 0x6420);
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                mma_16832_s8<true>(acc[m][nt][0], a[m], hi0, hi1);
                mma_16832_s8<false>(acc[m][nt][1], a[m], lo0, lo1);
              }
            }
          }
        }
    }

    // x = 256 hi + lo, so the sum is 256 sum(hi) + sum(lo), mod 2^32;
    // then the block's partial tiles, summed in warp order.
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t v = acc[m][nt][0][j];
          if constexpr (XBYTES == 2) v = (v << 8) + acc[m][nt][1][j];
          part[warp][(m * NT + nt) * 4 + j][lane] = v;
        }
    __syncthreads();
    for (int i = threadIdx.x; i < MT * NT * 4 * kWarp; i += kMmaThreads) {
      const int reg = i / kWarp, ln = i % kWarp;
      uint32_t sum = part[0][reg][ln];
#pragma unroll
      for (int k = 1; k < kMmaWarps; ++k) sum += part[k][reg][ln];
      const int m = reg / (4 * NT), nt = reg / 4 % NT, j = reg % 4;
      const long long h = row0 + kMmaRows * m + ln / 4 + 8 * (j / 2);
      const long long b = b0 + 8 * nt + 2 * (ln % 4) + j % 2;
      if (h < H && b < B) out[b * H + h] = dequant(sum, ws[h]);
    }
    __syncthreads();                         // part is reused next pass
  }
}

template <int WBITS, int XBYTES>
cudaError_t launch_int(const void* w, const void* x, const float* ws,
                       float* out, int B, int H, long long W, bool vec,
                       cudaStream_t s) {
  const auto* wp = static_cast<const uint8_t*>(w);
  if (!vec) {
    gemm_int_kernel<WBITS, XBYTES><<<grid_for(H), kThreads, 0, s>>>(
        wp, static_cast<const typename IntOp<WBITS, XBYTES>::X*>(x), ws, out,
        B, H, W);
    return cudaGetLastError();
  }
  const auto* xp = static_cast<const uint8_t*>(x);
  const int rows = kMmaRows * kIntMmaTiles<WBITS>;
  const int grid = (H + rows - 1) / rows;
  if (B <= 8)
    gemm_int_mma_kernel<WBITS, XBYTES, 1><<<grid, kMmaThreads, 0, s>>>(
        wp, xp, ws, out, B, H, W);
  else
    gemm_int_mma_kernel<WBITS, XBYTES, 2><<<grid, kMmaThreads, 0, s>>>(
        wp, xp, ws, out, B, H, W);
  return cudaGetLastError();
}

template <int XBYTES>
cudaError_t launch_fp(const void* w, const void* x, float* out, int B, int H,
                      long long W, bool vec, cudaStream_t s) {
  const auto* wp = static_cast<const uint8_t*>(w);
  if (!vec) {
    gemm_fp_kernel<XBYTES><<<grid_for(H), kThreads, 0, s>>>(
        wp, static_cast<const typename FpOp<XBYTES>::X*>(x), out, B, H, W);
    return cudaGetLastError();
  }
  const auto* xp = static_cast<const uint8_t*>(x);
  const int grid = (H + kMmaRows - 1) / kMmaRows;
  if (B <= 8)
    gemm_fp_mma_kernel<XBYTES, 1><<<grid, kMmaThreads, 0, s>>>(wp, xp, out, B,
                                                               H, W);
  else
    gemm_fp_mma_kernel<XBYTES, 2><<<grid, kMmaThreads, 0, s>>>(wp, xp, out, B,
                                                               H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[b, h] = f32(sum_w X[b, w] * W[h, w] mod 2^32) * ws[h].  w: int8
// (H, W) for w_bits 8, packed int4 (H, W/2) for w_bits 4; x: int8
// (x_bytes 1) or int16 (x_bytes 2), (B, W); ws: float32 (H,); out: float32
// (B, H).  vec 1 (both 16-byte aligned, row bytes % 16 == 0): the
// tensor-core kernel; vec 0: the byte-wise one.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// unsupported format.
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
// (B, W).  vec 1 (both 16-byte aligned, W % 16 == 0): the tensor-core
// kernel; vec 0: the byte-wise one.
int pim_gemm_fp_launch(const void* w, const void* x, float* out, int B,
                       int H, long long W, int x_bytes, int vec,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bytes == 1) return launch_fp<1>(w, x, out, B, H, W, vec, s);
  if (x_bytes == 2) return launch_fp<2>(w, x, out, B, H, W, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

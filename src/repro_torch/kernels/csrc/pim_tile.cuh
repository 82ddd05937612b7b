// Device code shared by the PIM-tile GEMV and GEMM kernels (pim_gemv.cu,
// pim_gemm.cu): how one warp takes the dot products of one weight row
// with up to NB activation rows, the tensor-core tile layout, decoders
// and MMAs of the fp and int GEMMs, and (at the end) one weight chunk of
// the int GEMV's vector kernel, which gives a warp R rows.
//
// Layout: weights are row-major (H, row_bytes); int4 rows hold two signed
// nibbles per byte, the low nibble being the even column.  Activations
// are row-major (B, W).  A warp walks its weight row in 16-byte chunks,
// lane-strided, kUnroll chunks in flight per lane; each chunk is decoded
// once in registers and multiplied against every activation row.
//
// Numerics (held bit for bit to the JAX package's Pallas kernels):
// * int: every product is an exact int; a chunk's partial sum fits in
//   int32 (at most 32 products of |w| <= 128 and |x| <= 32768, < 2^27);
//   the running sum is uint32_t, so it wraps mod 2^32 as the TPU's int32
//   accumulator does, with no signed overflow, and any summation order
//   gives the same bits.
// * fp: fp8 x fp8 and fp8 x bf16 products are exact in float32 (at most
//   4 + 8 significant bits), so fmaf adds exact products; only the order
//   of the float32 sums differs from other implementations.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace pim {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;             // one warp per weight row
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kUnroll = 4;                   // 16-byte loads in flight/lane
constexpr int kBatchTile = 8;                // GEMM rows per warp pass

// ---- element decoding ----------------------------------------------------

__device__ __forceinline__ int s8(uint32_t word, int byte) {
  return static_cast<int8_t>((word >> (8 * byte)) & 0xFFu);
}

__device__ __forceinline__ int s16(uint32_t word, int half) {
  return static_cast<int16_t>((word >> (16 * half)) & 0xFFFFu);
}

// Signed nibbles of one byte: (int8_t)(b << 4) >> 4 and (int8_t)b >> 4.
__device__ __forceinline__ int nib_lo(uint32_t b) {
  return static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4;
}
__device__ __forceinline__ int nib_hi(uint32_t b) {
  return static_cast<int8_t>(static_cast<uint8_t>(b)) >> 4;
}

// Four packed int4 weights' low / high nibbles as four sign-extended
// int8 lanes each ((v ^ 8) - 8 per byte, no borrow between bytes).
__device__ __forceinline__ int nibs_lo4(uint32_t w) {
  return static_cast<int>(__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u,
                                  0x08080808u));
}
__device__ __forceinline__ int nibs_hi4(uint32_t w) {
  return static_cast<int>(__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                                  0x08080808u));
}

__device__ __forceinline__ float e4m3(uint32_t byte) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(byte & 0xFFu), __NV_E4M3);
  return __half2float(__half(h));
}

// Two e4m3 values in the low 16 bits (the low byte first).
__device__ __forceinline__ float2 e4m3x2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// bf16 -> float is exact: the bf16 bits are the float's top half.
__device__ __forceinline__ float bf16_lo(uint32_t word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t word) {
  return __uint_as_float(word & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t word(const int4& v, int i) {
  return static_cast<uint32_t>(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z
                                                                    : v.w);
}

// ---- one chunk of one row: the multiply-accumulate per weight format -----
//
// Each Op gives the activation element type X, the accumulator Acc, the
// elements in a 16-byte weight chunk, the chunk decoded once (W), its
// product with one activation row's matching elements (mac, 16-byte
// aligned x), and the same for one weight byte (mac_byte, any alignment).

template <int WBITS, int XBYTES>
struct IntOp;

// W8 x A8: four dp4a over the chunk's four words.
template <>
struct IntOp<8, 1> {
  using X = int8_t;
  using Acc = uint32_t;
  static constexpr int kElems = 16;
  struct W { int v[4]; };
  __device__ static W decode(const int4& c) { return {{c.x, c.y, c.z, c.w}}; }
  __device__ static void mac(const W& w, const X* x, Acc& acc) {
    const int4 xv = __ldg(reinterpret_cast<const int4*>(x));
    int s = __dp4a(w.v[0], xv.x, 0);
    s = __dp4a(w.v[1], xv.y, s);
    s = __dp4a(w.v[2], xv.z, s);
    s = __dp4a(w.v[3], xv.w, s);
    acc += static_cast<uint32_t>(s);
  }
  __device__ static void mac_byte(uint32_t b, const X* x, long long k,
                                  Acc& acc) {
    acc += static_cast<uint32_t>(static_cast<int8_t>(b) * int(x[k]));
  }
};

// W4 x A8: each weight word splits into its even and odd columns as
// int8x4; the activation bytes are gathered to match; eight dp4a.
template <>
struct IntOp<4, 1> {
  using X = int8_t;
  using Acc = uint32_t;
  static constexpr int kElems = 32;
  struct W { int lo[4], hi[4]; };
  __device__ static W decode(const int4& c) {
    W w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w.lo[i] = nibs_lo4(word(c, i));
      w.hi[i] = nibs_hi4(word(c, i));
    }
    return w;
  }
  __device__ static void mac(const W& w, const X* x, Acc& acc) {
    const int4* xp = reinterpret_cast<const int4*>(x);
    const int4 a = __ldg(xp), b = __ldg(xp + 1);
    int s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // weight word i covers columns 8i..8i+7 = activation words 2i, 2i+1
      const uint32_t x0 = word(i < 2 ? a : b, (2 * i) % 4);
      const uint32_t x1 = word(i < 2 ? a : b, (2 * i) % 4 + 1);
      s = __dp4a(w.lo[i], static_cast<int>(__byte_perm(x0, x1, 0x6420)), s);
      s = __dp4a(w.hi[i], static_cast<int>(__byte_perm(x0, x1, 0x7531)), s);
    }
    acc += static_cast<uint32_t>(s);
  }
  __device__ static void mac_byte(uint32_t b, const X* x, long long k,
                                  Acc& acc) {
    acc += static_cast<uint32_t>(nib_lo(b) * int(x[2 * k])
                                 + nib_hi(b) * int(x[2 * k + 1]));
  }
};

// W8 x A16: int16 activations have no dp4a form; 16 integer MACs.
template <>
struct IntOp<8, 2> {
  using X = int16_t;
  using Acc = uint32_t;
  static constexpr int kElems = 16;
  struct W { int4 c; };
  __device__ static W decode(const int4& c) { return {c}; }
  __device__ static void mac(const W& w, const X* x, Acc& acc) {
    const int4* xp = reinterpret_cast<const int4*>(x);
    const int4 a = __ldg(xp), b = __ldg(xp + 1);
    int s = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t xw = word(e < 8 ? a : b, (e % 8) / 2);
      s += s8(word(w.c, e / 4), e % 4) * s16(xw, e % 2);
    }
    acc += static_cast<uint32_t>(s);
  }
  __device__ static void mac_byte(uint32_t b, const X* x, long long k,
                                  Acc& acc) {
    acc += static_cast<uint32_t>(static_cast<int8_t>(b) * int(x[k]));
  }
};

// W4 x A16: 32 integer MACs on nibbles unpacked in registers.
template <>
struct IntOp<4, 2> {
  using X = int16_t;
  using Acc = uint32_t;
  static constexpr int kElems = 32;
  struct W { int4 c; };
  __device__ static W decode(const int4& c) { return {c}; }
  __device__ static void mac(const W& w, const X* x, Acc& acc) {
    const int4* xp = reinterpret_cast<const int4*>(x);
    int s = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {             // 8 columns per weight word
      const int4 xv = __ldg(xp + q);
      const uint32_t ww = word(w.c, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {           // byte j: columns 2j, 2j+1
        const uint32_t b = (ww >> (8 * j)) & 0xFFu;
        const uint32_t xw = word(xv, j);
        s += nib_lo(b) * s16(xw, 0) + nib_hi(b) * s16(xw, 1);
      }
    }
    acc += static_cast<uint32_t>(s);
  }
  __device__ static void mac_byte(uint32_t b, const X* x, long long k,
                                  Acc& acc) {
    acc += static_cast<uint32_t>(nib_lo(b) * int(x[2 * k])
                                 + nib_hi(b) * int(x[2 * k + 1]));
  }
};

// fp8-e4m3 weights x fp8-e4m3 (XBYTES 1) or bf16 (XBYTES 2) activations.
template <int XBYTES>
struct FpOp {
  using X = typename std::conditional<XBYTES == 1, uint8_t, uint16_t>::type;
  using Acc = float;
  static constexpr int kElems = 16;
  struct W { float v[16]; };
  __device__ static W decode(const int4& c) {
    W w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = e4m3x2(word(c, i)), q = e4m3x2(word(c, i) >> 16);
      w.v[4 * i] = p.x;
      w.v[4 * i + 1] = p.y;
      w.v[4 * i + 2] = q.x;
      w.v[4 * i + 3] = q.y;
    }
    return w;
  }
  __device__ static void mac(const W& w, const X* x, Acc& acc) {
    const int4* xp = reinterpret_cast<const int4*>(x);
    if constexpr (XBYTES == 1) {
      const int4 xv = __ldg(xp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 p = e4m3x2(word(xv, i)), q = e4m3x2(word(xv, i) >> 16);
        acc = fmaf(w.v[4 * i], p.x, acc);
        acc = fmaf(w.v[4 * i + 1], p.y, acc);
        acc = fmaf(w.v[4 * i + 2], q.x, acc);
        acc = fmaf(w.v[4 * i + 3], q.y, acc);
      }
    } else {
      const int4 a = __ldg(xp), b = __ldg(xp + 1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t xw = word(i < 4 ? a : b, i % 4);
        acc = fmaf(w.v[2 * i], bf16_lo(xw), acc);
        acc = fmaf(w.v[2 * i + 1], bf16_hi(xw), acc);
      }
    }
  }
  __device__ static void mac_byte(uint32_t b, const X* x, long long k,
                                  Acc& acc) {
    const float xv = XBYTES == 1 ? e4m3(x[k]) : bf16_lo(x[k]);
    acc = fmaf(e4m3(b), xv, acc);
  }
};

// ---- one warp, one weight row, up to NB activation rows ------------------
//
// acc[b] (b < nb) gets this lane's share of row . x[b]; the caller
// reduces across the warp.  VEC: the row and x are 16-byte aligned and
// row_bytes % 16 == 0, so whole chunks are loaded; otherwise one byte at
// a time (ragged widths and misaligned views).
template <class Op, int NB, bool VEC>
__device__ __forceinline__ void row_dot(
    const uint8_t* __restrict__ wrow, long long row_bytes,
    const typename Op::X* __restrict__ x, long long x_stride, int nb,
    typename Op::Acc (&acc)[NB]) {
  const int lane = threadIdx.x % kWarp;
  if constexpr (VEC) {
    const int4* w4 = reinterpret_cast<const int4*>(wrow);
    const long long n = row_bytes / 16;
    for (long long c0 = lane; c0 < n; c0 += kWarp * kUnroll) {
      int4 chunk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {     // all loads first, then math
        const long long c = c0 + u * kWarp;
        chunk[u] = c < n ? __ldcs(w4 + c) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long c = c0 + u * kWarp;
        if (c < n) {
          const typename Op::W w = Op::decode(chunk[u]);
#pragma unroll
          for (int b = 0; b < NB; ++b)
            if (b < nb) Op::mac(w, x + b * x_stride + c * Op::kElems, acc[b]);
        }
      }
    }
  } else {
    for (long long k = lane; k < row_bytes; k += kWarp) {
      const uint32_t byte = wrow[k];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (b < nb) Op::mac_byte(byte, x + b * x_stride, k, acc[b]);
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// The TPU kernel's flush: int32 sum -> float32, times the row scale.
__device__ __forceinline__ float dequant(uint32_t acc, float ws) {
  return __fmul_rn(__int2float_rn(static_cast<int32_t>(acc)), ws);
}

inline int grid_for(int rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

// ---- tensor-core tiles: mma.sync m16n8k16 with the batch as N ------------
//
// Weight rows are M (16 per tile), batch rows are N (8 per tile).  In
// m16n8k16 lane (g = lane / 4, t = lane % 4) holds A at rows g and g + 8,
// B at column g, and both at the K slots {2t, 2t+1, 2t+8, 2t+9}; C holds
// rows g and g + 8 at columns 2t and 2t + 1.  A and B share the K slots,
// so the K order may be relabelled freely: lane (g, t) loads 16
// contiguous columns c + 16t ... c + 16t + 15 of weight rows g and g + 8
// and of batch row g, and 32-bit word s of those 16 (columns c + 16t + 4s
// ... + 4s + 3) feeds MMA step s: its low column pair takes the slots
// {2t, 2t+1}, its high pair {2t+8, 2t+9}.  Four lanes then cover 64
// columns per step, four steps per 16-byte load, and no shared memory
// is needed to reshuffle anything.
//
// Decoding keeps every value exact: e4m3 -> f16 is exact (cvt.f16x2.e4m3x2,
// NaN stays NaN), and so is f16 -> f32 -> bf16 for an e4m3 value (at most
// 4 significant bits, exponents 2^-9 ... 2^8).  Products of two such
// values, or of e4m3 and bf16, are exact in the MMA; only the order of
// the float32 sums differs from a scalar loop.

// 16 bytes, streamed (evict-first), asking L2 to fetch the whole
// 256-byte block around them from device memory at once.
__device__ __forceinline__ int4 ld_stream_256(const void* p) {
  int4 v;
  asm volatile("ld.global.cs.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Two e4m3 bytes (the low 16 bits) -> f16x2, the low byte in the low half.
__device__ __forceinline__ uint32_t e4m3x2_f16x2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  return static_cast<uint32_t>(h.x) | (static_cast<uint32_t>(h.y) << 16);
}

// Two e4m3 bytes -> bf16x2, through f16 and f32 (exact; NaN stays NaN).
__device__ __forceinline__ uint32_t e4m3x2_bf16x2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  const __nv_bfloat162_raw b =
      __float22bfloat162_rn(__half22float2(__half2(h)));
  return static_cast<uint32_t>(b.x) | (static_cast<uint32_t>(b.y) << 16);
}

// d += a . b for one m16n8k16 tile, float32 accumulators; BF16 picks the
// bf16 operand type, else f16.
template <bool BF16>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (BF16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// ---- tensor-core int tiles: mma.sync m16n8k32 on 8-bit integers ----------
//
// The same tiles, 32 K slots deep: lane (g, t) holds A at rows g (a0, a2)
// and g + 8 (a1, a3), B at column g, both at the K slots {4t ... 4t+3}
// (a0, a1, b0) and {16+4t ... 16+4t+3} (a2, a3, b1), four 8-bit values
// per register; C as in m16n8k16.  So one 32-bit word of a weight row and
// one of an activation row, holding the same four columns in the same
// byte order, fill one register each: the K order is relabelled in
// registers exactly as for m16n8k16.
//
// 8-bit products are exact and the s32 accumulators are added mod 2^32:
// without .satfinite the MMA does not clamp, so its sums wrap as the
// TPU's int32 accumulator does, and sums of such sums taken as uint32_t
// in any order give the same bits.  A is signed; S8B picks a signed B,
// else unsigned (the low byte plane of an int16 activation).
template <bool S8B>
__device__ __forceinline__ void mma_16832_s8(uint32_t (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  if constexpr (S8B) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// ---- the int GEMV's vector path: R weight rows per warp ------------------
//
// A lane takes the same 16-byte chunk columns of R weight rows, so the
// activations it loads for a chunk, and their rearranging, serve all R
// rows; each weight word then takes one or two ops to decode and one dp4a
// per activation word it meets.
//
// int16 activations: x = 256 hi + lo, hi the signed high byte and lo the
// unsigned low one, split with one byte perm per plane and four columns
// (as the int MMA GEMM does); the row sum is (sum w hi << 8) + sum w lo.
// 8-bit weights meet the activations in column order.  int4 weights are
// decoded where they lie: a weight word holds 8 columns, the even ones in
// its low nibbles and the odd ones in its high nibbles, so one LOP3 (and
// a shift for the high nibbles) masks them and flips their sign bits,
// giving u = s + 8 in [0, 15] for each signed nibble s, and the
// activations are rearranged once, into the matching even and odd
// columns, for all R rows.  The sums are taken over u (dp4a with an
// unsigned first operand) and corrected once per row by sum s x = sum u x
// - 8 sum x, sum x being the same for every row.  All of it is exact mod
// 2^32: dp4a adds without saturating, and any order of uint32_t sums
// gives the same bits.

// c + the four byte products of a and b, mod 2^32; SA, SB: a, b signed.
template <bool SA, bool SB>
__device__ __forceinline__ uint32_t dp4a(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  if constexpr (SA && SB)
    asm("dp4a.s32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else if constexpr (SA)
    asm("dp4a.s32.u32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else if constexpr (SB)
    asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  else
    asm("dp4a.u32.u32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The low nibble of each byte of v, its sign bit flipped: u = s + 8 per
// byte, (v & 0x0F0F0F0F) ^ 0x08080808 in one LOP3.
__device__ __forceinline__ uint32_t nibs_biased(uint32_t v) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
      : "=r"(d)
      : "r"(v), "r"(0x0F0F0F0Fu), "r"(0x08080808u));
  return d;
}

// One 16-byte weight chunk of a (WBITS, XBYTES) GEMV row: its kCols
// columns, the kPieces 16-byte activation loads that match it, those
// activations as int8x4 words (XS: the int8 values, or the hi and lo
// planes of int16 ones; for 8-bit weights word k holds columns 4k ...
// 4k+3, for int4 weights words 2q and 2q+1 the even and odd columns of
// weight word q), and the chunk's dp4a into a row's sums (acc[0] the int8
// / hi plane, acc[1] the lo plane).
template <int WBITS, int XBYTES>
struct GemvChunk {
  static constexpr int kCols = 16 * 8 / WBITS;
  static constexpr int kWords = kCols / 4;
  static constexpr int kPieces = kCols * XBYTES / 16;
  struct XS { uint32_t hi[kWords], lo[XBYTES == 2 ? kWords : 1]; };

  // Activation word i (4 int8 or 2 int16 columns) of the chunk.
  __device__ static uint32_t xw(const int4 (&p)[kPieces], int i) {
    return word(p[i / 4], i % 4);
  }

  // The chunk's activations as XS; for int4 weights also adds their sum
  // to xsum (per plane), for the correction.
  __device__ static XS split(const int4 (&p)[kPieces],
                             uint32_t (&xsum)[XBYTES]) {
    XS xs;
    if constexpr (WBITS == 8) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        if constexpr (XBYTES == 1) {
          xs.hi[k] = xw(p, k);
        } else {                   // columns 4k ... 4k+3: words 2k, 2k+1
          xs.hi[k] = __byte_perm(xw(p, 2 * k), xw(p, 2 * k + 1), 0x7531);
          xs.lo[k] = __byte_perm(xw(p, 2 * k), xw(p, 2 * k + 1), 0x6420);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kWords / 2; ++q) {   // columns 8q ... 8q+7
        if constexpr (XBYTES == 1) {
          const uint32_t a = xw(p, 2 * q), b = xw(p, 2 * q + 1);
          xs.hi[2 * q] = __byte_perm(a, b, 0x6420);
          xs.hi[2 * q + 1] = __byte_perm(a, b, 0x7531);
        } else {                   // column order first, then even / odd
          const uint32_t x0 = xw(p, 4 * q), x1 = xw(p, 4 * q + 1);
          const uint32_t x2 = xw(p, 4 * q + 2), x3 = xw(p, 4 * q + 3);
          const uint32_t ha = __byte_perm(x0, x1, 0x7531);
          const uint32_t hb = __byte_perm(x2, x3, 0x7531);
          const uint32_t la = __byte_perm(x0, x1, 0x6420);
          const uint32_t lb = __byte_perm(x2, x3, 0x6420);
          xs.hi[2 * q] = __byte_perm(ha, hb, 0x6420);
          xs.hi[2 * q + 1] = __byte_perm(ha, hb, 0x7531);
          xs.lo[2 * q] = __byte_perm(la, lb, 0x6420);
          xs.lo[2 * q + 1] = __byte_perm(la, lb, 0x7531);
        }
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        xsum[0] = dp4a<true, false>(xs.hi[k], 0x01010101u, xsum[0]);
        if constexpr (XBYTES == 2)
          xsum[1] = dp4a<false, false>(xs.lo[k], 0x01010101u, xsum[1]);
      }
    }
    return xs;
  }

  __device__ static void mac(const int4& c, const XS& xs,
                             uint32_t (&acc)[XBYTES]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w = word(c, q);
      if constexpr (WBITS == 8) {  // columns 4q ... 4q+3: word q
        acc[0] = dp4a<true, true>(w, xs.hi[q], acc[0]);
        if constexpr (XBYTES == 2)
          acc[1] = dp4a<true, false>(w, xs.lo[q], acc[1]);
      } else {                     // even and odd columns: words 2q, 2q+1
        const uint32_t ue = nibs_biased(w), uo = nibs_biased(w >> 4);
        acc[0] = dp4a<false, true>(ue, xs.hi[2 * q], acc[0]);
        acc[0] = dp4a<false, true>(uo, xs.hi[2 * q + 1], acc[0]);
        if constexpr (XBYTES == 2) {
          acc[1] = dp4a<false, false>(ue, xs.lo[2 * q], acc[1]);
          acc[1] = dp4a<false, false>(uo, xs.lo[2 * q + 1], acc[1]);
        }
      }
    }
  }

  // A lane's share of one row: the planes combined and, for int4
  // weights, the u = s + 8 bias taken off (8 sum x).
  __device__ static uint32_t finish(const uint32_t (&acc)[XBYTES],
                                    const uint32_t (&xsum)[XBYTES]) {
    uint32_t v = acc[0];
    if constexpr (XBYTES == 2) v = (v << 8) + acc[1];
    if constexpr (WBITS == 4) {
      uint32_t sx = xsum[0];
      if constexpr (XBYTES == 2) sx = (sx << 8) + xsum[1];
      v -= sx << 3;
    }
    return v;
  }
};

}  // namespace pim

// Tile machinery of the float32 tensor-core kernels (the flash-attention
// forward and backward, the SSD scan and its backward): every float32
// product as three TF32 products (3×TF32) on mma.sync m16n8k8, from
// float32 tiles staged in shared memory by cp.async.  Beside
// mma_tiles.cuh (the bfloat16 machinery, whose cp.async group helpers it
// uses); every build hashes both (kernels/_build.py).
//
// 3×TF32.  A float32 x splits in registers into two TF32 values,
// x_hi = rna(x) and x_lo = rna(x − x_hi) (rna: round to nearest, ties away,
// on the 13 low mantissa bits; x − x_hi is exact), so x = x_hi + x_lo to
// within 2⁻²² of x.  A product a·b is taken as a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi, the small terms first, into one float32 accumulator; each TF32
// product is exact in float32 and only a_lo·b_lo (≤ 2⁻²² of |a·b|) is
// dropped.  One TF32 product (a_hi·b_hi alone) would carry 2⁻¹¹.
//
// Fragments (m16n8k8, tf32; g = lane / 4, t = lane % 4): A holds (row g,
// k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k t, n g) and
// (k t + 4, n g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).  The kernels permute the reduction index, which leaves
// every sum unchanged:
//   - over the head dim, a lane's k = t and t + 4 stand for dims 2t and
//     2t + 1, so A and B fragments are read as float2 pairs;
//   - over keys (or queries) the accumulator's columns become the next
//     product's reduction index as they are: A's k = t and t + 4 take
//     columns 2t and 2t + 1, no shuffle between lanes, and B reads rows
//     2t and 2t + 1;
//   - the n index of a score product (the row of a K, V, Q or dO tile it
//     reads as B) is permuted by perm8, so that both ways a tile is read
//     are free of bank conflicts at one row pitch (below).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"

namespace fa_tf32 {

using fa_tiles::smem_u32;

constexpr int kTerms = 3;                     // TF32 products a product

// A float32 tile row's pitch in floats: the head-dim bucket D plus 8.  The
// pitch is 8·m floats with m odd for every bucket (64, 80, 128, 256), so
// rows r and r' meet the same banks only when r ≡ r' (mod 4).
template <int D>
constexpr int pitch() {
  static_assert(D % 16 == 0, "the pitch D + 8 must be 8·odd");
  return D + 8;
}

// The row of tile-row group x (0-7) that n index x reads: x ^ (x >> 2),
// i.e. 0 1 2 3 5 4 7 6.  A score product reads rows perm8(g) as float2 at
// column 2t: per half-warp (g 0-3, then 4-7) the rows are distinct mod 4.
// The next product reads rows perm8(2t) and perm8(2t + 1) at column g:
// {0, 2, 5, 7} and {1, 3, 4, 6}, again distinct mod 4.  With the pitch
// above either read covers 32 distinct banks.
__device__ __forceinline__ int perm8(int x) { return x ^ (x >> 2); }

// x rounded to TF32, nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives for a finite x, in two integer operations (ptxas
// expands the cvt into a longer sequence with NaN and infinity checks,
// most of the kernels' instructions: no operand here is infinite or NaN)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// an A fragment (4 floats, in fragment order) split into hi and lo
struct FragA {
  uint32_t hi[4], lo[4];
  FragA() = default;
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// a B fragment (b0, b1) split into hi and lo, or from halves split before
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ FragB(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
  __device__ __forceinline__ FragB(float2 h, float2 l) {
    hi[0] = __float_as_uint(h.x);
    hi[1] = __float_as_uint(h.y);
    lo[0] = __float_as_uint(l.x);
    lo[1] = __float_as_uint(l.y);
  }
};

// Fragments of operands that are exactly TF32 (a bfloat16 value widened
// to float32): no lo half, so a product with one takes two TF32 products
struct ExactA {
  uint32_t v[4];
  __device__ __forceinline__ ExactA(float a0, float a1, float a2, float a3) {
    v[0] = __float_as_uint(a0);
    v[1] = __float_as_uint(a1);
    v[2] = __float_as_uint(a2);
    v[3] = __float_as_uint(a3);
  }
};
struct ExactB {
  uint32_t v[2];
  __device__ __forceinline__ ExactB(float b0, float b1) {
    v[0] = __float_as_uint(b0);
    v[1] = __float_as_uint(b1);
  }
};

// the A and B fragments of a float32 operand (split) or an exact one
template <bool kExact>
using OperandA = std::conditional_t<kExact, ExactA, FragA>;
template <bool kExact>
using OperandB = std::conditional_t<kExact, ExactB, FragB>;

// d (16 × 8, f32) += a (16 × 8, tf32, row) · b (8 × 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in kTerms TF32 products: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d += a·b in TF32 products, the small terms first: three for two float32
// operands (mma_3xtf32), two where one is exact (a_lo·b + a_hi·b, or
// a·b_lo + a·b_hi)
__device__ __forceinline__ void mma(float (&d)[4], const FragA& a,
                                    const FragB& b) {
  mma_3xtf32(d, a, b);
}
__device__ __forceinline__ void mma(float (&d)[4], const FragA& a,
                                    const ExactB& b) {
  mma_tf32(d, a.lo, b.v);
  mma_tf32(d, a.hi, b.v);
}
__device__ __forceinline__ void mma(float (&d)[4], const ExactA& a,
                                    const FragB& b) {
  mma_tf32(d, a.v, b.lo);
  mma_tf32(d, a.v, b.hi);
}

// W bytes to shared `dst` by one cp.async: the first `bytes` (0 ≤ bytes ≤
// W, a multiple of 4) from global `src`, the rest zeros (cp.async's source
// size; with bytes = 0 nothing is read)
template <int W>
__device__ __forceinline__ void copy_zfill(uint32_t dst, const char* src,
                                           int bytes) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  } else {
    static_assert(W == 8 || W == 4, "copy width must be 16, 8 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(W), "r"(bytes)
                 : "memory");
  }
}

// Stage ROWS rows of a float32 (·, d) matrix, source row r at
// src + (row0 + r) · stride floats, into shared rows of PITCH floats at
// `dst`: columns [0, D); columns ≥ d and rows ≥ n_rows are zero-filled by
// the copies themselves.  Each thread takes fixed W-byte chunks of a row
// (kPerRow chunks a row, over kTpr threads) and steps down the rows; every
// chunk is one cp.async, so the choice is the same for every thread.
template <int PITCH, int D, int ROWS, int W, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src,
                                          long long stride, int row0,
                                          int n_rows, int d) {
  constexpr int kPerRow = 4 * D / W;
  constexpr int kTpr = kPerRow < THREADS ? kPerRow : THREADS;
  constexpr int kRowsPerPass = THREADS / kTpr;
  constexpr int kCols = kPerRow / kTpr;       // chunks a thread takes a row
  constexpr int kPasses = (ROWS + kRowsPerPass - 1) / kRowsPerPass;
  const int t = threadIdx.x;
  if (t >= kTpr * kRowsPerPass) return;       // kPerRow ∤ THREADS
  const int r_first = t / kTpr;
  const int c_first = t - r_first * kTpr;
  const long long row_bytes = 4 * stride;
  const char* base = reinterpret_cast<const char*>(src);
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int cb = (c_first + cc * kTpr) * W;  // byte offset in the row
    const int col_bytes = max(min(W, 4 * d - cb), 0);
#pragma unroll 8
    for (int pass = 0; pass < kPasses; ++pass) {
      const int r = r_first + pass * kRowsPerPass;
      if (ROWS % kRowsPerPass == 0 || r < ROWS) {
        const int bytes = row0 + r < n_rows ? col_bytes : 0;
        const char* g = bytes ? base + (row0 + r) * row_bytes + cb : base;
        copy_zfill<W>(dst + r * (4 * PITCH) + cb, g, bytes);
      }
    }
  }
}

__device__ __forceinline__ float2 ld2(const float* ptr) {
  return *reinterpret_cast<const float2*>(ptr);
}

// elements (col, col + 1) of a float32 or bfloat16 tile row as floats
// (col even)
__device__ __forceinline__ float2 pair(const float* row, int col) {
  return ld2(row + col);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* row, int col) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + col);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// The A fragment of k8 step kk over the head dim from the 16 rows at
// `row` (row g; g + 8 at 8 rows below) of a tile of pitch P: dims 2t and
// 2t + 1 of the step stand for k = t and t + 4
template <int P>
__device__ __forceinline__ FragA head_a(const float* row, int kk, int quad) {
  const int c = 8 * kk + 2 * quad;
  const float2 x = ld2(row + c);
  const float2 y = ld2(row + 8 * P + c);
  return FragA(x.x, y.x, x.y, y.y);
}

// The A operand of the next product from the accumulator fragment x of a
// score block's n8 tile: its columns 2t and 2t + 1 stand for k = t and
// t + 4 (the B operand reads the rows of those columns)
__device__ __forceinline__ FragA acc_a(const float (&x)[4]) {
  return FragA(x[0], x[2], x[1], x[3]);
}

// acc (16 × 8·NO) += a (16 × 8·NK: A operands from a score block's NK n8
// tiles, k8 step j from tile j, acc_a) · B, the B fragment of step j and
// n8 tile n from bf(j, n) (FragB or ExactB).  Each n8 tile of the product
// is summed over the NK steps in a fresh fragment and then added to acc
// in float32 (round to nearest): the tensor cores truncate as they
// accumulate, which over a long band biased a running sum past the
// tolerance.
template <int NO, int NK, class BF>
__device__ __forceinline__ void mma_rows(float (&acc)[NO][4],
                                         const FragA (&a)[NK], BF bf) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NK; ++j) mma(part, a[j], bf(j, n));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// mma_rows with B from the float32 tile rows 8·j + pk[0] and 8·j + pk[1]
// of step j, at columns cols + 8·n of n8 tile n (rows of P floats)
template <int NO, int NK, int P>
__device__ __forceinline__ void mma_rows_tf32(float (&acc)[NO][4],
                                              const FragA (&a)[NK],
                                              const float* cols,
                                              const int (&pk)[2]) {
  mma_rows(acc, a, [&](int j, int n) {
    return FragB(cols[(8 * j + pk[0]) * P + 8 * n],
                 cols[(8 * j + pk[1]) * P + 8 * n]);
  });
}

}  // namespace fa_tf32

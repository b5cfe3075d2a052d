// Tile machinery of the bfloat16 tensor-core flash-attention kernels, shared
// by the forward (flash_attention.cu) and the backward
// (flash_attention_bwd.cu): XOR-swizzled shared tiles, their cp.async
// staging at a copy width chosen by the wrapper, ldmatrix, mma.sync
// m16n8k16 bf16 → f32, and the split of float32 weights into bf16 pieces;
// the SSD scan (ssd_scan.cu) takes its cp.async group helpers and mma_bf16.
// Every build hashes the headers of this directory (kernels/_build.py), so
// an edit rebuilds every library that may include it.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa_tiles {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// byte address of 16-byte chunk `chunk` of row `row` in a swizzled tile
template <int ROW>
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  return base + row * (2 * ROW) + ((chunk ^ (row & 7)) << 4);
}

// W bytes from global `src` to shared `dst`: cp.async of that width, or a
// plain load and store for W = 2
template <int W>
__device__ __forceinline__ void copy_full(uint32_t dst, const char* src) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else if constexpr (W == 8 || W == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(W)
                 : "memory");
  } else {
    static_assert(W == 2, "copy width must be 16, 8, 4 or 2 bytes");
    const unsigned short x = *reinterpret_cast<const unsigned short*>(src);
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
  }
}

// W zero bytes at shared `dst`
template <int W>
__device__ __forceinline__ void store_zero(uint32_t dst) {
  if constexpr (W == 16) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst),
                 "r"(0)
                 : "memory");
  } else if constexpr (W == 8) {
    asm volatile("st.shared.v2.u32 [%0], {%1, %1};\n" ::"r"(dst), "r"(0)
                 : "memory");
  } else if constexpr (W == 4) {
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(0) : "memory");
  } else {
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst),
                 "h"(static_cast<unsigned short>(0))
                 : "memory");
  }
}

// `bytes` (0 < bytes < W, even) from global `src`, then zeros, to shared
// `dst`: the head dim's tail inside a W-byte chunk, two bytes at a time
template <int W>
__device__ __forceinline__ void copy_part(uint32_t dst, const char* src,
                                          int bytes) {
#pragma unroll
  for (int i = 0; i < W; i += 2) {
    const unsigned short x =
        i < bytes ? *reinterpret_cast<const unsigned short*>(src + i) : 0;
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst + i), "h"(x)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage ROWS rows of a bf16 (·, d) matrix, source row r at
// src + (row0 + r) · stride elements, into a swizzled tile of ROW-wide
// rows: columns [0, D); columns ≥ d and rows ≥ n_rows are zero-filled.
// Each thread takes fixed W-byte chunks of a row (kPerRow chunks a row,
// over kTpr threads) and steps down the rows.  Whole chunks go by
// cp.async; chunks past d or n_rows are stored as zeros, and a chunk that
// holds the head dim's tail is copied two bytes at a time.
template <int ROW, int D, int ROWS, int W, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int n_rows, int d) {
  constexpr int kPerRow = 2 * D / W;
  constexpr int kTpr = kPerRow < THREADS ? kPerRow : THREADS;
  constexpr int kRowsPerPass = THREADS / kTpr;
  constexpr int kCols = kPerRow / kTpr;       // chunks a thread takes a row
  constexpr int kPasses = (ROWS + kRowsPerPass - 1) / kRowsPerPass;
  // 2-byte copies are synchronous: unrolled, their loads stay live beside
  // the accumulators (spills at D = 256)
  constexpr int kUnroll = W == 2 ? 1 : 8;
  const int t = threadIdx.x;
  if (t >= kTpr * kRowsPerPass) return;       // kPerRow ∤ THREADS
  const int r_first = t / kTpr;
  const int c_first = t - r_first * kTpr;
  const long long row_bytes = 2 * stride;
  const char* base = reinterpret_cast<const char*>(src);
  // every row in range and no column to zero-fill: the whole block takes
  // the plain copy (a choice made per thread, lanes of one warp on both
  // paths, left zero-fill lanes copying on the card)
  const bool full = row0 + ROWS <= n_rows && d == D;
#pragma unroll
  for (int cc = 0; cc < kCols; ++cc) {
    const int cb = (c_first + cc * kTpr) * W;  // byte offset in the row
    const int col_bytes = max(min(W, 2 * d - cb), 0);
    const char* g = base + (row0 + r_first) * row_bytes + cb;
    if (full) {                               // whole chunks, every row
#pragma unroll kUnroll
      for (int pass = 0; pass < kPasses; ++pass) {
        const int r = r_first + pass * kRowsPerPass;
        if (ROWS % kRowsPerPass == 0 || r < ROWS) {
          copy_full<W>(swz<ROW>(dst, r, cb >> 4) + (cb & 15), g);
        }
        g += kRowsPerPass * row_bytes;
      }
    } else {                                  // ragged rows or columns
#pragma unroll kUnroll
      for (int pass = 0; pass < kPasses; ++pass) {
        const int r = r_first + pass * kRowsPerPass;
        if (ROWS % kRowsPerPass == 0 || r < ROWS) {
          const uint32_t sd = swz<ROW>(dst, r, cb >> 4) + (cb & 15);
          const int bytes = row0 + r < n_rows ? col_bytes : 0;
          if (bytes == W) {
            copy_full<W>(sd, g);
          } else if (bytes == 0) {
            store_zero<W>(sd);
          } else {
            copy_part<W>(sd, g, bytes);
          }
        }
        g += kRowsPerPass * row_bytes;
      }
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 × 8, f32) += a (16 × 16, bf16, row) · b (16 × 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) → bf16x2 (x in the low half) as the A operand's register; x and y
// become the rounding residues x − bf16(x), y − bf16(y), exact in float32
__device__ __forceinline__ uint32_t split_pack(float& x, float& y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  x -= __low2float(v);
  y -= __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace fa_tiles

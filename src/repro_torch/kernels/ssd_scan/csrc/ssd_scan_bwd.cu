// Mamba2 chunked SSD scan backward for Hopper (sm_90a): the cotangents of
// x, dt, A, B and C from those of y and of the final state.
//
// Replaces no Pallas kernel: the reference has no backward kernel for the
// SSD and differentiates the plain ssd_chunked
// (src/repro/models/mamba2.py:74) with autodiff.  This is the explicit
// chunked VJP of that function, in the forward's layout (ssd_scan.cu), in
// four kernels.  Per (batch, head) and chunk c of L positions, with xdt =
// x·dt, cum = cumsum(dt·A) over the chunk, E[z, s] = exp(cum_z − cum_s) for
// s ≤ z and 0 above the diagonal (selected before the exp, as in the
// forward), w_s = exp(cum_last − cum_s), S_{c−1} the state entering the
// chunk (the forward writes it) and G_c the cotangent of the state leaving
// it:
//   1. dstate (a block per (chunk ≥ 1, b, h)): ΔG_c = Σ_z exp(cum_z) dy_z ⊗
//      C_z, y's carried-state term, and decay_c = exp(cum_last);
//   2. chain (a thread per state entry of each (b, h)): the reverse of the
//      forward's chain, G_{C−1} = dS_last, G_{c−1} = decay_c·G_c + ΔG_c,
//      G_c written over ΔG_c;
//   3. chunk (a block per (chunk, b, h)): W = (C·Bᵀ) ∘ E, then
//      d(xdt) = Wᵀ·dy + w ∘ (B·G_cᵀ), giving dx = d(xdt)·dt; V = (dy·xdtᵀ) ∘ E,
//      then this head's dB = Vᵀ·C + w ∘ (xdt·G_c) and dC = V·B +
//      exp(cum) ∘ (dy·S_{c−1}); dcum_z = C_z·dC_z − xdt_z·d(xdt)_z, plus
//      ⟨G_c, S_c⟩ at the chunk's last position (S_c the next chunk's
//      entering state, or the final state); ddA its reverse cumsum; ddt =
//      Σ_p d(xdt)·x + ddA·A, and the chunk's share of dA, Σ ddA·dt;
//   4. reduce (a thread per output entry): dB and dC summed over the heads
//      of each group, dA over the chunks (and the batch rows when A is one
//      (H,) for all of them).
// All arithmetic is float32, for float32 and bfloat16 inputs alike; dx, dB
// and dC are rounded to their inputs' dtype once, at the end.  Every sum
// runs in a fixed order (no atomics, fixed shuffle trees): reruns are
// bit-equal.
//
// Design of the chunk and dstate kernels: the products on the tensor
// cores, mma.sync m16n8k8 TF32 with tf32_tiles.cuh's fragments — each
// float32 operand split into two TF32 values, rounded to nearest as in
// every TF32 kernel of the port, a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
// (one TF32 product misses SSD_BWD_TOL) — and C·Bᵀ for bfloat16 inputs
// as m16n8k16 bf16 (exact in float32).  An operand that is exactly TF32
// (a bfloat16 x, B or C: ExactA / ExactB) has no lo half, so its products
// take two terms; the scalars (dt, the exp weights) move to the other
// operand, as in the forward, to keep x, B and C exact: V is formed as
// (dy·xᵀ) ∘ (dt_s E) and ΔG as (exp(cum) ∘ dy)ᵀ·C.  dy, G_c and S_{c−1}
// are float32 in both dtypes.
//
// The chunk's math is attention's backward with Q = C, K = B, V = xdt and
// P = W (d(xdt) is dV's shape, dB dK's, dC dQ's), all of it in one block
// of 8 warps, since L ≤ 128.  The block stages x, B and C (their dtype),
// dy and G_c (float32; S_{c−1} later takes G_c's place) once, by cp.async
// in rows of D + 8 elements (16-byte vectors where every row start allows,
// else element by element), D the bucket of max(P, N), L padded to a
// multiple of 16 with zero rows.  Its work is in tasks on row tiles of 16
// positions; each task holds its 16 × D accumulator in registers and walks
// the causal tiles only (16 × 16 blocks on or below the diagonal; the
// mask, s ≤ z, only matters inside the diagonal block):
//   - dxdt(i): s in tile i; for each z tile j ≥ i, Wᵀ = B_i·C_jᵀ ∘ E
//     (16 × 16), then d(xdt) += Wᵀ·dy_j from the accumulator in place
//     (acc_a: C's rows permuted by perm8, so dy is read at rows
//     perm8(2t), perm8(2t + 1)); then w ∘ (B_i·G_cᵀ); writes dx and the
//     row dots Σ_p d(xdt)·x;
//   - dB(i): the same walk with Vᵀ = x_i·dy_jᵀ ∘ (dt_s E) and dB += Vᵀ·C_j;
//     then (dt·w) ∘ (x_i·G_c); writes this head's dB;
//   - dC(i): z in tile i; for each s tile j ≤ i, V = dy_i·x_jᵀ ∘ (dt_s E)
//     and dC += V·B_j; then, once every warp is done with G_c and S_{c−1}
//     has replaced it, exp(cum) ∘ (dy_i·S_{c−1}); writes this head's dC and
//     the row dots C·dC.
// V is formed twice, as Vᵀ by dB's task and as V by dC's (a sixth of the
// triangle's products): staging W and V once in shared memory (64 KB at
// L = 128) would leave no room for the tiles, or for two blocks an SM at
// bfloat16's D = 64.  Warp w takes dxdt(w), dB(7 − w) and dC(w) (w < 4) or
// dC(11 − w) (w ≥ 4): each warp walks 9 tile pairs in its first two tasks,
// and the two warps of an SM sub-partition (w, w + 4) 9 in their third
// (at L = 128).  Each pair's products are summed in fresh fragments and
// added to the accumulator in float32 (the tensor cores truncate as they
// add).  At D = 128 the tiles leave no room for dy, G_c and S_{c−1}: that
// instance reads them in place (float32, masked past the chunk).  The
// cumsum, the reverse cumsum of dcum and the sums of ⟨G_c, S_c⟩ and dA
// run as warp scans and shuffle trees of a fixed order.  Two other layouts
// were tried on an H100 and ran slower (their variants are not kept):
// one walk per row tile for both d(xdt) and dB (one E for Wᵀ and Vᵀ; its
// two accumulators spill at bfloat16's 128 registers), and 12 warps a
// block (dxdt and dC, or two dB tasks, 9 tile pairs a warp).
// The dstate kernel stages dy and C the same way and takes ΔG_c in m16 × n8
// tiles over the warps, each 16 positions' products in a fresh fragment
// (the forward's ΔS); with one chunk, its one launch writes the decays
// only.
//
// Bound on an H100 SXM at the training path's shape (b 4 — two clients of
// two rows, folded — l 256, h 80, p 64, n 64, L 128, float32): the bytes,
// x, dy and dx (21 MB each) and the rest, ~86 MB, 0.026 ms at 3.35 TB/s,
// against the operations — per (b, h, chunk) the causal triangles' C·Bᵀ,
// dy·xdtᵀ, Wᵀ·dy, Vᵀ·C and V·B, L(L+1)/2·(3N + 2P) multiply-adds, and ΔG,
// B·G_cᵀ, xdt·G_c and dy·S_{c−1}, 4LNP — 5.4 GFLOP, 0.033 ms at a third of
// the TF32 peak: bound by operations.  With bfloat16 inputs the same
// operations weigh by their operands' types (chip_smoke.py
// `_ssd_bwd_parts`): C·Bᵀ at the bf16 peak, the products with an exact x,
// B or C at half the TF32 peak, the rest at a third, 0.022 ms.  The
// 16 × 16 tiles (the diagonal blocks' upper halves) and V's second
// forming add about a quarter to the products issued; what keeps the
// kernel above its bound is the rate at which mma.sync issues TF32
// products, a fifth of the TF32 peak here.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"
#include "tf32_tiles.cuh"

namespace {

namespace tf32 = fa_tf32;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxL = 128;        // chunk length
constexpr int kMaxDim = 128;      // head_dim P and d_state N
constexpr int kRowTile = 16;      // positions of a row tile
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* dy;           // (batch, l, H, P) contiguous
  const float* dS_last;      // (batch, H, P, N) contiguous
  const float* states;       // (batch, chunks, H, P, N): entering each chunk
  const float* final_state;  // (batch, H, P, N): leaving the last
  float* gs;                 // (batch, chunks, H, P, N): ΔG_c, then G_c
  float* decay;              // (batch, chunks, H)
  void* dx;                  // (batch, l, H, P) contiguous, x's dtype
  float* ddt;                // (batch, l, H) contiguous
  float* dBh;                // (batch, l, H, N): dB of each head
  float* dCh;                // (batch, l, H, N): dC of each head
  float* dA_chunks;          // (batch, chunks, H)
  void* dB;                  // (batch, l, G, N) contiguous, B's dtype
  void* dC;                  // (batch, l, G, N) contiguous, C's dtype
  float* dA;                 // (a_rows, H)
  int batch, l, H, P, G, N, L, a_rows;
  long long x_sb, x_sl, x_sh;
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl, b_sg;
  long long c_sb, c_sl, c_sg;
  long long a_sb;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ inline int chunks_of(const Params& p) {
  return (p.l + p.L - 1) / p.L;
}

// ---- tiles: rows of a chunk (row 0 its first position, or a state's row
// p), read as floats
// staged in shared memory, rows of PT elements, zero past the matrix
template <typename E, int PT>
struct Staged {
  static constexpr bool kExact = std::is_same_v<E, bf16>;
  const E* p;
  __device__ __forceinline__ float at(int r, int c) const {
    return to_float(p[r * PT + c]);
  }
  // elements (c, c + 1), c even
  __device__ __forceinline__ float2 pair(int r, int c) const {
    return tf32::pair(p + r * PT, c);
  }
  // the bf16 pair (c, c + 1) as one register (c in the low half)
  __device__ __forceinline__ uint32_t word(int r, int c) const {
    return *reinterpret_cast<const uint32_t*>(p + r * PT + c);
  }
};
// float32 rows read in place from device memory, row stride rs, zero past
// rows × cols (the D = 128 instances' dy, G_c and S_{c−1})
struct InPlace {
  static constexpr bool kExact = false;
  const float* p;
  long long rs;
  int rows, cols;
  __device__ __forceinline__ float at(int r, int c) const {
    return r < rows && c < cols ? __ldg(p + r * rs + c) : 0.0f;
  }
  __device__ __forceinline__ float2 pair(int r, int c) const {
    return make_float2(at(r, c), at(r, c + 1));
  }
};

// Fragments of k8 step kk over a tile's columns: a lane's k = t and t + 4
// stand for columns 8·kk + 2t and 2t + 1 (tf32_tiles.cuh).  A: rows r and
// r + 8; B read along a row: column index n = row r
template <class Tile>
__device__ __forceinline__ tf32::OperandA<Tile::kExact> a_rows(const Tile& tl, int r,
                                                      int kk, int t) {
  const int c = 8 * kk + 2 * t;
  const float2 x = tl.pair(r, c);
  const float2 y = tl.pair(r + 8, c);
  return tf32::OperandA<Tile::kExact>(x.x, y.x, x.y, y.y);
}
template <class Tile>
__device__ __forceinline__ tf32::OperandB<Tile::kExact> b_row(const Tile& tl, int r,
                                                     int kk, int t) {
  const float2 x = tl.pair(r, 8 * kk + 2 * t);
  return tf32::OperandB<Tile::kExact>(x.x, x.y);
}
// B read down a column: k = t and t + 4 stand for rows 8·kk + 2t and
// 2t + 1 (so that it pairs with a_rows), column n = col
template <class Tile>
__device__ __forceinline__ tf32::OperandB<Tile::kExact> b_col(const Tile& tl, int kk,
                                                     int col, int t) {
  const int r = 8 * kk + 2 * t;
  return tf32::OperandB<Tile::kExact>(tl.at(r, col), tl.at(r + 1, col));
}

// sc (16 × 16) = ta[r0 .. r0 + 15] · tb[r1 .. r1 + 15]ᵀ over D columns:
// n8 tile j's column index g stands for tb's row r1 + 8·j + perm8(g) (pg),
// so that the accumulator feeds the next product in place (mma_rows).  Two
// bfloat16 tiles take m16n8k16 bf16 products.
template <int D, class TA, class TB>
__device__ __forceinline__ void score(float (&sc)[2][4], const TA& ta, int r0,
                                      const TB& tb, int r1, int g, int t,
                                      int pg) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
  }
  if constexpr (TA::kExact && TB::kExact) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 16 * kk + 2 * t;
      const uint32_t af[4] = {ta.word(r0 + g, c), ta.word(r0 + g + 8, c),
                              ta.word(r0 + g, c + 8),
                              ta.word(r0 + g + 8, c + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r1 + 8 * j + pg;
        fa_tiles::mma_bf16(sc[j], af, tb.word(r, c), tb.word(r, c + 8));
      }
    }
  } else {
    // even and odd k8 steps in two fragments each: four chains of
    // dependent products rather than two
    float odd[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; kk += 2) {
      const auto a0 = a_rows(ta, r0 + g, kk, t);
      const auto a1 = a_rows(ta, r0 + g, kk + 1, t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tf32::mma(sc[j], a0, b_row(tb, r1 + 8 * j + pg, kk, t));
        tf32::mma(odd[j], a1, b_row(tb, r1 + 8 * j + pg, kk + 1, t));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] += odd[j][e];
    }
  }
}

// acc (16 × 8·NO) += a · tb's rows (tf32::mma_rows): k8 step j from a
// score's n8 tile j (tf32::acc_a; its columns 2t, 2t + 1 stand for tb's
// rows r1 + 8·j + pk[0], pk[1]), column 8·n + g of n8 tile n
template <int NO, class TB>
__device__ __forceinline__ void mma_rows(float (&acc)[NO][4],
                                         const tf32::FragA (&a)[2],
                                         const TB& tb, int r1, int g,
                                         const int (&pk)[2]) {
  tf32::mma_rows(acc, a, [&](int j, int n) {
    const int c = 8 * n + g;
    return tf32::OperandB<TB::kExact>(tb.at(r1 + 8 * j + pk[0], c),
                                      tb.at(r1 + 8 * j + pk[1], c));
  });
}

// acc (16 × 8·NO) += diag(w0 for rows g, w8 for g + 8) · (ta[r0 ..] · M)
// over ta's D columns, M's B fragment of step kk and n8 tile n from
// bf(kk, n); each half of the n8 tiles summed in fresh fragments
template <int D, int NO, class TA, class BF>
__device__ __forceinline__ void add_product(float (&acc)[NO][4], const TA& ta,
                                            int r0, float w0, float w8,
                                            BF bf, int g, int t) {
  constexpr int NH = NO / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float part[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
    }
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const auto a = a_rows(ta, r0 + g, kk, t);
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        tf32::mma(part[n], a, bf(kk, NH * half + n));
      }
    }
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      float* const o = acc[NH * half + n];
      o[0] += w0 * part[n][0];
      o[1] += w0 * part[n][1];
      o[2] += w8 * part[n][2];
      o[3] += w8 * part[n][3];
    }
  }
}

// out[r] = Σ_col acc(r, col)·tl(r, col) for the rows r0 + g and r0 + g + 8:
// each lane's columns, then the quad's four lanes by a fixed tree
template <int NO, class Tile>
__device__ __forceinline__ void row_dots(const float (&acc)[NO][4],
                                         const Tile& tl, int r0, int g, int t,
                                         float* out) {
  float s0 = 0.0f;
  float s8 = 0.0f;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * t;
    const float2 x = tl.pair(r0 + g, c);
    const float2 y = tl.pair(r0 + g + 8, c);
    s0 = fmaf(acc[n][0], x.x, s0);
    s0 = fmaf(acc[n][1], x.y, s0);
    s8 = fmaf(acc[n][2], y.x, s8);
    s8 = fmaf(acc[n][3], y.y, s8);
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    s0 += __shfl_xor_sync(kFull, s0, m);
    s8 += __shfl_xor_sync(kFull, s8, m);
  }
  if (t == 0) {
    out[r0 + g] = s0;
    out[r0 + g + 8] = s8;
  }
}

// acc's rows r0 + g, r0 + g + 8 below `rows` and columns 8·n + 2t, + 1
// below `cols`, each row scaled by scale(r), to out + r·rs + col in E
template <typename E, int NO, class F>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4], E* out,
                                           long long rs, int r0, int rows,
                                           int cols, int g, int t, F scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= rows) continue;
    const float w = scale(r);
    E* const row = out + r * rs;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * t;
      const float v0 = acc[n][2 * i] * w;
      const float v1 = acc[n][2 * i + 1] * w;
      if (cols % 2 == 0 && col + 1 < cols) {
        if constexpr (std::is_same_v<E, bf16>) {
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
        }
      } else {
        if (col < cols) row[col] = from_float<E>(v0);
        if (col + 1 < cols) row[col + 1] = from_float<E>(v1);
      }
    }
  }
}

// `rows` rows of D columns into shared rows of PT elements: row r < n_rows
// from src + r·rs, columns < cols; the rest zeros.  16-byte cp.async
// vectors where the block's row starts allow them (commit and wait by the
// caller), else element by element.
template <typename E, int D, int PT>
__device__ __forceinline__ void stage(E* dst, const E* src, long long rs,
                                      int rows, int n_rows, int cols) {
  constexpr int VEC = 16 / sizeof(E);
  constexpr int VPR = D / VEC;
  const bool vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   (n_rows <= 1 || (rs * sizeof(E)) % 16 == 0) &&
                   cols % VEC == 0;
  if (vec) {
    const char* const base = reinterpret_cast<const char*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
      const int r = i / VPR;
      const int c = VEC * (i - r * VPR);
      const int bytes = r < n_rows && c < cols ? 16 : 0;
      const char* g = bytes ? reinterpret_cast<const char*>(src + r * rs + c)
                            : base;
      tf32::copy_zfill<16>(fa_tiles::smem_u32(dst + r * PT + c), g, bytes);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      dst[r * PT + c] =
          r < n_rows && c < cols ? src[r * rs + c] : from_float<E>(0.0f);
    }
  }
}

// The chunk's dt (0 past Lc) and, by warp 0, its inclusive cumsum of dt·a
// in position order, 4 positions a lane (positions past Lc keep cum_last);
// the caller's barriers order them
__device__ __forceinline__ void load_dt(const Params& p, int b, int h,
                                        int pos0, int Lc, float* dts) {
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  for (int s = threadIdx.x; s < kMaxL; s += kThreads) {
    dts[s] = s < Lc ? dtg[(pos0 + s) * p.dt_sl] : 0.0f;
  }
}
__device__ __forceinline__ void scan_cum(const float* dts, float a,
                                         float* cum) {
  const int lane = threadIdx.x % 32;
  float v[4];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += dts[4 * lane + k] * a;
    v[k] = run;
  }
  float off = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, off, d);
    if (lane >= d) off += o;
  }
  float before = __shfl_up_sync(kFull, off, 1);
  if (lane == 0) before = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) cum[4 * lane + k] = before + v[k];
}

// blocks an SM the registers must leave room for: two below D = 128
// where two blocks' shared memory fits (an accumulator of 16 × 128 floats
// takes 64 registers a thread)
template <int D, int Bytes>
constexpr int min_blocks() {
  return D <= 64 && 2 * (Bytes + 1024) <= 228 * 1024 ? 2 : 1;
}

// ---- kernel 1: ΔG_c and decay_c

// Shared memory of the dstate kernel at kMaxL positions, in bytes: dy
// (float32) and C tiles, then dt, cum and exp(cum)
template <typename T, int D>
struct DstateSmem {
  static constexpr int kPitch = tf32::pitch<D>();
  static __host__ __device__ size_t c_offset(int Lp) {
    return static_cast<size_t>(Lp) * kPitch * sizeof(float);
  }
  static __host__ __device__ size_t vec_offset(int Lp) {
    return c_offset(Lp) + static_cast<size_t>(Lp) * kPitch * sizeof(T);
  }
  static __host__ __device__ size_t bytes(int Lp) {
    return vec_offset(Lp) + 3 * kMaxL * sizeof(float);
  }
  static constexpr int kMaxBytes = static_cast<int>(
      kMaxL * kPitch * (sizeof(float) + sizeof(T)) + 3 * kMaxL * 4);
};

// A block per (chunk ≥ 1, b, h), chunk-major (chunk 0 feeds no earlier
// chunk); with one chunk, a block per (b, h) writes its decay only.  ΔG's
// m16 (p) × n8 (n) tiles over the warps: kMW warps along p, each taking
// one m16 tile and NPW n8 tiles; A = (exp(cum) ∘ dy)ᵀ, B = C, each 16
// positions' products in a fresh fragment.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks<D, DstateSmem<T, D>::kMaxBytes>())
    ssd_bwd_dstate_kernel(const Params p) {
  using Sm = DstateSmem<T, D>;
  constexpr int PT = Sm::kPitch;
  constexpr int kMW = D / 16 < kWarps ? D / 16 : kWarps;
  constexpr int NPW = (D / 8) / (kWarps / kMW);
  extern __shared__ __align__(16) unsigned char dstate_smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int nch = chunks_of(p);
  const int BH = p.batch * p.H;
  const int ci = (nch > 1 ? 1 : 0) + static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int gi = h / (p.H / p.G);
  const int pos0 = ci * p.L;
  const int Lc = min(p.L, p.l - pos0);
  const int Lp = (p.L + kRowTile - 1) / kRowTile * kRowTile;
  const int rows = (Lc + kRowTile - 1) / kRowTile * kRowTile;
  float* const dys = reinterpret_cast<float*>(dstate_smem);
  T* const cs = reinterpret_cast<T*>(dstate_smem + Sm::c_offset(Lp));
  float* const dts = reinterpret_cast<float*>(dstate_smem + Sm::vec_offset(Lp));
  float* const cum = dts + kMaxL;
  float* const ez = cum + kMaxL;
  const long long slot = (static_cast<long long>(b) * nch + ci) * p.H + h;

  if (ci > 0) {
    const long long row = static_cast<long long>(p.H) * p.P;
    stage<float, D, PT>(dys,
                        p.dy + (static_cast<long long>(b) * p.l + pos0) * row +
                            static_cast<long long>(h) * p.P,
                        row, rows, Lc, p.P);
    stage<T, D, PT>(cs,
                    static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg +
                        pos0 * p.c_sl,
                    p.c_sl, rows, Lc, p.N);
    fa_tiles::cp_async_commit();
  }
  load_dt(p, b, h, pos0, Lc, dts);
  __syncthreads();                // dts
  if (warp == 0) scan_cum(dts, p.A[b * p.a_sb + h], cum);
  __syncthreads();                // cum
  if (ci == 0) {
    if (tid == 0) p.decay[slot] = expf(cum[Lc - 1]);
    return;
  }
  for (int s = tid; s < kMaxL; s += kThreads) {
    ez[s] = s < Lc ? expf(cum[s]) : 0.0f;
  }
  fa_tiles::cp_async_wait<0>();
  __syncthreads();                // ez, the tiles

  const int pc = 16 * (warp % kMW) + g;       // A's rows pc, pc + 8
  const int nw0 = NPW * (warp / kMW);
  float ds[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[j][e] = 0.0f;
  }
  const Staged<T, PT> ct{cs};
  for (int s0 = 0; s0 < rows; s0 += 16) {
    tf32::FragA ax[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int s = s0 + 8 * kk + t;
      const float* r0 = dys + s * PT + pc;
      const float* r4 = r0 + 4 * PT;
      ax[kk] = tf32::FragA(ez[s] * r0[0], ez[s] * r0[8], ez[s + 4] * r4[0],
                           ez[s + 4] * r4[8]);
    }
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int nc = 8 * (nw0 + j) + g;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int s = s0 + 8 * kk + t;
        tf32::mma(part, ax[kk],
                  tf32::OperandB<Staged<T, PT>::kExact>(ct.at(s, nc), ct.at(s + 4, nc)));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] += part[e];
    }
  }
  float* const out = p.gs + slot * p.P * p.N;
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = pc + 8 * (e / 2);
      const int col = 8 * (nw0 + j) + 2 * t + e % 2;
      if (r < p.P && col < p.N) out[r * p.N + col] = ds[j][e];
    }
  }
  if (tid == 0) p.decay[slot] = expf(cum[Lc - 1]);
}

// Kernel 2: the reverse chain, a thread per (b, h, state entry)
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chain_kernel(const Params p) {
  const long long PN = static_cast<long long>(p.P) * p.N;
  const long long per = (PN + kThreads - 1) / kThreads;
  const long long bh = blockIdx.x / per;
  const long long e = (blockIdx.x - bh * per) * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int b = static_cast<int>(bh / p.H);
  const int h = static_cast<int>(bh - static_cast<long long>(b) * p.H);
  const int nch = chunks_of(p);
  float g = p.dS_last[bh * PN + e];
  for (int c = nch - 1; c >= 0; --c) {
    const long long slot = (static_cast<long long>(b) * nch + c) * p.H + h;
    float* const at = p.gs + slot * PN + e;
    const float delta = c > 0 ? *at : 0.0f;
    *at = g;
    if (c > 0) g = p.decay[slot] * g + delta;
  }
}

// ---- kernel 3: a block per (chunk, b, h): dx, ddt, this head's dB and dC,
// and the chunk's share of dA

// Shared memory of the chunk kernel at Lp positions, in bytes: x, B and C
// tiles (T); below D = 128 dy (float32, Lp rows) and G_c, then S_{c−1}
// (float32, D rows); then dt, cum, exp(cum), exp(cum_last − cum), Σ_p
// d(xdt)·x, C·dC (kMaxL floats each) and the warps' shares of ⟨G_c, S_c⟩
template <typename T, int D>
struct ChunkSmem {
  static constexpr int kPitch = tf32::pitch<D>();
  static constexpr bool kInPlace = D > 64;    // dy, G_c, S_{c−1} in place
  static __host__ __device__ size_t tile(int Lp) {
    return static_cast<size_t>(Lp) * kPitch * sizeof(T);
  }
  static __host__ __device__ size_t dy_offset(int Lp) { return 3 * tile(Lp); }
  static __host__ __device__ size_t gs_offset(int Lp) {
    return dy_offset(Lp) +
           (kInPlace ? 0 : static_cast<size_t>(Lp) * kPitch * sizeof(float));
  }
  static __host__ __device__ size_t vec_offset(int Lp) {
    return gs_offset(Lp) +
           (kInPlace ? 0 : static_cast<size_t>(D) * kPitch * sizeof(float));
  }
  static __host__ __device__ size_t bytes(int Lp) {
    return vec_offset(Lp) + (6 * kMaxL + kWarps) * sizeof(float);
  }
  static constexpr int kMaxBytes = static_cast<int>(
      3 * kMaxL * kPitch * sizeof(T) +
      (kInPlace ? 0 : (kMaxL + D) * kPitch * 4) + (6 * kMaxL + kWarps) * 4);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks<D, ChunkSmem<T, D>::kMaxBytes>())
    ssd_bwd_chunk_kernel(const Params p) {
  using Sm = ChunkSmem<T, D>;
  constexpr int PT = Sm::kPitch;
  constexpr int NO = D / 8;       // n8 tiles of an accumulator's columns
  constexpr bool kInPlace = Sm::kInPlace;
  using FTile = std::conditional_t<kInPlace, InPlace, Staged<float, PT>>;
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pg = tf32::perm8(g);
  const int pk[2] = {tf32::perm8(2 * t), tf32::perm8(2 * t + 1)};
  const int nch = chunks_of(p);
  const int BH = p.batch * p.H;
  const int ci = static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) - ci * BH;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int gi = h / (p.H / p.G);
  const int pos0 = ci * p.L;
  const int Lc = min(p.L, p.l - pos0);
  const int P = p.P;
  const int N = p.N;
  const int Lp = (p.L + kRowTile - 1) / kRowTile * kRowTile;
  const int nt = (Lc + kRowTile - 1) / kRowTile;   // row tiles
  const int rows = nt * kRowTile;
  const float a = p.A[b * p.a_sb + h];

  T* const xs = reinterpret_cast<T*>(chunk_smem);
  T* const bs = xs + Lp * PT;
  T* const cs = bs + Lp * PT;
  float* const dys = reinterpret_cast<float*>(chunk_smem + Sm::dy_offset(Lp));
  float* const gsm = reinterpret_cast<float*>(chunk_smem + Sm::gs_offset(Lp));
  float* const dts = reinterpret_cast<float*>(chunk_smem + Sm::vec_offset(Lp));
  float* const cum = dts + kMaxL;
  float* const ez = cum + kMaxL;
  float* const wend = ez + kMaxL;
  float* const rx = wend + kMaxL;
  float* const rc = rx + kMaxL;
  float* const red = rc + kMaxL;

  const long long row = static_cast<long long>(p.H) * P;
  const long long at = (static_cast<long long>(b) * p.l + pos0) * row +
                       static_cast<long long>(h) * P;
  const float* const dyg = p.dy + at;
  const long long slot = (static_cast<long long>(b) * nch + ci) * p.H + h;
  const long long PN = static_cast<long long>(P) * N;
  const float* const Gc = p.gs + slot * PN;
  const float* const Sp = p.states + slot * PN;
  const float* const Sn =
      ci + 1 < nch ? p.states + (slot + p.H) * PN
                   : p.final_state + static_cast<long long>(bh) * PN;

  // ---- the chunk's tiles, zero past Lc rows and P / N columns
  stage<T, D, PT>(xs,
                  static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                      pos0 * p.x_sl,
                  p.x_sl, rows, Lc, P);
  stage<T, D, PT>(bs,
                  static_cast<const T*>(p.B) + b * p.b_sb + gi * p.b_sg +
                      pos0 * p.b_sl,
                  p.b_sl, rows, Lc, N);
  stage<T, D, PT>(cs,
                  static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg +
                      pos0 * p.c_sl,
                  p.c_sl, rows, Lc, N);
  if constexpr (!kInPlace) {
    stage<float, D, PT>(dys, dyg, row, rows, Lc, P);
    stage<float, D, PT>(gsm, Gc, N, D, P, N);
  }
  fa_tiles::cp_async_commit();
  load_dt(p, b, h, pos0, Lc, dts);
  for (int s = tid; s < kMaxL; s += kThreads) {
    rx[s] = 0.0f;
    rc[s] = 0.0f;
  }
  // ⟨G_c, S_c⟩: each thread's entries, then a fixed tree
  {
    float gsum = 0.0f;
    for (long long e = tid; e < PN; e += kThreads) {
      gsum = fmaf(Gc[e], Sn[e], gsum);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) gsum += __shfl_xor_sync(kFull, gsum, m);
    if (lane == 0) red[warp] = gsum;
  }
  __syncthreads();                // dts
  if (warp == 0) scan_cum(dts, a, cum);
  __syncthreads();                // cum
  const float cum_last = cum[Lc - 1];
  for (int s = tid; s < kMaxL; s += kThreads) {
    ez[s] = s < Lc ? expf(cum[s]) : 0.0f;
    wend[s] = s < Lc ? expf(cum_last - cum[s]) : 0.0f;
  }
  fa_tiles::cp_async_wait<0>();
  __syncthreads();                // ez, wend, the tiles

  const Staged<T, PT> xt{xs};
  const Staged<T, PT> bt{bs};
  const Staged<T, PT> ct{cs};
  FTile dyt, gt, st;
  if constexpr (kInPlace) {
    dyt = InPlace{dyg, row, Lc, P};
    gt = InPlace{Gc, N, P, N};
    st = InPlace{Sp, N, P, N};
  } else {
    dyt = FTile{dys};
    gt = FTile{gsm};
    st = FTile{gsm};              // once S_{c−1} has replaced G_c
  }
  // a score tile's entry (j, e) is row r0 + g + 8·(e / 2) against column
  // r1 + 8·j + pk[e % 2]
  auto row_of = [&](int r0, int e) { return r0 + g + 8 * (e / 2); };
  auto col_of = [&](int r1, int j, int e) { return r1 + 8 * j + pk[e % 2]; };

  // ---- d(xdt) of row tile i = warp: Wᵀ = B_i·C_jᵀ ∘ E for z tiles j ≥ i,
  // then w ∘ (B_i·G_cᵀ); dx = d(xdt)·dt, rx = Σ_p d(xdt)·x
  if (warp < nt) {
    const int s0 = kRowTile * warp;
    float acc[NO][4] = {};
    for (int j = warp; j < nt; ++j) {
      const int z0 = kRowTile * j;
      float sc[2][4];
      score<D>(sc, bt, s0, ct, z0, g, t, pg);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = row_of(s0, e);
          const int z = col_of(z0, jj, e);
          sc[jj][e] = s <= z ? sc[jj][e] * expf(cum[z] - cum[s]) : 0.0f;
        }
      }
      const tf32::FragA aw[2] = {tf32::acc_a(sc[0]), tf32::acc_a(sc[1])};
      mma_rows(acc, aw, dyt, z0, g, pk);
    }
    add_product<D>(acc, bt, s0, wend[s0 + g], wend[s0 + g + 8],
                   [&](int kk, int n) { return b_row(gt, 8 * n + g, kk, t); },
                   g, t);
    store_rows(acc, static_cast<T*>(p.dx) + at, row, s0, Lc, P, g, t,
               [&](int s) { return dts[s]; });
    row_dots(acc, xt, s0, g, t, rx);
  }
  const long long hn = (static_cast<long long>(b) * p.l + pos0) * p.H * N +
                       static_cast<long long>(h) * N;
  const long long hrow = static_cast<long long>(p.H) * N;
  auto one = [](int) { return 1.0f; };
  // ---- this head's dB of row tile i = 7 − warp: Vᵀ = x_i·dy_jᵀ ∘ (dt_s E)
  // for z tiles j ≥ i, then (dt·w) ∘ (x_i·G_c)
  const int i2 = kWarps - 1 - warp;
  if (i2 < nt) {
    const int s0 = kRowTile * i2;
    float acc[NO][4] = {};
    for (int j = i2; j < nt; ++j) {
      const int z0 = kRowTile * j;
      float sc[2][4];
      score<D>(sc, xt, s0, dyt, z0, g, t, pg);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = row_of(s0, e);
          const int z = col_of(z0, jj, e);
          sc[jj][e] =
              s <= z ? sc[jj][e] * (dts[s] * expf(cum[z] - cum[s])) : 0.0f;
        }
      }
      const tf32::FragA aw[2] = {tf32::acc_a(sc[0]), tf32::acc_a(sc[1])};
      mma_rows(acc, aw, ct, z0, g, pk);
    }
    add_product<D>(acc, xt, s0, dts[s0 + g] * wend[s0 + g],
                   dts[s0 + g + 8] * wend[s0 + g + 8],
                   [&](int kk, int n) { return b_col(gt, kk, 8 * n + g, t); },
                   g, t);
    store_rows(acc, p.dBh + hn, hrow, s0, Lc, N, g, t, one);
  }
  // ---- this head's dC of row tile i (warps 0-3 tiles 0-3, warps 4-7
  // tiles 7-4): V = dy_i·x_jᵀ ∘ (dt_s E) for s tiles j ≤ i, then, with
  // S_{c−1} in G_c's place, exp(cum) ∘ (dy_i·S_{c−1})
  const int i3 = warp < 4 ? warp : 11 - warp;
  float acc3[NO][4] = {};
  if (i3 < nt) {
    const int z0 = kRowTile * i3;
    for (int j = 0; j <= i3; ++j) {
      const int s0 = kRowTile * j;
      float sc[2][4];
      score<D>(sc, dyt, z0, xt, s0, g, t, pg);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int z = row_of(z0, e);
          const int s = col_of(s0, jj, e);
          sc[jj][e] =
              s <= z ? sc[jj][e] * (dts[s] * expf(cum[z] - cum[s])) : 0.0f;
        }
      }
      const tf32::FragA aw[2] = {tf32::acc_a(sc[0]), tf32::acc_a(sc[1])};
      mma_rows(acc3, aw, bt, s0, g, pk);
    }
  }
  if constexpr (!kInPlace) {
    if (ci > 0) {
      __syncthreads();            // every warp is done with G_c
      stage<float, D, PT>(gsm, Sp, N, D, P, N);
      fa_tiles::cp_async_commit();
      fa_tiles::cp_async_wait<0>();
      __syncthreads();            // S_{c−1}
    }
  }
  if (i3 < nt) {
    const int z0 = kRowTile * i3;
    if (ci > 0) {
      add_product<D>(
          acc3, dyt, z0, ez[z0 + g], ez[z0 + g + 8],
          [&](int kk, int n) { return b_col(st, kk, 8 * n + g, t); }, g, t);
    }
    store_rows(acc3, p.dCh + hn, hrow, z0, Lc, N, g, t, one);
    row_dots(acc3, ct, z0, g, t, rc);
  }
  __syncthreads();                // rx, rc, red

  // ---- dcum, its reverse cumsum ddA, ddt and the chunk's dA, by warp 0:
  // 4 positions a lane, their suffix sums, then the later lanes' totals
  if (warp == 0) {
    float gsum = 0.0f;
    for (int w = 0; w < kWarps; ++w) gsum += red[w];
    float suf[4];
    float run = 0.0f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const int z = 4 * lane + k;
      float dcum = z < Lc ? rc[z] - dts[z] * rx[z] : 0.0f;
      if (z == Lc - 1) dcum += gsum;
      run += dcum;
      suf[k] = run;
    }
    float off = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_down_sync(kFull, off, d);
      if (lane + d < 32) off += o;
    }
    float after = __shfl_down_sync(kFull, off, 1);
    if (lane == 31) after = 0.0f;
    float* const ddtg =
        p.ddt + (static_cast<long long>(b) * p.l + pos0) * p.H + h;
    float da = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int z = 4 * lane + k;
      const float dda = after + suf[k];
      if (z < Lc) {
        ddtg[static_cast<long long>(z) * p.H] = rx[z] + dda * a;
        da = fmaf(dda, dts[z], da);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) da += __shfl_xor_sync(kFull, da, m);
    if (lane == 0) p.dA_chunks[slot] = da;
  }
}

// Kernel 4: dB and dC (each group's heads in order) in their dtype, and dA
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_kernel(const Params p) {
  const long long nbc =
      static_cast<long long>(p.batch) * p.l * p.G * p.N;
  const long long total = 2 * nbc + static_cast<long long>(p.a_rows) * p.H;
  const int rep = p.H / p.G;
  const int nch = chunks_of(p);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const long long j = is_c ? i - nbc : i;
      const int n = static_cast<int>(j % p.N);
      const long long r = j / p.N;
      const int gi = static_cast<int>(r % p.G);
      const long long bl = r / p.G;             // b·l + position
      const float* src = (is_c ? p.dCh : p.dBh) +
                         (bl * p.H + static_cast<long long>(gi) * rep) * p.N +
                         n;
      float s = 0.0f;
      for (int k = 0; k < rep; ++k) s += src[static_cast<long long>(k) * p.N];
      static_cast<T*>(is_c ? p.dC : p.dB)[j] = from_float<T>(s);
    } else {
      const long long j = i - 2 * nbc;
      const int h = static_cast<int>(j % p.H);
      const int ra = static_cast<int>(j / p.H);
      const int b0 = p.a_rows == 1 ? 0 : ra;
      const int b1 = p.a_rows == 1 ? p.batch : ra + 1;
      float s = 0.0f;
      for (int b = b0; b < b1; ++b) {
        for (int c = 0; c < nch; ++c) {
          s += p.dA_chunks[(static_cast<long long>(b) * nch + c) * p.H + h];
        }
      }
      p.dA[j] = s;
    }
  }
}

template <typename K>
cudaError_t launch_blocks(K kernel, long long blocks, size_t smem,
                          cudaStream_t stream, const Params& p) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int padded_chunk(const Params& p) {
  return (p.L + kRowTile - 1) / kRowTile * kRowTile;
}

template <typename T, int D>
cudaError_t launch_dstate(const Params& p, cudaStream_t stream) {
  const int nch = chunks_of(p);
  const long long blocks =
      static_cast<long long>(p.batch) * p.H * (nch > 1 ? nch - 1 : 1);
  return launch_blocks(ssd_bwd_dstate_kernel<T, D>, blocks,
                       DstateSmem<T, D>::bytes(padded_chunk(p)), stream, p);
}

template <typename T, int D>
cudaError_t launch_chunk(const Params& p, cudaStream_t stream) {
  return launch_blocks(ssd_bwd_chunk_kernel<T, D>,
                       static_cast<long long>(p.batch) * p.H * chunks_of(p),
                       ChunkSmem<T, D>::bytes(padded_chunk(p)), stream, p);
}

// the bucket D of max(P, N): 32, 64 or 128
template <typename T>
cudaError_t by_bucket(int kernel, const Params& p, cudaStream_t stream) {
  const int d = p.P > p.N ? p.P : p.N;
  if (kernel == 0) {
    if (d <= 32) return launch_dstate<T, 32>(p, stream);
    if (d <= 64) return launch_dstate<T, 64>(p, stream);
    return launch_dstate<T, 128>(p, stream);
  }
  if (d <= 32) return launch_chunk<T, 32>(p, stream);
  if (d <= 64) return launch_chunk<T, 64>(p, stream);
  return launch_chunk<T, 128>(p, stream);
}

// kernel: 0 dstate, 1 chain, 2 chunk, 3 reduce
int launch(int kernel, int dtype, const Params& p, void* stream_ptr) {
  if (p.batch <= 0 || p.l <= 0 || p.H <= 0 || p.G <= 0 || p.H % p.G != 0 ||
      p.P <= 0 || p.P > kMaxDim || p.N <= 0 || p.N > kMaxDim || p.L <= 0 ||
      p.L > kMaxL || (p.a_rows != 1 && p.a_rows != p.batch) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (kernel == 1) {
    const long long PN = static_cast<long long>(p.P) * p.N;
    const long long blocks = static_cast<long long>(p.batch) * p.H *
                             ((PN + kThreads - 1) / kThreads);
    return static_cast<int>(
        launch_blocks(ssd_bwd_chain_kernel, blocks, 0, stream, p));
  }
  if (kernel == 3) {
    const long long total =
        2LL * p.batch * p.l * p.G * p.N + static_cast<long long>(p.a_rows) * p.H;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return static_cast<int>(
        dtype == 0
            ? launch_blocks(ssd_bwd_reduce_kernel<float>, blocks, 0, stream, p)
            : launch_blocks(ssd_bwd_reduce_kernel<bf16>, blocks, 0, stream, p));
  }
  const int which = kernel == 0 ? 0 : 1;
  return static_cast<int>(dtype == 0 ? by_bucket<float>(which, p, stream)
                                     : by_bucket<bf16>(which, p, stream));
}

}  // namespace

// The four kernels' C entries take one argument list, each reading what
// its kernel needs (the rest may be null or 0).  dtype codes (those of
// ops.py): 0 = float32, 1 = bfloat16, for x, B and C and for dx, dB and
// dC; every other tensor is float32.  x (batch, l, H, P), dt (batch, l,
// H), B and C (batch, l, G, N) with the given element strides and a
// contiguous last dimension; A's row of batch row b at A + b·a_sb (a_sb =
// 0 for one A (H,)), a_rows = 1 (then dA (H,) sums every batch row) or
// batch (dA (batch, H)); dy (batch, l, H, P), dS_last and final_state
// (batch, H, P, N), states and gs (batch, chunks, H, P, N), decay and
// dA_chunks (batch, chunks, H), dBh and dCh (batch, l, H, N), dx, ddt, dB
// and dC contiguous.  chunks = ⌈l / L⌉.  Requires 1 ≤ P, N, L ≤ 128 and
// H % G == 0.  Each launches one kernel on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch (0 =
// success).
#define SSD_BWD_ARGS                                                        \
  int dtype, const void *x, const float *dt, const float *A, const void *B, \
      const void *C, const float *dy, const float *dS_last,                  \
      const float *states, const float *final_state, float *gs,              \
      float *decay, void *dx, float *ddt, float *dBh, float *dCh,            \
      float *dA_chunks, void *dB, void *dC, float *dA, int batch, int l,     \
      int H, int P, int G, int N, int L, int a_rows, long long x_sb,         \
      long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,      \
      long long dt_sh, long long b_sb, long long b_sl, long long b_sg,       \
      long long c_sb, long long c_sl, long long c_sg, long long a_sb,        \
      void *stream
#define SSD_BWD_PARAMS                                                       \
  Params {                                                                   \
    x, dt, A, B, C, dy, dS_last, states, final_state, gs, decay, dx, ddt,    \
        dBh, dCh, dA_chunks, dB, dC, dA, batch, l, H, P, G, N, L, a_rows,    \
        x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb, c_sl, \
        c_sg, a_sb                                                           \
  }

// ΔG_c into gs (chunks ≥ 1) and decay_c: reads dt, A, C, dy
extern "C" int ssd_bwd_dstate(SSD_BWD_ARGS) {
  return launch(0, dtype, SSD_BWD_PARAMS, stream);
}

// G_c over ΔG_c in gs: reads dS_last, decay
extern "C" int ssd_bwd_chain(SSD_BWD_ARGS) {
  return launch(1, dtype, SSD_BWD_PARAMS, stream);
}

// dx, ddt, dBh, dCh, dA_chunks: reads x, dt, A, B, C, dy, states,
// final_state, gs
extern "C" int ssd_bwd_chunk(SSD_BWD_ARGS) {
  return launch(2, dtype, SSD_BWD_PARAMS, stream);
}

// dB, dC, dA: reads dBh, dCh, dA_chunks
extern "C" int ssd_bwd_reduce(SSD_BWD_ARGS) {
  return launch(3, dtype, SSD_BWD_PARAMS, stream);
}

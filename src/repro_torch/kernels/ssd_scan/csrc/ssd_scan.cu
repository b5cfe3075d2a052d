// Mamba2 chunked SSD scan (state-space duality) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_scan_bhclp / _ssd_kernel
// (src/repro/kernels/ssd_scan/kernel.py:36-121).  It computes what that
// kernel computes, not its block structure.  Per (batch, head) and chunk c
// of L positions, with xdt = x·dt (one float32 multiply), dA = dt·A and
// cum = cumsum(dA) over the chunk:
//   y    = ((C·Bᵀ) ∘ Λ)·xdt + exp(cum) ∘ (C·S_{c−1}ᵀ),
//          Λ[z, s] = exp(cum_z − cum_s) for s ≤ z and 0 above the diagonal
//          (selected before the exp: above it the difference is positive and
//          the exp may overflow, and inf·0 would be NaN);
//   ΔS_c = xdtᵀ·(exp(cum_last − cum) ∘ B),
//   S_c  = exp(cum_last)·S_{c−1} + ΔS_c,  S_{−1} = 0;
// y is written per chunk, S after the last.  All arithmetic is float32 for
// float32 and bfloat16 inputs alike; expf and IEEE arithmetic, no
// --use_fast_math: the kernel differs from the plain version (ref.py) in
// summation order and in the TF32 splits below.
//
// Where it differs from the TPU kernel, and why:
//   - Layout: x (b, l, h, p), dt (b, l, h), B and C (b, l, g, n) are read in
//     the model layout through their element strides (last dimension
//     contiguous): x is a slice of the convolution's output, so its l stride
//     is the conv width, and head h reads group h / (H / G) of B and C in
//     place.  The TPU wrapper folded dt, repeated the groups over the heads,
//     transposed to (B, H, C, L, ·) and lane-padded P and N to 128: five
//     copies per call.  y is written contiguous (b, l, h, p) float32, the
//     state contiguous (b, h, p, n) float32.
//   - Sizes: P, N ≤ 128 and the chunk length L ≤ 128 at run time (any L:
//     100 and 77 run); P and N are zero-padded to a bucket D = 32, 64 or 128
//     (of max(P, N)) and L to a multiple of 16 in shared memory; a ragged
//     last chunk (l % L ≠ 0) is masked, though the wrapper's contract (the
//     reference's) never gives one.
//   - Grid: the TPU kernel walks one (b, h)'s chunks in sequence on its
//     sequential grid axis, S carried in VMEM.  Here every (chunk, b, h) is
//     a block, and only the state's recurrence runs in chunk order (the
//     GPU SSD's usual split, fused into one kernel): each block computes
//     its chunk's ΔS_c and y's diagonal blocks, then waits for S_{c−1},
//     publishes S_c and only then adds y's off-diagonal term, which needs
//     S_{c−1}.  The blocks chain through the state output itself: block
//     (c, b, h) reads S_{c−1} from `state` (L2, ld.cg) once flag (b, h)
//     reads c, writes S_c over it and sets the flag to c + 1: one thread's
//     st.release after a barrier, read by one thread's ld.acquire before
//     one (the pattern of CUTLASS's split-k semaphore).  A block's
//     item comes from a ticket (atomicAdd on a counter), chunk-major, so
//     every block waits only on a block that took an earlier ticket and is
//     running or done: no block waits on one that has not started,
//     whatever order the card schedules them in.  The flags and the
//     counter are zeroed by a memset before the launch; one call is that
//     memset and one kernel.  A wait that does not end (a fault; the
//     tickets rule out a deadlock) traps after 2²⁸ polls, seconds to
//     minutes, rather than hang the card.
//   - Products on the tensor cores, mma.sync: C·Bᵀ for bfloat16 inputs as
//     m16n8k16 bf16 → f32 (a bf16 product is exact in float32), for float32
//     inputs and every other product as TF32 products m16n8k8
//     (tf32_tiles.cuh: each float32 operand split in registers into TF32
//     halves, a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi; one TF32 product
//     misses SSD_TOL).  An operand that is exactly TF32 — a bfloat16 x, B
//     or C — has no lo half, so its products take two terms; for bfloat16
//     inputs the scalars move to the other operand to keep x and B exact:
//     y's diagonal term is (W ∘ dt_s)·x and ΔS is (x ∘ dt·w)ᵀ·B, where
//     float32 inputs take W·xdt and xdtᵀ·(w ∘ B) with three terms.
//     S_{c−1}, the B operand of every warp's C·S_{c−1}ᵀ, is split once per
//     block for bfloat16 inputs (its halves resident), at each use for
//     float32 ones (whose shared memory has no room for them at D = 128).
//     W = (C·Bᵀ) ∘ Λ feeds y's product from the accumulator in place (its
//     columns 2t, 2t + 1 standing for k = t, t + 4; B's rows permuted by
//     perm8 in C·Bᵀ, so x, read by rows perm8(2t), perm8(2t + 1), and B,
//     read by rows perm8(g), hit 32 distinct banks at the pitch D + 8).
//     The tensor cores truncate as they add: y's diagonal term and ΔS sum
//     each 16 positions' products in a fresh fragment and add it to their
//     sums in float32; the state's recurrence over the chunks is float32
//     FMAs on S_{c−1} itself.
//   - A per batch row: A's row of batch row b is read at b·a_sb (0 for the
//     model's one A (H,)), so the vmapped training path folds its clients,
//     each with its own A, into the batch of one launch.  Where the
//     backward asks for them, the block also writes S_{c−1}, which it
//     holds anyway, to a `states` output (ssd_scan_bwd.cu reads it): an
//     instance of its own (kStates), so that the inference instance's
//     state loop carries no store and no branch for it.
//   - Work of a block (8 warps): ΔS_c in m16 × n8 tiles split over the
//     warps; y in row tiles of 16 positions, one a warp — warp w takes tile
//     w, and warp 4 + i tile 7 − i, so that the two warps of an SM
//     sub-partition (w and w + 4) take 9 of the causal triangle's 36
//     diagonal blocks at L = 128; per row tile the diagonal blocks' C·Bᵀ
//     (16 × 16, masked and weighted) and W·xdt, then C·S_{c−1}ᵀ.
//   - Staging: x (bfloat16 as it is; float32 as xdt), B and C in rows of
//     D + 8 elements, 16-byte vectors where every row start allows; S_{c−1}
//     over x's rows once they are read, and its lo half beside them: 74 KB
//     (bfloat16) or 110 KB (float32) at zamba2's P = N = 64 and L = 128,
//     two blocks an SM.
//
// Bound on an H100 SXM at the serving path's prefill (b 4, l 256, h 80,
// p 64, n 64, L 128): the bytes (x bf16 in, y float32 out, the states),
// ~37 MB, 0.011 ms at 3.35 TB/s, against the fewest operations that give y
// and the state — the recurrence's, per (b, h) and position one
// multiply-add per state entry for the update and one for C·S, 4NP: 1.34
// GFLOP, 0.008 ms at a third of the 495 TFLOP/s TF32 peak.  So it is bound
// by bytes.  The chunked form does more operations — L(L+1)(N+P) for the
// causal triangles and 4LNP for ΔS and C·S_{c−1}ᵀ per chunk, 2.0× the
// recurrence's at these sizes — in exchange for work that is parallel
// within and across chunks.
#include <cstdint>

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

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  float* y;
  float* state;
  int batch, l, H, P, G, N, L;
  long long x_sb, x_sl, x_sh;     // element strides: batch, position, head
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl, b_sg;     // batch, position, group
  long long c_sb, c_sl, c_sg;
  long long a_sb;                 // A's batch stride: 0 for one A (H,)
  float* states;                  // null, or the states entering each
                                  // chunk (batch, chunks, H, P, N)
  int vec;                        // x, B and C rows in 16-byte vectors
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
  return __float2bfloat16_rn(v);  // exact: v came from a bf16
}

__device__ __forceinline__ int ld_acquire(const int* ptr) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(ptr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* ptr, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(ptr), "r"(v)
               : "memory");
}

// Shared memory of one block, in bytes, in rows of kPitch elements: x's
// tile (float32 inputs: xdt = x·dt in float32; bfloat16: x as it is),
// which S_{c−1} (float32; bfloat16: its TF32 hi half) takes over once it
// is read, so max(Lp, D) rows; for bfloat16 S_{c−1}'s lo half (D rows);
// B and C (T, Lp rows each); cum, the ΔS weights, exp(cum) and dt (kMaxL
// floats each)
template <typename T, int D>
struct Smem {
  static constexpr int kPitch = tf32::pitch<D>();
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr size_t kSBytes = size_t{D} * kPitch * sizeof(float);
  static __host__ __device__ size_t x_bytes(int Lp) {
    const size_t xb = static_cast<size_t>(Lp) * kPitch * sizeof(T);
    return xb > kSBytes ? xb : kSBytes;
  }
  static __host__ __device__ size_t b_offset(int Lp) {
    return x_bytes(Lp) + (kBf16 ? kSBytes : 0);
  }
  static __host__ __device__ size_t bytes(int Lp) {
    return b_offset(Lp) + 2 * static_cast<size_t>(Lp) * kPitch * sizeof(T) +
           4 * kMaxL * sizeof(float);
  }
};

// blocks an SM the registers must leave room for: two below D = 128,
// where two blocks' shared memory fits
template <int D>
constexpr int min_blocks() {
  return D <= 64 ? 2 : 1;
}

// One block per (chunk, batch, head), taken in ticket order (chunk-major).
// T: the type of x, B and C; D: the bucket of max(P, N); kStates: whether
// the block writes S_{c−1} to p.states.
template <typename T, int D, bool kStates>
__global__ void __launch_bounds__(kThreads, min_blocks<D>())
    ssd_scan_kernel_mma(const Params p, int* flags) {
  using Sm = Smem<T, D>;
  constexpr bool kBf16 = Sm::kBf16;
  constexpr int PT = Sm::kPitch;
  constexpr int KD = D / 8;       // k8 steps over n
  constexpr int NP = D / 8;       // n8 tiles of y's (and ΔS's) columns
  // ΔS's m16 (p) × n8 (n) tiles over the warps: kMW warps along p, each
  // taking one m16 tile and NPW n8 tiles
  constexpr int kMW = D / 16 < kWarps ? D / 16 : kWarps;
  constexpr int NPW = NP / (kWarps / kMW);
  static_assert(D / 16 <= kWarps, "one m16 tile of ΔS a warp");
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane / 4;        // fragment row / column index g
  const int quad = lane % 4;      // t
  const int pg = tf32::perm8(g8);
  const int pk[2] = {tf32::perm8(2 * quad), tf32::perm8(2 * quad + 1)};

  if (tid == 0) s_ticket = atomicAdd(flags, 1);
  const int Lp = (p.L + 15) / 16 * 16;
  T* const xs = reinterpret_cast<T*>(ssd_smem);          // x or xdt [Lp]
  float* const sp = reinterpret_cast<float*>(ssd_smem);  // S_{c−1} [D]
  float* const sp_lo = reinterpret_cast<float*>(ssd_smem + Sm::x_bytes(Lp));
  T* const bs = reinterpret_cast<T*>(ssd_smem + Sm::b_offset(Lp));
  T* const cs = bs + Lp * PT;                            // [Lp][PT]
  float* const cum = reinterpret_cast<float*>(cs + Lp * PT);
  float* const wend = cum + kMaxL;  // ΔS's weights (below)
  float* const ez = wend + kMaxL;
  float* const dts = ez + kMaxL;
  __syncthreads();                // s_ticket

  const int BH = p.batch * p.H;
  const int ci = s_ticket / BH;
  const int bh = s_ticket - ci * BH;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int gi = h / (p.H / p.G);
  const int pos0 = ci * p.L;
  const int Lc = min(p.L, p.l - pos0);
  const float a = p.A[b * p.a_sb + h];
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* bg = static_cast<const T*>(p.B) + b * p.b_sb + gi * p.b_sg;
  const T* cg = static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  float* const state = p.state + static_cast<long long>(bh) * p.P * p.N;

  // ---- the chunk's tiles, zero-padded to Lp × D: 16-byte vectors where
  // every row start allows them (p.vec, a choice for the whole call), else
  // element by element; each thread keeps several rows' loads in flight.
  // A float32 x is stored as xdt = x·dt; a bfloat16 x as it is, exactly
  // TF32, dt going to the other operand of its products.
  for (int s = tid; s < kMaxL; s += kThreads) {
    dts[s] = s < Lc ? dtg[(pos0 + s) * p.dt_sl] : 0.0f;
  }
  if (p.vec) {
    constexpr int VEC = 16 / sizeof(T);       // elements a vector
    constexpr int VPR = D / VEC;              // vectors a padded row
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (int i = tid; i < Lp * VPR; i += kThreads) {
      const int s = i / VPR;
      const int col = VEC * (i - s * VPR);
      const long long pos = pos0 + s;
      const bool row = s < Lc;
      const bool in_p = row && col < p.P;
      const bool in_n = row && col < p.N;
      const uint4 xv =
          in_p ? *reinterpret_cast<const uint4*>(xg + pos * p.x_sl + col)
               : zero;
      if constexpr (kBf16) {
        *reinterpret_cast<uint4*>(xs + s * PT + col) = xv;
      } else {
        const float d = in_p ? dtg[pos * p.dt_sl] : 0.0f;
        *reinterpret_cast<float4*>(xs + s * PT + col) = make_float4(
            __uint_as_float(xv.x) * d, __uint_as_float(xv.y) * d,
            __uint_as_float(xv.z) * d, __uint_as_float(xv.w) * d);
      }
      *reinterpret_cast<uint4*>(bs + s * PT + col) =
          in_n ? *reinterpret_cast<const uint4*>(bg + pos * p.b_sl + col)
               : zero;
      *reinterpret_cast<uint4*>(cs + s * PT + col) =
          in_n ? *reinterpret_cast<const uint4*>(cg + pos * p.c_sl + col)
               : zero;
    }
  } else {
#pragma unroll 8
    for (int i = tid; i < Lp * D; i += kThreads) {
      const int s = i / D;
      const int col = i - s * D;
      const bool row = s < Lc;
      const long long pos = pos0 + s;
      if constexpr (kBf16) {
        xs[s * PT + col] =
            row && col < p.P ? xg[pos * p.x_sl + col] : from_float<T>(0.0f);
      } else {
        xs[s * PT + col] = row && col < p.P
                               ? xg[pos * p.x_sl + col] * dtg[pos * p.dt_sl]
                               : 0.0f;
      }
      bs[s * PT + col] =
          row && col < p.N ? bg[pos * p.b_sl + col] : from_float<T>(0.0f);
      cs[s * PT + col] =
          row && col < p.N ? cg[pos * p.c_sl + col] : from_float<T>(0.0f);
    }
  }
  __syncthreads();                // dts
  if (warp == 0) {
    // inclusive scan of dA = dt·A: 4 positions per lane, then the lanes;
    // positions past Lc keep cum_last
    float v[4];
    float run = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run += dts[lane * 4 + k] * a;
      v[k] = run;
    }
    float off = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, off, d);
      if (lane >= d) off += o;
    }
    off -= run;                   // exclusive prefix of this lane
#pragma unroll
    for (int k = 0; k < 4; ++k) cum[lane * 4 + k] = off + v[k];
  }
  __syncthreads();                // tiles, cum
  const float cum_last = cum[Lc - 1];
  // ΔS's weights: exp(cum_last − cum) on B's side for float32 inputs, and
  // dt·exp(cum_last − cum) on x's for bfloat16, whose B stays exact
  for (int s = tid; s < kMaxL; s += kThreads) {
    const float w = s < Lc ? expf(cum_last - cum[s]) : 0.0f;
    wend[s] = kBf16 ? dts[s] * w : w;
    ez[s] = s < Lc ? expf(cum[s]) : 0.0f;
  }
  __syncthreads();                // wend, ez

  // ---- ΔS_c[p][n] = Σ_s xdt[s][p]·(exp(cum_last − cum_s)·B[s][n]): this
  // warp's m16 tile (A = (xdt ∘ w)ᵀ or xdtᵀ: rows p, k over positions in
  // natural order) and its NPW n8 tiles (B = B or w ∘ B: rows s, column
  // n); each 16 positions' products in fresh fragments, then added
  const int pc = 16 * (warp % kMW) + g8;      // A's rows pc, pc + 8
  const int nw0 = NPW * (warp / kMW);
  float ds[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[j][e] = 0.0f;
  }
  for (int s0 = 0; s0 < Lp; s0 += 16) {
    tf32::FragA ax[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int s = s0 + 8 * kk + quad;
      const T* r0 = xs + s * PT + pc;
      const T* r4 = r0 + 4 * PT;
      if constexpr (kBf16) {
        ax[kk] = tf32::FragA(
            to_float(r0[0]) * wend[s], to_float(r0[8]) * wend[s],
            to_float(r4[0]) * wend[s + 4], to_float(r4[8]) * wend[s + 4]);
      } else {
        ax[kk] = tf32::FragA(r0[0], r0[8], r4[0], r4[8]);
      }
    }
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int nc = 8 * (nw0 + j) + g8;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int s = s0 + 8 * kk + quad;
        if constexpr (kBf16) {
          tf32::mma(part, ax[kk],
                    tf32::ExactB(to_float(bs[s * PT + nc]),
                                 to_float(bs[(s + 4) * PT + nc])));
        } else {
          tf32::mma_3xtf32(
              part, ax[kk],
              tf32::FragB(wend[s] * to_float(bs[s * PT + nc]),
                          wend[s + 4] * to_float(bs[(s + 4) * PT + nc])));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] += part[e];
    }
  }

  // ---- y's diagonal blocks: this warp's row tile of 16 positions, z0 =
  // 16·rt, rt = warp for warps 0-3 and 11 − warp for 4-7, so that the two
  // warps of each SM sub-partition (w, w + 4) take 9 of the causal
  // triangle's 36 diagonal blocks (at L = 128)
  const int rt = warp < 4 ? warp : 11 - warp;
  const int z0 = 16 * rt;
  const bool has_rows = z0 < Lp;
  const T* crow = cs + (z0 + g8) * PT;        // C rows z0 + g, + 8
  float yacc[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[n][e] = 0.0f;
  }
  for (int s0 = 0; has_rows && s0 <= z0; s0 += 16) {
    // G = C·Bᵀ (16 positions z × 16 positions s): n8 tile j's column g
    // reads B row s0 + 8·j + perm8(g)
    float gm[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) gm[j][e] = 0.0f;
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = 16 * kk + 2 * quad;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(crow + c);
        af[1] = *reinterpret_cast<const uint32_t*>(crow + 8 * PT + c);
        af[2] = *reinterpret_cast<const uint32_t*>(crow + c + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(crow + 8 * PT + c + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const T* brow = bs + (s0 + 8 * j + pg) * PT;
          fa_tiles::mma_bf16(
              gm[j], af, *reinterpret_cast<const uint32_t*>(brow + c),
              *reinterpret_cast<const uint32_t*>(brow + c + 8));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const tf32::FragA ac = tf32::head_a<PT>(
            reinterpret_cast<const float*>(crow), kk, quad);
        const int c = 8 * kk + 2 * quad;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 bx = tf32::ld2(reinterpret_cast<const float*>(bs) +
                                      (s0 + 8 * j + pg) * PT + c);
          tf32::mma_3xtf32(gm[j], ac, tf32::FragB(bx.x, bx.y));
        }
      }
    }
    // W = G ∘ Λ (for bfloat16 inputs also ∘ dt_s, x's factor): element
    // (j, e) is position z0 + g + 8·(e / 2) against s0 + 8·j + pk[e % 2];
    // the mask selects before the exp
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int z = z0 + g8 + 8 * (e / 2);
        const int s = s0 + 8 * j + pk[e % 2];
        const float w = gm[j][e] * expf(cum[z] - cum[s]);
        gm[j][e] = s <= z && z < Lc ? (kBf16 ? w * dts[s] : w) : 0.0f;
      }
    }
    // y += W·xdt (bfloat16: (W ∘ dt)·x): k8 step j from W's n8 tile j in
    // place, reading x's rows s0 + 8·j + pk[0] and pk[1]; a fresh fragment
    // per n8 tile
    const tf32::FragA aw[2] = {tf32::acc_a(gm[0]), tf32::acc_a(gm[1])};
    if constexpr (kBf16) {
      const T* const xr = xs + s0 * PT + g8;
      tf32::mma_rows(yacc, aw, [&](int j, int n) {
        return tf32::ExactB(to_float(xr[(8 * j + pk[0]) * PT + 8 * n]),
                            to_float(xr[(8 * j + pk[1]) * PT + 8 * n]));
      });
    } else {
      tf32::mma_rows_tf32<NP, 2, PT>(
          yacc, aw, reinterpret_cast<const float*>(xs) + s0 * PT + g8, pk);
    }
  }
  __syncthreads();                // x is read: its rows take S_{c−1}

  // ---- the chain: S_{c−1} from the state output once chunk c − 1 of this
  // (b, h) has published it, read by each thread at its entries of ΔS's
  // fragments (which cover the D × D entries once) and staged for every
  // warp's C·S_{c−1}ᵀ (bfloat16: split into TF32 halves once); then
  // S_c = exp(cum_last)·S_{c−1} + ΔS_c over it
  int* const flag = flags + 1 + bh;
  if (ci > 0) {
    if (tid == 0) {
      long long polls = 0;
      while (ld_acquire(flag) < ci) {
        __nanosleep(64);
        if (++polls > (1LL << 28)) __trap();
      }
    }
    __syncthreads();              // the acquire orders the block's reads
  }
  float prev[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = pc + 8 * (e / 2);
      const int col = 8 * (nw0 + j) + 2 * quad + e % 2;
      prev[j][e] = ci > 0 && r < p.P && col < p.N
                       ? __ldcg(state + r * p.N + col)
                       : 0.0f;
    }
  }
  const float decay = expf(cum_last);
  // the backward's copy of S_{c−1}, in the instance that writes one
  [[maybe_unused]] float* entering = nullptr;
  if constexpr (kStates) {
    const long long chunks = (p.l + p.L - 1) / p.L;
    entering = p.states + ((b * chunks + ci) * p.H + h) * p.P * p.N;
  }
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = pc + 8 * (e / 2);
      const int col = 8 * (nw0 + j) + 2 * quad + e % 2;
      if (ci > 0) {
        if constexpr (kBf16) {
          uint32_t hi, lo;
          tf32::split(prev[j][e], hi, lo);
          sp[r * PT + col] = __uint_as_float(hi);
          sp_lo[r * PT + col] = __uint_as_float(lo);
        } else {
          sp[r * PT + col] = prev[j][e];
        }
      }
      if (r < p.P && col < p.N) {
        __stcg(state + r * p.N + col, ds[j][e] + decay * prev[j][e]);
        if constexpr (kStates) entering[r * p.N + col] = prev[j][e];
      }
    }
  }
  __syncthreads();                // S_{c−1} staged; the release orders the
                                  // block's writes of S_c
  if (tid == 0) st_release(flag, ci + 1);
  if (!has_rows) return;

  // ---- y += exp(cum) ∘ (C·S_{c−1}ᵀ): B reads S_{c−1} row 8·n + g (a p)
  // at the step's columns (n) 2t, 2t + 1; y's n8 tiles in two halves, each
  // summed in a fresh fragment (the float32 instance at D = 64 spilled
  // with all of them at once beside y).  A bfloat16 C is exact: two
  // products, C·S_lo + C·S_hi, from S's resident halves.
  if (ci > 0) {
    const float e0 = ez[z0 + g8];
    const float e8 = ez[z0 + g8 + 8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      constexpr int NH = NP / 2;
      float off[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) off[n][e] = 0.0f;
      }
#pragma unroll 2
      for (int kk = 0; kk < KD; ++kk) {
        const int c = 8 * kk + 2 * quad;
        const float2 x = tf32::pair(crow, c);
        const float2 x8 = tf32::pair(crow + 8 * PT, c);
        const int srow = (8 * NH * half + g8) * PT + c;
        if constexpr (kBf16) {
          const tf32::ExactA ac(x.x, x8.x, x.y, x8.y);
#pragma unroll
          for (int n = 0; n < NH; ++n) {
            tf32::mma(off[n], ac,
                      tf32::FragB(tf32::ld2(sp + srow + 8 * n * PT),
                                  tf32::ld2(sp_lo + srow + 8 * n * PT)));
          }
        } else {
          const tf32::FragA ac(x.x, x8.x, x.y, x8.y);
#pragma unroll
          for (int n = 0; n < NH; ++n) {
            const float2 sv = tf32::ld2(sp + srow + 8 * n * PT);
            tf32::mma_3xtf32(off[n], ac, tf32::FragB(sv.x, sv.y));
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        float* yn = yacc[NH * half + n];
        yn[0] += e0 * off[n][0];
        yn[1] += e0 * off[n][1];
        yn[2] += e8 * off[n][2];
        yn[3] += e8 * off[n][3];
      }
    }
  }
  // rows z < Lc, columns p < P
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int z = z0 + g8 + 8 * i;
    if (z >= Lc) continue;
    float* yrow =
        p.y + ((static_cast<long long>(b) * p.l + pos0 + z) * p.H + h) * p.P;
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      const int col = 8 * n + 2 * quad;
      if (p.P % 2 == 0 && col + 1 < p.P) {
        *reinterpret_cast<float2*>(yrow + col) =
            make_float2(yacc[n][2 * i], yacc[n][2 * i + 1]);
      } else {
        if (col < p.P) yrow[col] = yacc[n][2 * i];
        if (col + 1 < p.P) yrow[col + 1] = yacc[n][2 * i + 1];
      }
    }
  }
}

template <typename T, int D, bool kStates>
cudaError_t launch_k(const Params& p, int* flags, cudaStream_t stream) {
  const int Lp = (p.L + 15) / 16 * 16;
  const size_t smem = Smem<T, D>::bytes(Lp);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel_mma<T, D, kStates>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long bh = static_cast<long long>(p.batch) * p.H;
  err = cudaMemsetAsync(flags, 0, (1 + bh) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const long long blocks = bh * ((p.l + p.L - 1) / p.L);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_scan_kernel_mma<T, D, kStates>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p, flags);
  return cudaGetLastError();
}

// the instance that writes the states entering each chunk where they are
// asked for
template <typename T, int D>
cudaError_t launch(const Params& p, int* flags, cudaStream_t stream) {
  return p.states != nullptr ? launch_k<T, D, true>(p, flags, stream)
                             : launch_k<T, D, false>(p, flags, stream);
}

template <typename T>
cudaError_t launch_d(const Params& p, int* flags, cudaStream_t stream) {
  const int d = p.P > p.N ? p.P : p.N;
  if (d <= 32) return launch<T, 32>(p, flags, stream);
  if (d <= 64) return launch<T, 64>(p, flags, stream);
  return launch<T, 128>(p, flags, stream);
}

// whether every row of x, B and C starts on a 16-byte boundary and holds
// whole 16-byte vectors: the base addresses, and each stride in bytes
// (elements of `esize` bytes) of a dimension longer than 1, multiples of
// 16, and P and N multiples of a vector's elements
int rows_in_vectors(const Params& p, int esize) {
  const int vec = 16 / esize;
  if (p.P % vec || p.N % vec) return 0;
  const long long ptrs[3] = {reinterpret_cast<long long>(p.x),
                             reinterpret_cast<long long>(p.B),
                             reinterpret_cast<long long>(p.C)};
  const long long strides[9] = {p.x_sb, p.x_sl, p.x_sh, p.b_sb, p.b_sl,
                                p.b_sg, p.c_sb, p.c_sl, p.c_sg};
  const int sizes[9] = {p.batch, p.l, p.H, p.batch, p.l, p.G,
                        p.batch, p.l, p.G};
  for (long long ptr : ptrs) {
    if (ptr % 16) return 0;
  }
  for (int i = 0; i < 9; ++i) {
    if (sizes[i] > 1 && (esize * strides[i]) % 16) return 0;
  }
  return 1;
}

}  // namespace

// dtype codes (those of ops.py): 0 = float32, 1 = bfloat16, for x, B and C
// alike; dt and A are float32.  x (batch, l, H, P), dt (batch, l, H), B and
// C (batch, l, G, N) with the given element strides and a contiguous last
// dimension; A's row of batch row b at A + b·a_sb (a_sb = 0: one A (H,)
// for every row; H: A (batch, H), the vmapped clients folded into the
// batch), contiguous over H.  y is written contiguous float32
// (batch, l, H, P), state contiguous float32 (batch, H, P, N), and, where
// `states` is not null, the state entering each chunk to it, contiguous
// float32 (batch, ⌈l / L⌉, H, P, N), zero for the first: the backward
// reads them.  The scan walks chunks of L positions, the last one ragged
// when L does not divide l.
// `flags`: int32 scratch of 1 + batch·H elements, zeroed here (a memset on
// `stream`) and used by the kernel to chain the chunks.  Requires
// 1 ≤ P, N, L ≤ 128, H % G == 0, and batch·H·⌈l / L⌉ < 2³¹.  Launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int ssd_scan_fwd(
    int dtype, const void* x, const float* dt, const float* A, const void* B,
    const void* C, float* y, float* state, int batch, int l, int H, int P,
    int G, int N, int L, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
    long long b_sl, long long b_sg, long long c_sb, long long c_sl,
    long long c_sg, long long a_sb, float* states, int* flags, void* stream) {
  if (batch <= 0 || l <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kMaxDim || N <= 0 || N > kMaxDim || L <= 0 || L > kMaxL ||
      flags == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{x,    dt,   A,    B,    C,     y,     state, batch, l,
           H,    P,    G,    N,    L,     x_sb,  x_sl,  x_sh,  dt_sb,
           dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb,  c_sl,  c_sg,  a_sb,
           states, 0};
  p.vec = rows_in_vectors(p, dtype == 0 ? 4 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_d<float>(p, flags, s));
  if (dtype == 1) return static_cast<int>(launch_d<bf16>(p, flags, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

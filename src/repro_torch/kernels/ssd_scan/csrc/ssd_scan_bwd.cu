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
//   1. dstate (a block per (chunk, b, h)): ΔG_c = Σ_z exp(cum_z) dy_z ⊗ C_z,
//      y's carried-state term, and decay_c = exp(cum_last);
//   2. chain (a thread per state entry of each (b, h)): the reverse of the
//      forward's chain, G_{C−1} = dS_last, G_{c−1} = decay_c·G_c + ΔG_c,
//      G_c written over ΔG_c;
//   3. chunk (a block per (chunk, b, h)): W = (C·Bᵀ) ∘ E, then
//      d(xdt) = Wᵀ·dy + w ∘ (B·G_cᵀ), giving dx = d(xdt)·dt; V = (dy·xdtᵀ) ∘ E
//      over W, then this head's dB = Vᵀ·C + w ∘ (xdt·G_c) and dC = V·B +
//      exp(cum) ∘ (dy·S_{c−1}); dcum_z = C_z·dC_z − xdt_z·d(xdt)_z, plus
//      ⟨G_c, S_c⟩ at the chunk's last position (S_c the next chunk's
//      entering state, or the final state); ddA its reverse cumsum; ddt =
//      Σ_p d(xdt)·x + ddA·A, and the chunk's share of dA, Σ ddA·dt;
//   4. reduce (a thread per output entry): dB and dC summed over the heads
//      of each group, dA over the chunks (and the batch rows when A is one
//      (H,) for all of them).
// All arithmetic is float32, for float32 and bfloat16 inputs alike; dx, dB
// and dC are rounded to their inputs' dtype once, at the end.  Every sum
// runs in a fixed order (no atomics): reruns are bit-equal.
//
// Design: a simple kernel that is right.  The products are SIMT float32
// FMAs (no tensor cores): a block of 256 threads computes a product of up
// to 128 × 128 outputs, each thread 8 rows × (D / 16) columns strided by 16
// (conflict-free shared-memory reads), its operands staged 16 deep in
// shared memory through accessors that read x, B, C and dy in place
// through their strides (x, B and C are slices of the convolution's output,
// the groups unrepeated) and W or V from shared memory.  One L × L buffer
// holds W, then V.  P and N ≤ 128, the chunk length ≤ 128; D is the bucket
// (32, 64, 128) of max(P, N).
//
// Bound on an H100 SXM at the training path's shape (b 4 — two clients of
// two rows, folded — l 256, h 80, p 64, n 64, L 128, float32): the bytes,
// x, dy and dx (21 MB each) and the rest, ~64 MB, 0.019 ms at 3.35 TB/s,
// against the chunked form's operations — per (b, h, chunk) the causal
// triangles' C·Bᵀ, dy·xdtᵀ, Wᵀ·dy, Vᵀ·C and V·B, L(L+1)/2·(3N + 2P)
// multiply-adds, and ΔG, B·G_cᵀ, xdt·G_c and dy·S_{c−1}, 4LNP — 12.2
// GFLOP, 0.074 ms at a third of the TF32 peak (0.18 ms at the 67 TFLOP/s
// SIMT peak): bound by operations.  The SIMT products and the full
// L × L tiles (the causal half computed as zeros) leave it well above
// that; tensor cores (mma.sync / wgmma) are the next step.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxL = 128;        // chunk length
constexpr int kMaxDim = 128;      // head_dim P and d_state N
constexpr int kTile = 128;        // rows of a block product
constexpr int kKs = 16;           // depth of a staged slab
constexpr int kPitchA = kTile + 1;
constexpr int kPitchW = kMaxL + 1;
constexpr int kPitchPart = 17;

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

// acc[i][j] += Σ_{k < K} a(m, k)·b(k, n) at m = ty + 16·i < M, n = tx +
// 16·j < Nc (tx = tid % 16, ty = tid / 16): slabs of kKs steps of k staged
// in shared memory (sa: kKs × kPitchA, sb: kKs × (16·TN + 1)), zero past
// M, Nc and K.  KFA / KFB: consecutive threads stage consecutive k (the
// operand's contiguous dimension is k) rather than consecutive m or n.
// Begins and ends with a barrier.
template <int TN, bool KFA, bool KFB, typename FA, typename FB>
__device__ __forceinline__ void block_gemm(float (&acc)[8][TN], int M, int Nc,
                                           int K, FA a, FB b, float* sa,
                                           float* sb) {
  constexpr int NW = 16 * TN;
  constexpr int PB = NW + 1;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += kKs) {
    __syncthreads();
    for (int i = tid; i < kTile * kKs; i += kThreads) {
      const int m = KFA ? i / kKs : i % kTile;
      const int kk = KFA ? i % kKs : i / kTile;
      const int k = k0 + kk;
      sa[kk * kPitchA + m] = m < M && k < K ? a(m, k) : 0.0f;
    }
    for (int i = tid; i < NW * kKs; i += kThreads) {
      const int n = KFB ? i / kKs : i % NW;
      const int kk = KFB ? i % kKs : i / NW;
      const int k = k0 + kk;
      sb[kk * PB + n] = n < Nc && k < K ? b(k, n) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKs; ++kk) {
      float av[8], bv[TN];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = sa[kk * kPitchA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = sb[kk * PB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// f(m, n, value) for each of this thread's entries with m < M, n < Nc
template <int TN, typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[8][TN], int M,
                                             int Nc, F f) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = ty + 16 * i;
      const int n = tx + 16 * j;
      if (m < M && n < Nc) f(m, n, acc[i][j]);
    }
  }
}

// out[m] = Σ_{n < Nc} acc(m, n)·other(m, n) for m < M: each thread's share
// of its rows, then the 16 shares of a row summed in order
template <int TN, typename F>
__device__ __forceinline__ void row_dots(const float (&acc)[8][TN], int M,
                                         int Nc, F other, float* part,
                                         float* out) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty + 16 * i;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 16 * j;
      if (m < M && n < Nc) s = fmaf(acc[i][j], other(m, n), s);
    }
    part[m * kPitchPart + tx] = s;
  }
  __syncthreads();
  if (tid < M) {
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += part[tid * kPitchPart + t];
    out[tid] = s;
  }
  __syncthreads();
}

// w[z·kPitchW + s] = acc(z, s)·exp(cum_z − cum_s) for s ≤ z < Lc, 0 above
// the diagonal: the mask selects before the exp
__device__ __forceinline__ void store_masked(const float (&acc)[8][8], int Lc,
                                             const float* cum, float* w) {
  for_each_acc(acc, Lc, Lc, [&](int z, int s, float v) {
    w[z * kPitchW + s] = s <= z ? v * expf(cum[z] - cum[s]) : 0.0f;
  });
}

// The chunk's dt (0 past Lc), its cumsum of dt·a in position order, exp(cum)
// and exp(cum_last − cum) (0 past Lc), in shared memory
__device__ __forceinline__ void chunk_prologue(const Params& p, int b, int h,
                                               int pos0, int Lc, float a,
                                               float* dts, float* cum,
                                               float* ez, float* wend) {
  const int tid = threadIdx.x;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  for (int s = tid; s < kMaxL; s += kThreads) {
    dts[s] = s < Lc ? dtg[(pos0 + s) * p.dt_sl] : 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.0f;
    for (int s = 0; s < Lc; ++s) {
      run += dts[s] * a;
      cum[s] = run;
    }
  }
  __syncthreads();
  const float last = cum[Lc - 1];
  for (int s = tid; s < kMaxL; s += kThreads) {
    ez[s] = s < Lc ? expf(cum[s]) : 0.0f;
    wend[s] = s < Lc ? expf(last - cum[s]) : 0.0f;
  }
  __syncthreads();
}

// Shared memory of the dstate kernel, in floats: the two slabs, then dt,
// cum, exp(cum) and exp(cum_last − cum)
constexpr int kDstateFloats = 2 * kKs * kPitchA + 4 * kMaxL;
// of the chunk kernel: W / V, the two slabs, the row-dot shares, dt, cum,
// exp(cum), exp(cum_last − cum), Σ_p d(xdt)·x, C·dC, and the block sum
constexpr int kChunkW = 0;
constexpr int kChunkSa = kChunkW + kMaxL * kPitchW;
constexpr int kChunkSb = kChunkSa + kKs * kPitchA;
constexpr int kChunkPart = kChunkSb + kKs * kPitchA;
constexpr int kChunkVec = kChunkPart + kTile * kPitchPart;
constexpr int kChunkRed = kChunkVec + 6 * kMaxL;
constexpr int kChunkFloats = kChunkRed + kThreads;

// Kernel 1: ΔG_c and decay_c, a block per (chunk, b, h); chunk 0 feeds no
// earlier chunk and writes nothing
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dstate_kernel(const Params p) {
  extern __shared__ float dstate_smem[];
  float* const sa = dstate_smem;
  float* const sb = sa + kKs * kPitchA;
  float* const dts = sb + kKs * kPitchA;
  float* const cum = dts + kMaxL;
  float* const ez = cum + kMaxL;
  float* const wend = ez + kMaxL;
  const int nch = chunks_of(p);
  const int BH = p.batch * p.H;
  const int ci = blockIdx.x / BH;
  const int bh = blockIdx.x - ci * BH;
  if (ci == 0) return;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int gi = h / (p.H / p.G);
  const int pos0 = ci * p.L;
  const int Lc = min(p.L, p.l - pos0);
  chunk_prologue(p, b, h, pos0, Lc, p.A[b * p.a_sb + h], dts, cum, ez, wend);
  const T* cg = static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg;
  const long long row = static_cast<long long>(p.H) * p.P;
  const float* dyg = p.dy + (static_cast<long long>(b) * p.l + pos0) * row +
                     static_cast<long long>(h) * p.P;
  float acc[8][TN] = {};
  block_gemm<TN, false, false>(
      acc, p.P, p.N, Lc,
      [&](int q, int z) { return ez[z] * dyg[z * row + q]; },
      [&](int z, int n) { return to_float(cg[(pos0 + z) * p.c_sl + n]); },
      sa, sb);
  const long long slot = (static_cast<long long>(b) * nch + ci) * p.H + h;
  float* const out = p.gs + slot * p.P * p.N;
  for_each_acc(acc, p.P, p.N,
               [&](int q, int n, float v) { out[q * p.N + n] = v; });
  if (threadIdx.x == 0) p.decay[slot] = expf(cum[Lc - 1]);
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

// Kernel 3: a block per (chunk, b, h): dx, ddt, this head's dB and dC, and
// the chunk's share of dA
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_chunk_kernel(const Params p) {
  extern __shared__ float chunk_smem[];
  float* const wv = chunk_smem + kChunkW;
  float* const sa = chunk_smem + kChunkSa;
  float* const sb = chunk_smem + kChunkSb;
  float* const part = chunk_smem + kChunkPart;
  float* const dts = chunk_smem + kChunkVec;
  float* const cum = dts + kMaxL;
  float* const ez = cum + kMaxL;
  float* const wend = ez + kMaxL;
  float* const rx = wend + kMaxL;
  float* const rc = rx + kMaxL;
  float* const red = chunk_smem + kChunkRed;
  const int tid = threadIdx.x;
  const int nch = chunks_of(p);
  const int BH = p.batch * p.H;
  const int ci = blockIdx.x / BH;
  const int bh = blockIdx.x - ci * BH;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int gi = h / (p.H / p.G);
  const int pos0 = ci * p.L;
  const int Lc = min(p.L, p.l - pos0);
  const int P = p.P;
  const int N = p.N;
  const float a = p.A[b * p.a_sb + h];
  chunk_prologue(p, b, h, pos0, Lc, a, dts, cum, ez, wend);

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                pos0 * p.x_sl;
  const T* bg = static_cast<const T*>(p.B) + b * p.b_sb + gi * p.b_sg +
                pos0 * p.b_sl;
  const T* cg = static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg +
                pos0 * p.c_sl;
  const long long row = static_cast<long long>(p.H) * P;
  const long long at = (static_cast<long long>(b) * p.l + pos0) * row +
                       static_cast<long long>(h) * P;
  const float* dyg = p.dy + at;
  const long long slot = (static_cast<long long>(b) * nch + ci) * p.H + h;
  const long long PN = static_cast<long long>(P) * N;
  const float* const Gc = p.gs + slot * PN;
  const float* const Sp = p.states + slot * PN;
  const float* const Sn =
      ci + 1 < nch ? p.states + (slot + p.H) * PN
                   : p.final_state + static_cast<long long>(bh) * PN;
  auto X = [&](int s, int q) { return to_float(xg[s * p.x_sl + q]); };
  auto Bf = [&](int s, int n) { return to_float(bg[s * p.b_sl + n]); };
  auto Cf = [&](int z, int n) { return to_float(cg[z * p.c_sl + n]); };
  auto DY = [&](int z, int q) { return dyg[z * row + q]; };

  // ---- W = (C·Bᵀ) ∘ E
  {
    float acc[8][8] = {};
    block_gemm<8, true, true>(
        acc, Lc, Lc, N, Cf, [&](int n, int s) { return Bf(s, n); }, sa, sb);
    store_masked(acc, Lc, cum, wv);
  }
  // ---- d(xdt) = Wᵀ·dy + w ∘ (B·G_cᵀ); dx = d(xdt)·dt; rx = Σ_p d(xdt)·x
  {
    float acc[8][TN] = {};
    block_gemm<TN, false, false>(
        acc, Lc, P, Lc, [&](int s, int z) { return wv[z * kPitchW + s]; },
        DY, sa, sb);
    block_gemm<TN, true, true>(
        acc, Lc, P, N, [&](int s, int n) { return wend[s] * Bf(s, n); },
        [&](int n, int q) { return Gc[q * N + n]; }, sa, sb);
    T* const dxg = static_cast<T*>(p.dx) + at;
    for_each_acc(acc, Lc, P, [&](int s, int q, float v) {
      dxg[s * row + q] = from_float<T>(v * dts[s]);
    });
    row_dots(acc, Lc, P, X, part, rx);
  }
  // ---- V = (dy·xdtᵀ) ∘ E, over W (read by every thread before the
  // barriers above)
  {
    float acc[8][8] = {};
    block_gemm<8, true, true>(
        acc, Lc, Lc, P, DY, [&](int q, int s) { return X(s, q) * dts[s]; },
        sa, sb);
    store_masked(acc, Lc, cum, wv);
  }
  const long long hn = (static_cast<long long>(b) * p.l + pos0) * p.H * N +
                       static_cast<long long>(h) * N;
  const long long hrow = static_cast<long long>(p.H) * N;
  // ---- this head's dB = Vᵀ·C + w ∘ (xdt·G_c)
  {
    float acc[8][TN] = {};
    block_gemm<TN, false, false>(
        acc, Lc, N, Lc, [&](int s, int z) { return wv[z * kPitchW + s]; },
        Cf, sa, sb);
    block_gemm<TN, true, false>(
        acc, Lc, N, P,
        [&](int s, int q) { return wend[s] * (X(s, q) * dts[s]); },
        [&](int q, int n) { return Gc[q * N + n]; }, sa, sb);
    float* const out = p.dBh + hn;
    for_each_acc(acc, Lc, N,
                 [&](int s, int n, float v) { out[s * hrow + n] = v; });
  }
  // ---- this head's dC = V·B + exp(cum) ∘ (dy·S_{c−1}); rc = C·dC
  {
    float acc[8][TN] = {};
    block_gemm<TN, true, false>(
        acc, Lc, N, Lc, [&](int z, int s) { return wv[z * kPitchW + s]; },
        Bf, sa, sb);
    if (ci > 0) {
      block_gemm<TN, true, false>(
          acc, Lc, N, P, [&](int z, int q) { return ez[z] * DY(z, q); },
          [&](int q, int n) { return Sp[q * N + n]; }, sa, sb);
    }
    float* const out = p.dCh + hn;
    for_each_acc(acc, Lc, N,
                 [&](int z, int n, float v) { out[z * hrow + n] = v; });
    row_dots(acc, Lc, N, Cf, part, rc);
  }
  // ---- ⟨G_c, S_c⟩: each thread's entries, then a fixed tree
  float gsum = 0.0f;
  for (long long e = tid; e < PN; e += kThreads) {
    gsum = fmaf(Gc[e], Sn[e], gsum);
  }
  red[tid] = gsum;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  // ---- dcum, its reverse cumsum ddA, ddt and the chunk's dA, in order
  if (tid == 0) {
    float dda = 0.0f;
    float da = 0.0f;
    float* const ddtg = p.ddt + (static_cast<long long>(b) * p.l + pos0) *
                                    p.H + h;
    for (int z = Lc - 1; z >= 0; --z) {
      float dcum = rc[z] - dts[z] * rx[z];
      if (z == Lc - 1) dcum += red[0];
      dda += dcum;
      ddtg[static_cast<long long>(z) * p.H] = rx[z] + dda * a;
      da = fmaf(dda, dts[z], da);
    }
    p.dA_chunks[slot] = da;
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

long long chunk_blocks(const Params& p) {
  return static_cast<long long>(p.batch) * p.H * chunks_of(p);
}

template <typename T, int TN>
cudaError_t launch_dstate(const Params& p, cudaStream_t stream) {
  return launch_blocks(ssd_bwd_dstate_kernel<T, TN>, chunk_blocks(p),
                       kDstateFloats * sizeof(float), stream, p);
}

template <typename T, int TN>
cudaError_t launch_chunk(const Params& p, cudaStream_t stream) {
  return launch_blocks(ssd_bwd_chunk_kernel<T, TN>, chunk_blocks(p),
                       kChunkFloats * sizeof(float), stream, p);
}

// the bucket of max(P, N): D = 32, 64 or 128, 16·TN columns a block
template <typename T>
cudaError_t by_bucket(int kernel, const Params& p, cudaStream_t stream) {
  const int d = p.P > p.N ? p.P : p.N;
  if (kernel == 0) {
    if (d <= 32) return launch_dstate<T, 2>(p, stream);
    if (d <= 64) return launch_dstate<T, 4>(p, stream);
    return launch_dstate<T, 8>(p, stream);
  }
  if (d <= 32) return launch_chunk<T, 2>(p, stream);
  if (d <= 64) return launch_chunk<T, 4>(p, stream);
  return launch_chunk<T, 8>(p, stream);
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

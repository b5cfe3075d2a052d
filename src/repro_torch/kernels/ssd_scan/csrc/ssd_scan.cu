// Mamba2 chunked SSD scan (state-space duality) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_scan_bhclp / _ssd_kernel
// (src/repro/kernels/ssd_scan/kernel.py:36-121).  It computes what that
// kernel computes, not its block structure.  Per (batch, head) the chunks of
// L positions are walked in order with the (P, N) float32 state S carried
// from one to the next; per chunk, with xdt = x·dt (one float32 multiply),
// dA = dt·A and cum = cumsum(dA):
//   y   = ((C·Bᵀ) ∘ Λ)·xdt + exp(cum) ∘ (C·Sᵀ),
//         Λ[z, s] = exp(cum_z − cum_s) for s ≤ z and 0 above the diagonal
//         (selected before the exp: above it the difference is positive and
//         the exp may overflow, and inf·0 would be NaN);
//   S  ← exp(cum_last)·S + xdtᵀ·(exp(cum_last − cum) ∘ B);
// y is written after each chunk, S after the last.  All arithmetic is float32
// for float32 and bfloat16 inputs alike; expf and IEEE arithmetic, no
// --use_fast_math: the kernel differs from the plain version (ref.py) only
// in summation order.
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
//   - Sizes: P, N ≤ 128 and the chunk length L ≤ 128 at run time (any L,
//     not a multiple of anything: 100 and 77 run); a ragged last chunk
//     (l % L ≠ 0) is masked, though the wrapper's contract (the
//     reference's) never gives one.
//   - Grid: one block per (32-column slice of P, head, batch).  The rows of
//     S are independent across p, so P is split over blocks: at the serving
//     path's batch of 4 that is 4 × 80 × 2 = 640 blocks on 132 SMs (80 per
//     (b, h) would leave SMs idle at batch 1).  Each slice recomputes
//     (C·Bᵀ) ∘ Λ, a third more operations at P = 64.  A loop inside the
//     block over the chunks takes the place of the TPU's sequential grid
//     axis, and S stays in shared memory between chunks.
//
// Bound on an H100 SXM at the serving path's prefill (b 4, l 256, h 80,
// p 64, n 64, L 128): the fewest operations that give y and the state are
// the recurrence's, per (b, h) and position one multiply-add per state
// entry for the update and one for C·S, 4NP: 1.34 GFLOP in all, 0.020 ms
// at 67 TFLOP/s float32; the bytes (x bf16 in, y float32 out, the states)
// are ~37 MB, 0.011 ms at 3.35 TB/s.  So it is bound by float32
// operations.  The chunked form does more of them — L(L+1)(N+P) for the
// causal triangles and 4LNP for the carried state per chunk, 2.0× the
// recurrence's at these sizes — in exchange for work that is parallel
// within a chunk.  This first version does the chunked form's operations
// as FMAs on the CUDA cores from shared-memory
// tiles.  Per chunk Bᵀ and Cᵀ (N × L, positions contiguous), xdt (L × 32)
// and Sᵀ (N × 32) are staged in shared memory (> 48 KB, so dynamic shared
// memory with cudaFuncSetAttribute: 107.5 KB at the path's sizes, two
// blocks per SM at ≤ 128 registers).  The L × L weights are built 32 rows
// at a time, each thread a 4 × 4 block from one float4 of Cᵀ and one of Bᵀ
// per state column, warps whose positions lie past the rows' diagonal block
// skipping the tile; y takes 2 × 2 blocks per thread (whole 128-byte rows
// per warp in its stores), the state 4 × 2 blocks kept in registers across
// chunks, four positions a step.  At the path's shape it runs at ~15× its
// bound (PERF.md); which stall holds it there is not measured.  One (b, h)
// walks its chunks in sequence; chunk states computed in parallel and
// scanned apart (the GPU SSD's usual split), mma.sync / wgmma on TMA-fed
// tiles are the later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 32;           // columns of P per block
constexpr int kZT = 32;           // rows of the L × L weights built at once
constexpr int kMaxL = 128;        // chunk length
constexpr int kMaxN = 128;        // d_state
constexpr int kMaxP = 128;        // head_dim
constexpr int kNR = kMaxN / 64;   // 4-row state groups per thread

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
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared-memory layout (floats; every region a multiple of 4 floats, so
// float4 reads stay 16-byte aligned).  Bᵀ and Cᵀ (N × ldt, position
// contiguous: the products read four positions at once), xdt (Lz × kPT),
// Sᵀ (N × kPT), the current rows' weights Wᵀ (Lz × kZT), cum, exp(cum_last −
// cum) and dt (Lz each); Lz is L rounded up to kZT, ldt = Lz + 4 spreads the
// transposed stores over the banks.
struct Smem {
  int ldt;
  size_t bt, ct, x, st, wt, cum, wend, dt, total;
};

__host__ __device__ inline Smem smem_layout(int L, int N) {
  Smem m;
  const int Lz = (L + kZT - 1) / kZT * kZT;
  m.ldt = Lz + 4;
  m.bt = 0;
  m.ct = m.bt + static_cast<size_t>(N) * m.ldt;
  m.x = m.ct + static_cast<size_t>(N) * m.ldt;
  m.st = m.x + static_cast<size_t>(Lz) * kPT;
  m.wt = m.st + static_cast<size_t>(N) * kPT;
  m.cum = m.wt + static_cast<size_t>(Lz) * kZT;
  m.wend = m.cum + Lz;
  m.dt = m.wend + Lz;
  m.total = (m.dt + Lz) * sizeof(float);
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const Smem m = smem_layout(p.L, p.N);
  float* Bt = smem + m.bt;
  float* Ct = smem + m.ct;
  float* Xs = smem + m.x;
  float* St = smem + m.st;
  float* Wt = smem + m.wt;
  float* cum = smem + m.cum;
  float* wend = smem + m.wend;
  float* dts = smem + m.dt;
  const int ldt = m.ldt;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int N = p.N;
  const int N8 = (N + 7) / 8 * 8;
  const int gi = h / (p.H / p.G);
  const float a = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const T* bg = static_cast<const T*>(p.B) + b * p.b_sb + gi * p.b_sg;
  const T* cg = static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const int pt = min(kPT, p.P - p0);

  // the thread's state entries Sᵀ[n][c]: rows n = 4·(sn + 16r) + i, columns
  // c = 2·sc + j; kept in registers across chunks, mirrored in St
  const int sn = tid / 16;
  const int sc = tid % 16;
  float sreg[kNR][4][2];
#pragma unroll
  for (int r = 0; r < kNR; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) sreg[r][i][0] = sreg[r][i][1] = 0.f;
  for (int i = tid; i < N * kPT; i += kThreads) St[i] = 0.f;

  const int n_chunks = (p.l + p.L - 1) / p.L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int pos0 = ci * p.L;
    const int Lc = min(p.L, p.l - pos0);
    __syncthreads();  // the previous chunk is done with every tile

    for (int s = tid; s < Lc; s += kThreads) {
      dts[s] = dtg[(pos0 + s) * p.dt_sl];
    }
    // Bᵀ, Cᵀ: a warp covers 8 consecutive n of 4 positions, so its
    // transposed stores hit 32 distinct banks when ldt ≡ 4 (mod 32)
    for (int i = tid; i < Lc * N8; i += kThreads) {
      const int n = (i / 8 / Lc) * 8 + i % 8;
      const int s = (i / 8) % Lc;
      if (n < N) {
        const long long pos = pos0 + s;
        Bt[n * ldt + s] = to_float(bg[pos * p.b_sl + n]);
        Ct[n * ldt + s] = to_float(cg[pos * p.c_sl + n]);
      }
    }
    __syncthreads();  // dts
    for (int i = tid; i < Lc * kPT; i += kThreads) {
      const int s = i / kPT, c = i % kPT;
      Xs[s * kPT + c] =
          c < pt ? to_float(xg[(pos0 + s) * p.x_sl + c]) * dts[s] : 0.f;
    }
    if (warp == 0) {
      // inclusive scan of dA = dt·A: 4 positions per lane, then the lanes
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = tid * 4 + k;
        run += s < Lc ? dts[s] * a : 0.f;
        v[k] = run;
      }
      float off = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, off, d);
        if (tid >= d) off += o;
      }
      off -= run;  // exclusive prefix of this lane
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = tid * 4 + k;
        if (s < Lc) cum[s] = off + v[k];
      }
    }
    __syncthreads();  // cum, tiles
    const float cum_last = cum[Lc - 1];
    for (int s = tid; s < Lc; s += kThreads) wend[s] = expf(cum_last - cum[s]);

    // y, kZT rows at a time
    for (int zb = 0; zb < Lc; zb += kZT) {
      const int s_hi = min(Lc, zb + kZT);
      // Wᵀ[s][z − zb] = (C·Bᵀ)[z, s] · Λ[z, s] over s < s_hi: 4 rows
      // (4·zg + i) × 4 positions (4·sg + j) a thread; warp w covers
      // positions [16w, 16w + 16) and skips the tile when they all lie past
      // the diagonal block
      if (16 * warp < s_hi) {
        const int zg = tid % 8, sg = tid / 8;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        const float* crow = Ct + zb + 4 * zg;
        const float* brow = Bt + 4 * sg;
        for (int n = 0; n < N; ++n) {
          const float4 c4 = *reinterpret_cast<const float4*>(crow + n * ldt);
          const float4 b4 = *reinterpret_cast<const float4*>(brow + n * ldt);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * sg + j;
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int z = zb + 4 * zg + i;
            // select before the exp: above the diagonal the exponent is
            // positive and may overflow
            w[i] = (s <= z && z < Lc) ? acc[i][j] * expf(cum[z] - cum[s])
                                      : 0.f;
          }
          *reinterpret_cast<float4*>(Wt + s * kZT + 4 * zg) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
      }
      __syncthreads();  // Wᵀ
      {
        // y[z][c] = (Wᵀ)ᵀ·xdt + exp(cum_z)·(C·Sᵀ): rows zb + 2·zq + i,
        // columns 2·cq + j; a warp writes 4 whole rows of 32 columns
        const int zq = tid / 16, cq = tid % 16;
        float off[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        float diag[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        const float* crow = Ct + zb + 2 * zq;
        for (int n = 0; n < N; ++n) {
          const float2 c2 = *reinterpret_cast<const float2*>(crow + n * ldt);
          const float2 s2 =
              *reinterpret_cast<const float2*>(St + n * kPT + 2 * cq);
          off[0][0] = fmaf(c2.x, s2.x, off[0][0]);
          off[0][1] = fmaf(c2.x, s2.y, off[0][1]);
          off[1][0] = fmaf(c2.y, s2.x, off[1][0]);
          off[1][1] = fmaf(c2.y, s2.y, off[1][1]);
        }
        for (int s = 0; s < s_hi; ++s) {
          const float2 w2 =
              *reinterpret_cast<const float2*>(Wt + s * kZT + 2 * zq);
          const float2 x2 =
              *reinterpret_cast<const float2*>(Xs + s * kPT + 2 * cq);
          diag[0][0] = fmaf(w2.x, x2.x, diag[0][0]);
          diag[0][1] = fmaf(w2.x, x2.y, diag[0][1]);
          diag[1][0] = fmaf(w2.y, x2.x, diag[1][0]);
          diag[1][1] = fmaf(w2.y, x2.y, diag[1][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int z = zb + 2 * zq + i;
          if (z >= Lc) continue;
          const float ez = expf(cum[z]);
          float* yrow = p.y + ((static_cast<long long>(b) * p.l + pos0 + z) *
                                   p.H + h) * p.P + p0;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = 2 * cq + j;
            if (c < pt) yrow[c] = diag[i][j] + ez * off[i][j];
          }
        }
      }
      __syncthreads();  // Wᵀ and Sᵀ are read
    }

    // S ← exp(cum_last)·S + xdtᵀ·(exp(cum_last − cum) ∘ B), as Sᵀ[n][c]
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < kNR; ++r) {
      const int n0 = 4 * (sn + 16 * r);
      if (n0 >= N) continue;
      float inc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      // four positions a step: one float4 of Bᵀ per state row
      for (int s = 0; s < Lc; s += 4) {
        float xw[4][2];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (s + k < Lc) {
            const float2 x2 =
                *reinterpret_cast<const float2*>(Xs + (s + k) * kPT + 2 * sc);
            const float w = wend[s + k];
            xw[k][0] = x2.x * w;
            xw[k][1] = x2.y * w;
          } else {
            xw[k][0] = xw[k][1] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (n0 + i >= N) continue;
          const float4 b4 =
              *reinterpret_cast<const float4*>(Bt + (n0 + i) * ldt + s);
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // past Lc the tile holds stale values: select, do not multiply
            const float bk = s + k < Lc ? bv[k] : 0.f;
            inc[i][0] = fmaf(xw[k][0], bk, inc[i][0]);
            inc[i][1] = fmaf(xw[k][1], bk, inc[i][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n0 + i >= N) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sreg[r][i][j] = inc[i][j] + decay * sreg[r][i][j];
          St[(n0 + i) * kPT + 2 * sc + j] = sreg[r][i][j];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kNR; ++r) {
    const int n0 = 4 * (sn + 16 * r);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 2 * sc + j;
      if (c >= pt) continue;
      float* srow = p.state + ((static_cast<long long>(b) * p.H + h) * p.P +
                               p0 + c) * N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (n0 + i < N) srow[n0 + i] = sreg[r][i][j];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_layout(p.L, p.N).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.P + kPT - 1) / kPT, p.H, p.batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (those of ops.py): 0 = float32, 1 = bfloat16, for x, B and C
// alike; dt and A are float32.  x (batch, l, H, P), dt (batch, l, H), B and
// C (batch, l, G, N) with the given element strides and a contiguous last
// dimension; A (H,) contiguous.  y is written contiguous float32
// (batch, l, H, P), state contiguous float32 (batch, H, P, N).  The scan
// walks chunks of L positions, the last one ragged when L does not divide l.
// Requires 1 ≤ P, N, L ≤ 128, H % G == 0, H ≤ 65535 and batch ≤ 65535.
// Launches on `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int ssd_scan_fwd(
    int dtype, const void* x, const float* dt, const float* A, const void* B,
    const void* C, float* y, float* state, int batch, int l, int H, int P,
    int G, int N, int L, long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
    long long b_sl, long long b_sg, long long c_sb, long long c_sl,
    long long c_sg, void* stream) {
  if (batch <= 0 || batch > 65535 || l <= 0 || H <= 0 || H > 65535 ||
      G <= 0 || H % G != 0 || P <= 0 || P > kMaxP || N <= 0 || N > kMaxN ||
      L <= 0 || L > kMaxL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{x,    dt,   A,    B,    C,     y,     state, batch, l,    H,
           P,    G,    N,    L,    x_sb,  x_sl,  x_sh,  dt_sb, dt_sl, dt_sh,
           b_sb, b_sl, b_sg, c_sb, c_sl,  c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, causal (+ sliding-window) attention with GQA read in place.
//
// Replaces the Pallas TPU kernels of flash_attention_bwd_bhsd
// (src/repro/kernels/flash_attention/backward.py): _dq_kernel (the
// pallas_call at line 150) and _dkv_kernel (line 178).  They compute what
// those kernels compute, not their block structure:
//   s  = (q · scale) · kᵀ in float32 (q scaled first, one rounding, as the
//        forward kernel's float32 instance does);
//   p  = exp(s − lse) where key kp is visible from query qp (kp ≤ qp when
//        causal, kp > qp − window when window > 0, both < their lengths),
//        exactly 0 elsewhere — lse is the forward's, m + log(max(l, 1e-30)),
//        so a row with no visible key has p = 0 and o = 0;
//   dp = do · vᵀ;  ds = p ∘ (dp − δ), δ = rowsum(do ∘ o) precomputed by the
//        wrapper (ops.py), as the reference precomputes it in jnp;
//   dq = scale · Σ_kv ds · k;  dv = Σ_q pᵀ · do;  dk = Σ_q dsᵀ · (q · scale),
//        dk and dv summed over the g query heads of each kv head.
// expf and IEEE arithmetic, no --use_fast_math: the kernels differ from
// the plain version (ref.attention_bwd) only in summation order.
//
// Where they differ from the TPU kernels, and why:
//   - Layout: q, k, v and do are read in the model layout (B, S, H, D)
//     through their strides (last dimension contiguous); dq, dk and dv are
//     written contiguous in the same layout.  The TPU wrapper transposed to
//     (B, H, S, D) and padded head dims to 128; here Dqk and Dv are separate
//     (each ≤ 256) and the scale is an argument.
//   - Ragged lengths: any Sq, Skv ≥ 1, tails masked in the kernels (the TPU
//     kernels asserted S % block == 0).
//   - The TPU's sequential grid axes become loops inside a block.  dq: one
//     block per (q tile, head, batch), looping over the kv tiles of its
//     causal / window band only.  dk/dv with one query head per kv head
//     (g = 1): one block per (kv tile, head, batch), looping over the q
//     tiles of its band, with both accumulators in registers.  With g > 1
//     (GQA, MQA) the group is split over blocks: one block per (kv tile,
//     query head, batch) writes its head's float32 partial dk and dv to a
//     workspace the caller provides, and a second kernel sums the g
//     partials of each element in head order and casts.  No atomics: every
//     output element is summed by one thread in a fixed order, so the
//     result is deterministic.
//
// Bound on an H100 SXM: at the training path's shape (gemma-2b, B·M = 4,
// S = 128, 8 heads, 1 kv head, D = 256) the bytes — q, k, v, do, o, lse
// read once and dq, dk, dv written once — against ~10·D operations per
// visible (q, kv) pair and head (the two score products, dq, dk, dv: 2·D
// each); at long S the operations.  These first versions are neither: they
// are simple, correct kernels on the CUDA cores.  Tiles of q, do, k and v
// are staged in shared memory as float32 with rows padded to D + 1 (the
// score loops' column reads hit distinct banks), > 48 KB, so dynamic shared
// memory raised with cudaFuncSetAttribute.  Tile heights are picked per
// head dim (a template): 64 × 64 up to D = 128, 32 × 32 at D = 256, where
// four float32 tiles of 257-float rows fill ~136-140 KB.  256 threads as a
// 16 × 16 grid each own rows ty + 16a and columns tx + 16c of the score
// tile and of the accumulators.  All products are float32 FMAs for float32
// and bfloat16 inputs alike; mma.sync / wgmma with TMA-fed tiles is the
// later work.  The group split is for MQA: at gemma-2b's shape (Hkv = 1,
// g = 8) one block per kv head would give 16 blocks on 132 SMs, each
// reducing 8 heads × all q tiles of its band in sequence; split, 128
// blocks of at most 4 q tiles each, and the partials add 2 · B·H·Skv·D
// float32 of workspace traffic (8 MB at that shape).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // a 16 × 16 grid

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;                           // (B, H, Sq) contiguous
  const float* delta;                         // (B, H, Sq) contiguous
  void* out0;                                 // dq, or dk
  void* out1;                                 // unused, or dv
  float* ws;                                  // dk/dv with g > 1: the
                                              // (B, H, Skv, Dqk) partial
                                              // dk, then (B, H, Skv, Dv) dv
  int B, H, Hkv, Sq, Skv, Dqk, Dv;
  long long q_sb, q_ss, q_sh;                 // element strides: batch,
  long long k_sb, k_ss, k_sh;                 // position, head
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int causal, window;
  float scale;
};

// Tile heights per head-dim bucket (max(Dqk, Dv) ≤ DMAX): query rows BQ
// and key rows BK, both multiples of 16.
template <int DMAX>
struct Tiles {
  static constexpr int BQ = DMAX <= 128 ? 64 : 32;
  static constexpr int BK = DMAX <= 128 ? 64 : 32;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(int qp, int kp, const Params& p) {
  return qp < p.Sq && kp < p.Skv && (!p.causal || kp <= qp) &&
         (p.window <= 0 || kp > qp - p.window);
}

// rows [r0, r0 + rows) of one head of a (B, S, H, d) tensor whose head
// base is `src` and position stride `ss`, into dst[rows][ld] as float32
// times `mul` (1 is exact); rows at or past n are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long ss, int r0, int rows,
                                          int n, int d, float mul) {
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    const int i = idx / d;
    const int c = idx - i * d;
    const int r = r0 + i;
    dst[i * ld + c] =
        r < n ? __fmul_rn(to_float(src[r * ss + c]), mul) : 0.0f;
  }
}

// lse and δ of rows [q0, q0 + rows) of head h, 0 past Sq
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const Params& p, int b, int h,
                                          int q0, int rows) {
  const long long base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const int qp = q0 + i;
    lse_s[i] = qp < p.Sq ? p.lse[base + qp] : 0.0f;
    delta_s[i] = qp < p.Sq ? p.delta[base + qp] : 0.0f;
  }
}

template <int DMAX>
size_t dq_smem_bytes(int dqk, int dv) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  const size_t floats = static_cast<size_t>(BQ + BK) * (dqk + 1)  // q, k
                        + static_cast<size_t>(BQ + BK) * (dv + 1) // do, v
                        + static_cast<size_t>(BQ) * (BK + 1)      // ds
                        + 2 * BQ;                                 // lse, δ
  return floats * sizeof(float);
}

template <int DMAX>
size_t dkv_smem_bytes(int dqk, int dv) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  const size_t floats = static_cast<size_t>(BQ + BK) * (dqk + 1)  // q, k
                        + static_cast<size_t>(BQ + BK) * (dv + 1) // do, v
                        + 2 * static_cast<size_t>(BK) * (BQ + 1)  // pᵀ, dsᵀ
                        + 2 * BQ;                                 // lse, δ
  return floats * sizeof(float);
}

// dq: one block per (q tile, head, batch)
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  constexpr int RA = BQ / 16;                 // query rows per thread
  constexpr int CS = BK / 16;                 // score columns per thread
  constexpr int CD = DMAX / 16;               // dq columns per thread
  extern __shared__ float smem[];
  const int D = p.Dqk;
  const int Dv = p.Dv;
  const int ldq = D + 1;
  const int ldv = Dv + 1;
  float* qs = smem;                           // [BQ][ldq], scaled
  float* dos = qs + BQ * ldq;                 // [BQ][ldv]
  float* ks = dos + BQ * ldv;                 // [BK][ldq]
  float* vs = ks + BK * ldq;                  // [BK][ldv]
  float* dss = vs + BK * ldv;                 // [BQ][BK + 1]
  float* lse_s = dss + BQ * (BK + 1);
  float* delta_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_tile(qs, ldq, q, p.q_ss, q0, BQ, p.Sq, D, p.scale);
  load_tile(dos, ldv, dout, p.do_ss, q0, BQ, p.Sq, Dv, 1.0f);
  load_rows(lse_s, delta_s, p, b, h, q0, BQ);

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[a][c] = 0.0f;
  }

  // the kv tiles that meet this q tile's band
  const int n_tiles = (p.Skv + BK - 1) / BK;
  int t_end = n_tiles;
  if (p.causal) t_end = min(t_end, (q0 + BQ - 1) / BK + 1);
  int t_begin = 0;
  if (p.window > 0) {
    const int lo = q0 - p.window + 1;         // first key row q0 sees
    if (lo > 0) t_begin = lo / BK;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                          // the last tile's readers
    load_tile(ks, ldq, k, p.k_ss, k0, BK, p.Skv, D, 1.0f);
    load_tile(vs, ldv, v, p.v_ss, k0, BK, p.Skv, Dv, 1.0f);
    __syncthreads();

    float s[RA][CS], dp[RA][CS];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int c = 0; c < CS; ++c) s[a][c] = dp[a][c] = 0.0f;
    }
    for (int d = 0; d < D; ++d) {
      float qa[RA], kc[CS];
#pragma unroll
      for (int a = 0; a < RA; ++a) qa[a] = qs[(ty + 16 * a) * ldq + d];
#pragma unroll
      for (int c = 0; c < CS; ++c) kc[c] = ks[(tx + 16 * c) * ldq + d];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
#pragma unroll
        for (int c = 0; c < CS; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
      }
    }
    for (int d = 0; d < Dv; ++d) {
      float da[RA], vc[CS];
#pragma unroll
      for (int a = 0; a < RA; ++a) da[a] = dos[(ty + 16 * a) * ldv + d];
#pragma unroll
      for (int c = 0; c < CS; ++c) vc[c] = vs[(tx + 16 * c) * ldv + d];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
#pragma unroll
        for (int c = 0; c < CS; ++c) dp[a][c] = fmaf(da[a], vc[c], dp[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const int j = tx + 16 * c;
        const float pv =
            visible(q0 + i, k0 + j, p) ? expf(s[a][c] - lse_s[i]) : 0.0f;
        dss[i * (BK + 1) + j] = pv * (dp[a][c] - delta_s[i]);
      }
    }
    __syncthreads();

    // acc += ds · k
    for (int j = 0; j < BK; ++j) {
      float dsa[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) dsa[a] = dss[(ty + 16 * a) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float kv = ks[j * ldq + col];
#pragma unroll
          for (int a = 0; a < RA; ++a) acc[a][c] = fmaf(dsa[a], kv, acc[a][c]);
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.out0);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int qp = q0 + ty + 16 * a;
    if (qp >= p.Sq) continue;
    T* row = dq + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (col < D) row[col] = from_float<T>(__fmul_rn(acc[a][c], p.scale));
    }
  }
}

// dk, dv: one block per (kv tile, kv head, batch) summing its g query heads;
// or, with a workspace, one block per (kv tile, query head, batch) writing
// that head's float32 partials there
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Params p) {
  constexpr int BQ = Tiles<DMAX>::BQ, BK = Tiles<DMAX>::BK;
  constexpr int RA = BK / 16;                 // key rows per thread
  constexpr int CS = BQ / 16;                 // score columns per thread
  constexpr int CD = DMAX / 16;               // dk / dv columns per thread
  extern __shared__ float smem[];
  const int D = p.Dqk;
  const int Dv = p.Dv;
  const int ldq = D + 1;
  const int ldv = Dv + 1;
  float* ks = smem;                           // [BK][ldq]
  float* vs = ks + BK * ldq;                  // [BK][ldv]
  float* qs = vs + BK * ldv;                  // [BQ][ldq], scaled
  float* dos = qs + BQ * ldq;                 // [BQ][ldv]
  float* pt = dos + BQ * ldv;                 // [BK][BQ + 1]: pᵀ
  float* dst = pt + BK * (BQ + 1);            // [BK][BQ + 1]: dsᵀ
  float* lse_s = dst + BK * (BQ + 1);
  float* delta_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.z;
  const int g = p.H / p.Hkv;
  const bool split = p.ws != nullptr;
  const int hk = split ? blockIdx.y / g : blockIdx.y;
  const int h_begin = split ? blockIdx.y : hk * g;
  const int h_end = split ? h_begin + 1 : h_begin + g;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile(ks, ldq, k, p.k_ss, k0, BK, p.Skv, D, 1.0f);
  load_tile(vs, ldv, v, p.v_ss, k0, BK, p.Skv, Dv, 1.0f);

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float dk_acc[RA][CD], dv_acc[RA][CD];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;
  }

  // the q tiles that meet this kv tile's band
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int qt_begin = p.causal ? min(k0 / BQ, n_q) : 0;
  int qt_end = n_q;
  if (p.window > 0) {
    // the last query row that sees key k0 + BK − 1
    const long long last = static_cast<long long>(k0) + BK - 1 + p.window - 1;
    const long long end = last / BQ + 1;
    qt_end = end < n_q ? static_cast<int>(end) : n_q;
  }

  for (int hq = h_begin; hq < h_end; ++hq) {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + hq * p.q_sh;
    const T* dout =
        static_cast<const T*>(p.dout) + b * p.do_sb + hq * p.do_sh;
    for (int t = qt_begin; t < qt_end; ++t) {
      const int q0 = t * BQ;
      __syncthreads();                        // the last tile's readers
      load_tile(qs, ldq, q, p.q_ss, q0, BQ, p.Sq, D, p.scale);
      load_tile(dos, ldv, dout, p.do_ss, q0, BQ, p.Sq, Dv, 1.0f);
      load_rows(lse_s, delta_s, p, b, hq, q0, BQ);
      __syncthreads();

      // sᵀ and dpᵀ: rows are keys, columns queries
      float s[RA][CS], dp[RA][CS];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
#pragma unroll
        for (int c = 0; c < CS; ++c) s[a][c] = dp[a][c] = 0.0f;
      }
      for (int d = 0; d < D; ++d) {
        float ka[RA], qc[CS];
#pragma unroll
        for (int a = 0; a < RA; ++a) ka[a] = ks[(ty + 16 * a) * ldq + d];
#pragma unroll
        for (int c = 0; c < CS; ++c) qc[c] = qs[(tx + 16 * c) * ldq + d];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
#pragma unroll
          for (int c = 0; c < CS; ++c) s[a][c] = fmaf(qc[c], ka[a], s[a][c]);
        }
      }
      for (int d = 0; d < Dv; ++d) {
        float va[RA], dc[CS];
#pragma unroll
        for (int a = 0; a < RA; ++a) va[a] = vs[(ty + 16 * a) * ldv + d];
#pragma unroll
        for (int c = 0; c < CS; ++c) dc[c] = dos[(tx + 16 * c) * ldv + d];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
#pragma unroll
          for (int c = 0; c < CS; ++c) dp[a][c] = fmaf(dc[c], va[a], dp[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int j = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < CS; ++c) {
          const int i = tx + 16 * c;
          const float pv =
              visible(q0 + i, k0 + j, p) ? expf(s[a][c] - lse_s[i]) : 0.0f;
          pt[j * (BQ + 1) + i] = pv;
          dst[j * (BQ + 1) + i] = pv * (dp[a][c] - delta_s[i]);
        }
      }
      __syncthreads();

      // dv += pᵀ · do;  dk += dsᵀ · (q · scale)
      for (int i = 0; i < BQ; ++i) {
        float pa[RA], da[RA];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          pa[a] = pt[(ty + 16 * a) * (BQ + 1) + i];
          da[a] = dst[(ty + 16 * a) * (BQ + 1) + i];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          const int col = tx + 16 * c;
          if (col < Dv) {
            const float dov = dos[i * ldv + col];
#pragma unroll
            for (int a = 0; a < RA; ++a)
              dv_acc[a][c] = fmaf(pa[a], dov, dv_acc[a][c]);
          }
          if (col < D) {
            const float qv = qs[i * ldq + col];
#pragma unroll
            for (int a = 0; a < RA; ++a)
              dk_acc[a][c] = fmaf(da[a], qv, dk_acc[a][c]);
          }
        }
      }
    }
  }

  if (split) {
    float* wk = p.ws;
    float* wv = p.ws + static_cast<long long>(p.B) * p.H * p.Skv * D;
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int kp = k0 + ty + 16 * a;
      if (kp >= p.Skv) continue;
      const long long row =
          (static_cast<long long>(b) * p.H + h_begin) * p.Skv + kp;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int col = tx + 16 * c;
        if (col < D) wk[row * D + col] = dk_acc[a][c];
        if (col < Dv) wv[row * Dv + col] = dv_acc[a][c];
      }
    }
    return;
  }
  T* dk = static_cast<T*>(p.out0);
  T* dv = static_cast<T*>(p.out1);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int kp = k0 + ty + 16 * a;
    if (kp >= p.Skv) continue;
    const long long row = (static_cast<long long>(b) * p.Skv + kp) * p.Hkv + hk;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dk[row * D + col] = from_float<T>(dk_acc[a][c]);
      if (col < Dv) dv[row * Dv + col] = from_float<T>(dv_acc[a][c]);
    }
  }
}

// dk and dv from the split dk/dv kernel's partials: each element of the
// contiguous (B, Skv, Hkv, Dqk) dk, then of the (B, Skv, Hkv, Dv) dv, is
// the sum of its g query heads' partials in head order, cast once
template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_reduce_kernel(Params p) {
  const int g = p.H / p.Hkv;
  const long long nk = static_cast<long long>(p.B) * p.Skv * p.Hkv * p.Dqk;
  const long long nv = static_cast<long long>(p.B) * p.Skv * p.Hkv * p.Dv;
  const float* wk = p.ws;
  const float* wv = p.ws + static_cast<long long>(p.B) * p.H * p.Skv * p.Dqk;
  T* dk = static_cast<T*>(p.out0);
  T* dv = static_cast<T*>(p.out1);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < nk + nv; e += stride) {
    const bool is_v = e >= nk;
    const long long i = is_v ? e - nk : e;
    const int d = is_v ? p.Dv : p.Dqk;
    const int col = static_cast<int>(i % d);
    long long r = i / d;
    const int hk = static_cast<int>(r % p.Hkv);
    r /= p.Hkv;
    const int kp = static_cast<int>(r % p.Skv);
    const long long b = r / p.Skv;
    const float* w = (is_v ? wv : wk) +
                     ((b * p.H + static_cast<long long>(hk) * g) * p.Skv +
                      kp) * d + col;
    const long long head_stride = static_cast<long long>(p.Skv) * d;
    float sum = 0.0f;
    for (int j = 0; j < g; ++j) sum += w[j * head_stride];
    (is_v ? dv : dk)[i] = from_float<T>(sum);
  }
}

template <typename T, int DMAX>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<DMAX>(p.Dqk, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + Tiles<DMAX>::BQ - 1) / Tiles<DMAX>::BQ, p.H, p.B);
  dq_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<DMAX>(p.Dqk, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool split = p.ws != nullptr;
  const dim3 grid((p.Skv + Tiles<DMAX>::BK - 1) / Tiles<DMAX>::BK,
                  split ? p.H : p.Hkv, p.B);
  dkv_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  if (!split) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n =
      static_cast<long long>(p.B) * p.Skv * p.Hkv * (p.Dqk + p.Dv);
  const long long blocks = (n + kThreads - 1) / kThreads;
  dkv_reduce_kernel<T><<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192),
                         kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(bool dkv, const Params& p, cudaStream_t stream) {
  const int dmax = p.Dqk > p.Dv ? p.Dqk : p.Dv;
  if (dmax <= 64) {
    return dkv ? launch_dkv<T, 64>(p, stream) : launch_dq<T, 64>(p, stream);
  }
  if (dmax <= 128) {
    return dkv ? launch_dkv<T, 128>(p, stream)
               : launch_dq<T, 128>(p, stream);
  }
  return dkv ? launch_dkv<T, 256>(p, stream) : launch_dq<T, 256>(p, stream);
}

int run(bool dkv, int dtype, const Params& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 || p.Sq <= 0 ||
      p.Skv <= 0 || p.Dqk <= 0 || p.Dqk > 256 || p.Dv <= 0 || p.Dv > 256 ||
      p.out0 == nullptr || (dkv && p.out1 == nullptr) ||
      (dkv && p.H != p.Hkv && p.ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(dkv, p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(dkv, p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes (those of ops.py): 0 = float32, 1 = bfloat16.  q, k, v and do
// in the model layout with the given element strides of (batch, position,
// head) and a contiguous last dimension; lse and delta contiguous float32
// (B, H, Sq).  flash_attention_bwd_dq writes dq contiguous (B, Sq, H, Dqk)
// to out0 (out1 and ws are not read); flash_attention_bwd_dkv writes dk
// contiguous (B, Skv, Hkv, Dqk) to out0 and dv (B, Skv, Hkv, Dv) to out1,
// and when H > Hkv needs `ws`, float32 scratch of B·H·Skv·(Dqk + Dv)
// elements (null when H == Hkv: it is then not used).  Requires
// 1 ≤ Dqk, Dv ≤ 256, H % Hkv == 0, B ≤ 65535 and H ≤ 65535.  Each launches
// on `stream` (dk/dv with a workspace: its two kernels, in order), does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launch (0 = success).
#define BWD_ENTRY(NAME, DKV)                                                 \
  extern "C" int NAME(                                                       \
      int dtype, const void* q, const void* k, const void* v,                \
      const void* dout, const float* lse, const float* delta, void* out0,    \
      void* out1, float* ws, int B, int H, int Hkv, int Sq, int Skv,         \
      int Dqk, int Dv,                                                       \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,        \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,     \
      int causal, int window, float scale, void* stream) {                   \
    const Params p{q,     k,     v,     dout,  lse,   delta, out0,  out1,    \
                   ws,    B,     H,     Hkv,   Sq,    Skv,   Dqk,   Dv,      \
                   q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,    \
                   v_sh,  do_sb, do_ss, do_sh, causal, window, scale};       \
    return run(DKV, dtype, p, stream);                                       \
  }

BWD_ENTRY(flash_attention_bwd_dq, false)
BWD_ENTRY(flash_attention_bwd_dkv, true)

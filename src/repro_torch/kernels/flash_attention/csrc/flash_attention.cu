// Flash-attention forward for Hopper (sm_90a): causal (+ sliding-window)
// attention with a blocked online softmax, GQA read in place.
//
// Replaces the Pallas TPU kernel flash_attention_fwd_bhsd / _attn_kernel
// (src/repro/kernels/flash_attention/kernel.py:31-139).  It computes what
// that kernel computes, not its block structure:
//   s   = (q · scale) · kᵀ in float32 (q scaled first, one rounding);
//   key kp is visible from query qp when kp ≤ qp (causal) and
//   kp > qp − window (window > 0), positions counted from 0;
//   hidden scores are NEG_INF = −2³⁰ in the running max and weigh exactly 0;
//   m, l: running max and denominator; o = acc / max(l, 1e-30) cast to q's
//   type; lse = m + log(max(l, 1e-30)) in float32.
// expf / logf and IEEE division, no --use_fast_math: the kernel differs from
// the plain version (ref.py) only in summation order.
//
// Where it differs from the TPU kernel, and why:
//   - Layout: q/k/v are read in the model layout (B, S, H, D) through their
//     strides (last dimension contiguous); the TPU wrapper transposed to
//     (B, H, S, D), four copies per call.  o is written contiguous
//     (B, Sq, H, Dv), lse contiguous (B, H, Sq).
//   - Head dims: Dqk and Dv are separate (each ≤ 256) and the scale is an
//     argument, so no lane padding to 128 is needed (the TPU's _pad_scale).
//   - Ragged lengths: Sq and Skv may be any length ≥ 1; the kernel masks
//     the tails itself (the TPU kernel asserted Sq % block_q == 0).
//   - Grid: one block per (q tile, head, batch); a loop inside the block
//     over the kv tiles takes the place of the TPU's sequential grid axis,
//     and covers only the tiles that meet the causal / window band (the
//     TPU kernel's ~2× saving for causal).
//   - GQA: kv head h / (H / Hkv), read in place; K/V are never repeated.
//
// Bound on an H100 SXM: at the serving path's prefill (S ≤ 256, llama3-8b:
// 32 heads, 8 kv heads, D 128) the bytes — q, k, v read once, o and lse
// written once, 5.3 MB in bf16, 1.6 µs at 3.35 TB/s — against 0.5 µs of
// bf16 tensor-core work; at long S the operations (4·D per visible (q, kv)
// pair and head: 1.4e11 at S = 4096, 0.14 ms at 989 TFLOP/s bf16, 2.05 ms at
// 67 TFLOP/s f32).  This first version is neither: it is a simple, correct
// kernel on the CUDA cores.  A 64-row q tile (pre-scaled, float32) and each
// 64-key K/V tile are staged in shared memory (rows padded to D + 1 floats
// so the score loop's column reads hit distinct banks; > 48 KB, so dynamic
// shared memory with cudaFuncSetAttribute); 256 threads each own a 4 × 4
// block of the 64 × 64 score tile and a 4 × (Dv / 16) block of the output
// accumulator in registers; one warp per 8 rows runs the online softmax
// with shuffles.  Both products are float32 FMAs for float32 and bfloat16
// inputs alike, so time is bound by shared-memory reads and FMA issue, far
// from either bound.  mma.sync / wgmma with TMA-fed tiles and warp
// specialisation are the later work that closes the gap.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                       // query rows per block
constexpr int kBK = 64;                       // keys per kv tile
constexpr int kThreads = 256;
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);
constexpr float kNegInf = -1073741824.0f;     // −2³⁰, the reference's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Hkv, Sq, Skv, Dqk, Dv;
  long long q_sb, q_ss, q_sh;                 // element strides: batch,
  long long k_sb, k_ss, k_sh;                 // position, head
  long long v_sb, v_ss, v_sh;
  int causal, window;
  float scale;
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
  return kp < p.Skv && (!p.causal || kp <= qp) &&
         (p.window <= 0 || kp > qp - p.window);
}

size_t smem_bytes(int dqk, int dv) {
  const size_t floats = static_cast<size_t>(kBQ) * (dqk + 1)   // q tile
                        + static_cast<size_t>(kBK) * (dqk + 1) // k tile
                        + static_cast<size_t>(kBK) * dv        // v tile
                        + static_cast<size_t>(kBQ) * (kBK + 1) // scores
                        + 3 * kBQ;                             // m, l, alpha
  return floats * sizeof(float);
}

// DV_MAX: the output accumulator's width in registers (Dv ≤ DV_MAX).
template <typename T, int DV_MAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.Dqk;
  const int Dv = p.Dv;
  const int ldq = D + 1;
  float* qs = smem;                           // [kBQ][ldq], scaled
  float* ks = qs + kBQ * ldq;                 // [kBK][ldq]
  float* vs = ks + kBK * ldq;                 // [kBK][Dv]
  float* ss = vs + kBK * Dv;                  // [kBQ][kBK + 1]
  float* row_m = ss + kBQ * (kBK + 1);
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    const int qp = q0 + i;
    qs[i * ldq + d] =
        qp < p.Sq ? __fmul_rn(to_float(q[qp * p.q_ss + d]), p.scale) : 0.0f;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    row_m[i] = kNegInf;
    row_l[i] = 0.0f;
  }

  // thread (ty, tx) owns score rows ty + 16a and columns tx + 16c, and
  // output rows ty + 16a, columns tx + 16c
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int NB = DV_MAX / 16;
  float acc[4][NB];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < NB; ++c) acc[a][c] = 0.0f;
  }

  // the kv tiles that meet this q tile's band
  const int n_tiles = (p.Skv + kBK - 1) / kBK;
  int t_end = n_tiles;
  if (p.causal) t_end = min(t_end, (q0 + kBQ - 1) / kBK + 1);
  int t_begin = 0;
  if (p.window > 0) {
    const int lo = q0 - p.window + 1;         // first key row q0 sees
    if (lo > 0) t_begin = lo / kBK;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                          // the last tile's readers
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kp = k0 + j;
      ks[j * ldq + d] = kp < p.Skv ? to_float(k[kp * p.k_ss + d]) : 0.0f;
    }
    for (int idx = tid; idx < kBK * Dv; idx += kThreads) {
      const int j = idx / Dv;
      const int d = idx - j * Dv;
      const int kp = k0 + j;
      vs[j * Dv + d] = kp < p.Skv ? to_float(v[kp * p.v_ss + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
    }
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * ldq + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = ks[(tx + 16 * c) * ldq + d];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * a;
        const int j = tx + 16 * c;
        ss[i * (kBK + 1) + j] =
            visible(q0 + i, k0 + j, p) ? s[a][c] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows [w·8, w·8 + 8), lane the columns
    // lane and lane + 32; p is written over the scores
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp * kRowsPerWarp + r;
      const int qp = q0 + i;
      float* srow = ss + i * (kBK + 1);
      const float s0 = srow[lane];
      const float s1 = srow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = row_m[i];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = visible(qp, k0 + lane, p) ? expf(s0 - m_new) : 0.0f;
      const float p1 =
          visible(qp, k0 + lane + 32, p) ? expf(s1 - m_new) : 0.0f;
      srow[lane] = p0;
      srow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[i] = alpha;
        row_m[i] = m_new;
        row_l[i] = alpha * row_l[i] + sum;
      }
    }
    __syncthreads();

    // acc ← alpha · acc + p · v
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float alpha = row_a[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < NB; ++c) acc[a][c] *= alpha;
    }
    for (int j = 0; j < kBK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ss[(ty + 16 * a) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const int col = tx + 16 * c;
        if (col < Dv) {
          const float vv = vs[j * Dv + col];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
        }
      }
    }
  }
  // row_m / row_l were last written before the final __syncthreads

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    const int qp = q0 + i;
    if (qp >= p.Sq) continue;
    const float l = fmaxf(row_l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * Dv;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv) orow[col] = from_float<T>(acc[a][c] / l);
    }
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    const int qp = q0 + i;
    if (qp < p.Sq) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] =
          row_m[i] + logf(fmaxf(row_l[i], 1e-30f));
    }
  }
}

template <typename T, int DV_MAX>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Dqk, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DV_MAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<T, DV_MAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dv(const Params& p, cudaStream_t stream) {
  if (p.Dv <= 64) return launch<T, 64>(p, stream);
  if (p.Dv <= 128) return launch<T, 128>(p, stream);
  return launch<T, 256>(p, stream);
}

}  // namespace

// dtype codes (those of ops.py): 0 = float32, 1 = bfloat16.  q, k, v in
// the model layout with the given element strides of (batch, position,
// head) and a contiguous last dimension; o is written contiguous
// (B, Sq, H, Dv), lse contiguous float32 (B, H, Sq).  Requires
// 1 ≤ Dqk, Dv ≤ 256, H % Hkv == 0, B ≤ 65535 and H ≤ 65535.  Launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o,
    float* lse, int B, int H, int Hkv, int Sq, int Skv, int Dqk, int Dv,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      Dqk <= 0 || Dqk > 256 || Dv <= 0 || Dv > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,    k,    v,    o,    lse,  B,    H,    Hkv,    Sq,     Skv,
           Dqk,  Dv,   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,
           v_sh, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_dv<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch_dv<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

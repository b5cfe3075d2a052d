// Flash-attention forward for Hopper (sm_90a): causal (+ sliding-window)
// attention with a blocked online softmax, GQA read in place.
//
// Replaces the Pallas TPU kernel flash_attention_fwd_bhsd / _attn_kernel
// (src/repro/kernels/flash_attention/kernel.py:31-139).  It computes what
// that kernel computes, not its block structure:
//   s   = scale · q · kᵀ in float32 (where the scale is applied: below);
//   key kp is visible from query qp when kp ≤ qp (causal) and
//   kp > qp − window (window > 0), positions counted from 0;
//   hidden scores are NEG_INF = −2³⁰ in the running max and weigh exactly 0;
//   m, l: running max and denominator; o = acc / max(l, 1e-30) cast to q's
//   type; lse = m + log(max(l, 1e-30)) in float32.
// expf / logf and IEEE division, no --use_fast_math: the kernel differs from
// the plain version (ref.py) only in summation order, and, in the bfloat16
// instance, in two roundings named below.
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
//   - Grid: a loop inside the block over the kv tiles takes the place of
//     the TPU's sequential grid axis, and covers only the tiles that meet
//     the causal / window band (the TPU kernel's ~2× saving for causal).
//   - GQA: kv head h / (H / Hkv), read in place; K/V are never repeated.
//
// Bound on an H100 SXM: at the serving path's prefill (S ≤ 256, llama3-8b:
// 32 heads, 8 kv heads, D 128) the bytes — q, k, v read once, o and lse
// written once, 5.3 MB in bf16, 1.6 µs at 3.35 TB/s — against 0.5 µs of
// bf16 tensor-core work; at long S the operations (4·D per visible (q, kv)
// pair and head: 1.4e11 at S = 4096, 0.14 ms at 989 TFLOP/s bf16, 2.05 ms at
// 67 TFLOP/s f32).
//
// The bfloat16 instance (flash_fwd_kernel_mma) runs both products on the
// tensor cores (its tile machinery, shared with the backward's bfloat16
// kernels, is in mma_tiles.cuh):
//   - S = Q·Kᵀ and O += P·V are mma.sync m16n8k16 bf16 → f32.  Each of the
//     4 warps owns 16 query rows of a 64-row q tile; Q's fragments stay in
//     registers (Dqk, Dv ≤ 128) or are read from shared memory at each kv
//     tile (≤ 256, where the 16 × 256 float32 O accumulator alone takes 128
//     registers a thread).  Scores, the row max m, the row sum l and the
//     rescale α live in the accumulator fragments' registers: a row is
//     spread over 4 lanes, reduced with two xor shuffles; l is summed per
//     lane and across the 4 lanes once, at the end.  Scores never touch
//     shared memory.
//   - The head dim is a template bucket D = 64, 80, 128 or 256 (Dqk and
//     Dv zero-filled up to it), so every loop over it unrolls with no
//     runtime bound: runtime bounds cut the loops into basic blocks that
//     ptxas does not schedule across (27% of the time at S = 4096).
//   - Operands come from shared memory through ldmatrix (.trans for V).
//     Q, K and V are stored as bf16 in rows of 64, 128 or 256 elements,
//     whose 16-byte chunks are XOR-swizzled with the row (chunk ^ row % 8),
//     so the 8 rows an ldmatrix phase reads hit 8 distinct bank groups.
//   - K and V tiles (64 keys; 32 at D = 256) sit in a two-stage ring filled
//     with cp.async: tile j + 1 loads while tile j computes, waited on with
//     cp.async.wait_group.  The copy width W is a template argument chosen
//     by the wrapper: 16 bytes a thread where every row starts on a 16-byte
//     boundary, else 8 or 4, else 2 (a plain load and store: a head dim of
//     77 in bf16 puts odd heads on 2-byte boundaries).  Chunks past the
//     head dim or the last row are stored as zeros, a head dim's tail
//     inside a chunk is copied two bytes at a time.
//   - Tiles outside the causal / window band are skipped; the mask is
//     applied only on tiles that cross the diagonal, the window's edge or
//     Skv.  A 1-d grid walks the q tiles from the last (the heaviest under
//     a causal mask) to the first, each over all (batch, head) pairs, so
//     the short tiles fill the tail on 132 SMs.
//   - No packing of the g query heads of one kv head into a block: at the
//     serving prefill (S = 256, 32 heads) a 64-row tile gives 128 blocks,
//     one per SM; packing g = 4 heads would leave 32 blocks for 132 SMs,
//     and the repeated K/V reads it saves come from L2.
//   - Numerics.  The two roundings where it departs from the plain version
//     besides the order of sums: (1) the scale is applied to the score,
//     s = scale · (q·k) — bf16 × bf16 products are exact in float32, so
//     this differs from the reference's (q·scale)·k by an ulp-level
//     rounding of s, where a bf16 q·scale would round q a second time;
//     (2) P is split into three bf16 pieces, p_hi = bf16(p),
//     p_mid = bf16(p − p_hi), p_lo = bf16(p − p_hi − p_mid) (each
//     subtraction exact), and O += p_hi·V + p_mid·V + p_lo·V in one float32
//     accumulator (bf16 × bf16 products are exact), so each weight carries
//     at most 2⁻²⁴ relative error, a float32 rounding (l is summed from the
//     float32 p).  A single bf16 P carries 2⁻⁸, two pieces 2⁻¹⁶: on the
//     card two pieces put outputs near zero of rows with few keys (|o| ~
//     1e-5 from terms ~1) 2.6e-6 off, beyond the 1e-6 floor of the bf16
//     tolerance.  Three pieces triple the P·V product's tensor-core work:
//     8·D operations per visible pair instead of 4·D.
//
// The float32 instance (flash_fwd_kernel) is the first, SIMT design: a
// 64-row q tile (pre-scaled, float32) and each 64-key K/V tile are staged
// in shared memory (rows padded to D + 1 floats so the score loop's column
// reads hit distinct banks); 256 threads each own a 4 × 4 block of the
// 64 × 64 score tile and a 4 × (Dv / 16) block of the output accumulator
// in registers; one warp per 8 rows runs the online softmax with shuffles;
// both products are float32 FMAs.  It scales q first, as the reference
// does.  A 3×TF32 tensor-core route for it is queued (ROADMAP).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"

namespace {

using namespace fa_tiles;

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

__device__ __forceinline__ bool visible(int qp, int kp, const Params& p) {
  return kp < p.Skv && (!p.causal || kp <= qp) &&
         (p.window <= 0 || kp > qp - p.window);
}

// ---------------------------------------------------------------------------
// float32: the SIMT instance
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;                       // query rows per block
constexpr int kBK = 64;                       // keys per kv tile
constexpr int kThreads = 256;
constexpr int kRowsPerWarp = kBQ / (kThreads / 32);

size_t smem_bytes(int dqk, int dv) {
  const size_t floats = static_cast<size_t>(kBQ) * (dqk + 1)   // q tile
                        + static_cast<size_t>(kBK) * (dqk + 1) // k tile
                        + static_cast<size_t>(kBK) * dv        // v tile
                        + static_cast<size_t>(kBQ) * (kBK + 1) // scores
                        + 3 * kBQ;                             // m, l, alpha
  return floats * sizeof(float);
}

// DV_MAX: the output accumulator's width in registers (Dv ≤ DV_MAX).
template <int DV_MAX>
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
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k =
      static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v =
      static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    const int qp = q0 + i;
    qs[i * ldq + d] = qp < p.Sq ? __fmul_rn(q[qp * p.q_ss + d], p.scale)
                                : 0.0f;
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
      ks[j * ldq + d] = kp < p.Skv ? k[kp * p.k_ss + d] : 0.0f;
    }
    for (int idx = tid; idx < kBK * Dv; idx += kThreads) {
      const int j = idx / Dv;
      const int d = idx - j * Dv;
      const int kp = k0 + j;
      vs[j * Dv + d] = kp < p.Skv ? v[kp * p.v_ss + d] : 0.0f;
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

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    const int qp = q0 + i;
    if (qp >= p.Sq) continue;
    const float l = fmaxf(row_l[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * Dv;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv) orow[col] = acc[a][c] / l;
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

template <int DV_MAX>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Dqk, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DV_MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<DV_MAX><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32_dv(const Params& p, cudaStream_t stream) {
  if (p.Dv <= 64) return launch_f32<64>(p, stream);
  if (p.Dv <= 128) return launch_f32<128>(p, stream);
  return launch_f32<256>(p, stream);
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core instance
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;        // query rows per block
constexpr int kStages = 2;                    // the K/V ring

// D: the head dim both products run over (64, 80, 128 or 256: Dqk and Dv
// zero-filled up to it); kRow: the shared rows' width in elements, a power
// of two ≥ 64 so that the swizzle stays inside the row.
template <int D>
struct MmaCfg {
  static constexpr int kRow = D <= 64 ? 64 : D <= 128 ? 128 : 256;
  static constexpr int kBKv = D <= 128 ? 64 : 32;     // keys per kv tile
  static constexpr int kRowBytes = 2 * kRow;
  static constexpr bool kQInRegs = D <= 128;
  static constexpr int kQBytes = kMmaBQ * kRowBytes;
  static constexpr int kTileBytes = kBKv * kRowBytes;  // one K or V tile
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes;
};

template <int D, int W>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_kernel_mma(Params p) {
  using Cfg = MmaCfg<D>;
  constexpr int ROW = Cfg::kRow;
  constexpr int BK = Cfg::kBKv;
  constexpr int NS = BK / 8;                  // n8 tiles of a score block
  constexpr int KQ = D / 16;                  // k16 steps of Q·Kᵀ
  constexpr int NO = D / 8;                   // n8 tiles of O
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const uint32_t s_q = smem_u32(mma_smem);
  const uint32_t s_k = s_q + Cfg::kQBytes;    // kStages K tiles, then V
  const uint32_t s_v = s_k + kStages * Cfg::kTileBytes;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;                  // column pair in a fragment
  const float minus_inf = __int_as_float(0xff800000);
  const int n_qt = (p.Sq + kMmaBQ - 1) / kMmaBQ;
  const long long heads = static_cast<long long>(p.B) * p.H;
  const long long items = heads * n_qt;
  const __nv_bfloat16* q_all = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k_all = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v_all = static_cast<const __nv_bfloat16*>(p.v);

  // work item: (q tile, batch, head), the last q tile first
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int q0 = (n_qt - 1 - static_cast<int>(item / heads)) * kMmaBQ;
    const int bh = static_cast<int>(item % heads);
    const int b = bh / p.H;
    const int h = bh - b * p.H;
    const int hk = h / (p.H / p.Hkv);
    const __nv_bfloat16* q = q_all + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* k = k_all + b * p.k_sb + hk * p.k_sh;
    const __nv_bfloat16* v = v_all + b * p.v_sb + hk * p.v_sh;

    // the kv tiles that meet this q tile's band
    int t_end = (p.Skv + BK - 1) / BK;
    if (p.causal) t_end = min(t_end, (q0 + kMmaBQ - 1) / BK + 1);
    int t_begin = 0;
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;       // first key row q0 sees
      if (lo > 0) t_begin = lo / BK;
    }

    __syncthreads();                          // the last item's readers
    load_tile<ROW, D, kMmaBQ, W, kMmaThreads>(s_q, q, p.q_ss, q0, p.Sq,
                                              p.Dqk);
    if (t_begin < t_end) {
      load_tile<ROW, D, BK, W, kMmaThreads>(s_k, k, p.k_ss, t_begin * BK,
                                            p.Skv, p.Dqk);
      load_tile<ROW, D, BK, W, kMmaThreads>(s_v, v, p.v_ss, t_begin * BK,
                                            p.Skv, p.Dv);
    }
    cp_async_commit();

    // this thread's rows: r0 = q0 + 16·warp + lane / 4 and r0 + 8
    const int r0 = q0 + 16 * warp + lane / 4;
    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    }
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};                // this lane's columns only
    uint32_t qf[Cfg::kQInRegs ? KQ : 1][4];

    // ldmatrix row and chunk offsets of this lane: A (Q) and trans-B (V)
    // read row lane % 8 + 8·(lane / 8 % 2), chunk lane / 16; B (K) reads
    // row lane % 8 + 8·(lane / 16), chunk lane / 8 % 2
    const int a_row = lane % 8 + 8 * (lane / 8 % 2);
    const int a_chunk = lane / 16;
    const int b_row = lane % 8 + 8 * (lane / 16);
    const int b_chunk = lane / 8 % 2;

    for (int t = t_begin; t < t_end; ++t) {
      const int stage = (t - t_begin) % kStages;
      const uint32_t k_tile = s_k + stage * Cfg::kTileBytes;
      const uint32_t v_tile = s_v + stage * Cfg::kTileBytes;
      if (t + 1 < t_end) {                    // the next tile, meanwhile
        const int nxt = (stage + 1) % kStages;
        load_tile<ROW, D, BK, W, kMmaThreads>(
            s_k + nxt * Cfg::kTileBytes, k, p.k_ss, (t + 1) * BK, p.Skv,
            p.Dqk);
        load_tile<ROW, D, BK, W, kMmaThreads>(
            s_v + nxt * Cfg::kTileBytes, v, p.v_ss, (t + 1) * BK, p.Skv,
            p.Dv);
      }
      cp_async_commit();
      cp_async_wait<1>();                     // all but the newest group
      __syncthreads();

      if constexpr (Cfg::kQInRegs) {
        if (t == t_begin) {
#pragma unroll
          for (int kk = 0; kk < KQ; ++kk) {
            ldsm_x4(swz<ROW>(s_q, 16 * warp + a_row, 2 * kk + a_chunk),
                    qf[kk]);
          }
        }
      }

      // S = Q·Kᵀ: 16 rows × BK keys per warp
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t a[4];
        if constexpr (Cfg::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldsm_x4(swz<ROW>(s_q, 16 * warp + a_row, 2 * kk + a_chunk), a);
        }
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          uint32_t bk[4];
          ldsm_x4(swz<ROW>(k_tile, 16 * j + b_row, 2 * kk + b_chunk), bk);
          mma_bf16(s[2 * j], a, bk[0], bk[1]);
          mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
        }
      }

      // scale; then, where the tile crosses the diagonal, the window's
      // edge or Skv, hide keys outside the row's band [lo, hi] with −∞:
      // the row max starts at NEG_INF, as the reference's hidden scores
      // do, and exp(−∞ − m) = 0 exactly.  Element (j, e) is row
      // r0 + 8·(e / 2), key k0 + 8·j + 2·quad + e % 2.
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], p.scale);
      }
      const int k0 = t * BK;
      const int w0 = q0 + 16 * warp;          // this warp's first row
      if ((p.causal && k0 + BK - 1 > w0) ||
          (p.window > 0 && k0 <= w0 + 15 - p.window) || k0 + BK > p.Skv) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qp = r0 + 8 * i;
          const int hi = p.causal ? min(qp, p.Skv - 1) : p.Skv - 1;
          const int lo = p.window > 0 ? qp - p.window + 1 : 0;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kp = k0 + 8 * j + 2 * quad + c;
              if (kp < lo || kp > hi) s[j][2 * i + c] = minus_inf;
            }
          }
        }
      }

      // online softmax over the row's 4 lanes
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e / 2]);
          sum[e / 2] += s[j][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + sum[i];
      // acc ← α·acc; a factor of exactly 1 (the max did not move) is
      // skipped for the whole warp
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
      }

      // O += p_hi·V + p_mid·V + p_lo·V, 16 keys a step: the score
      // fragments of key tiles 2·kt and 2·kt + 1 are the A fragment of
      // step kt (p is split in place, down to its last residue)
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        uint32_t pa[3][4];
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pa[piece][e] = split_pack(s[2 * kt + e / 2][2 * (e % 2)],
                                      s[2 * kt + e / 2][2 * (e % 2) + 1]);
          }
        }
#pragma unroll
        for (int n = 0; n < NO / 2; ++n) {
          uint32_t bv[4];
          ldsm_x4_trans(swz<ROW>(v_tile, 16 * kt + a_row, 2 * n + a_chunk),
                        bv);
#pragma unroll
          for (int piece = 0; piece < 3; ++piece) {
            mma_bf16(acc[2 * n], pa[piece], bv[0], bv[1]);
            mma_bf16(acc[2 * n + 1], pa[piece], bv[2], bv[3]);
          }
        }
      }
      __syncthreads();                        // this stage's readers
    }
    cp_async_wait<0>();

    // epilogue: l over the row's 4 lanes, o = acc / l, lse
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int qp = r0 + 8 * i;
      if (qp >= p.Sq) continue;
      const float li = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow =
          o + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.Dv;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * quad;
        if (col < p.Dv) {
          const float x = acc[n][2 * i] / li;
          const float y = acc[n][2 * i + 1] / li;
          if (p.Dv % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(x, y);
          } else {
            orow[col] = __float2bfloat16_rn(x);
            if (col + 1 < p.Dv) orow[col + 1] = __float2bfloat16_rn(y);
          }
        }
      }
      if (quad == 0) {
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] =
            m[i] + logf(li);
      }
    }
  }
}

template <int D, int W>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int smem = MmaCfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_mma<D, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.B) * p.H *
                          ((p.Sq + kMmaBQ - 1) / kMmaBQ);
  const unsigned grid =
      static_cast<unsigned>(items < 0x7fffffffLL ? items : 0x7fffffffLL);
  flash_fwd_kernel_mma<D, W><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_mma_d(const Params& p, cudaStream_t stream) {
  const int d = p.Dqk > p.Dv ? p.Dqk : p.Dv;
  if (d <= 64) return launch_mma<64, W>(p, stream);
  if (d <= 80) return launch_mma<80, W>(p, stream);
  if (d <= 128) return launch_mma<128, W>(p, stream);
  return launch_mma<256, W>(p, stream);
}

// the copy width must divide every bf16 row start of q, k and v: each base
// address, and each stride in bytes of a dimension longer than 1
bool rows_aligned(const Params& p, int width) {
  const long long ptrs[3] = {reinterpret_cast<long long>(p.q),
                             reinterpret_cast<long long>(p.k),
                             reinterpret_cast<long long>(p.v)};
  const long long strides[9] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss,
                                p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  const int sizes[9] = {p.B, p.Sq, p.H, p.B, p.Skv, p.Hkv, p.B, p.Skv, p.Hkv};
  for (long long x : ptrs) {
    if (x % width) return false;
  }
  for (int i = 0; i < 9; ++i) {
    if (sizes[i] > 1 && (2 * strides[i]) % width) return false;
  }
  return true;
}

}  // namespace

// dtype codes (those of ops.py): 0 = float32, 1 = bfloat16.  q, k, v in
// the model layout with the given element strides of (batch, position,
// head) and a contiguous last dimension; o is written contiguous
// (B, Sq, H, Dv), lse contiguous float32 (B, H, Sq).  `copy_width` (16, 8,
// 4 or 2 bytes) is the bfloat16 instance's staging width: it must divide
// each of q, k and v's base addresses and (batch, position, head) strides
// in bytes, those of dimensions of size 1 excepted (else the call returns
// cudaErrorMisalignedAddress); the float32 instance ignores it.  Requires
// 1 ≤ Dqk, Dv ≤ 256, H % Hkv == 0, and B, H ≤ 65535.  Launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int flash_attention_fwd(
    int dtype, int copy_width, const void* q, const void* k, const void* v,
    void* o, float* lse, int B, int H, int Hkv, int Sq, int Skv, int Dqk,
    int Dv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
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
  if (dtype == 0) return static_cast<int>(launch_f32_dv(p, s));
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (copy_width != 16 && copy_width != 8 && copy_width != 4 &&
      copy_width != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!rows_aligned(p, copy_width)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  switch (copy_width) {
    case 16: return static_cast<int>(launch_mma_d<16>(p, s));
    case 8: return static_cast<int>(launch_mma_d<8>(p, s));
    case 4: return static_cast<int>(launch_mma_d<4>(p, s));
    default: return static_cast<int>(launch_mma_d<2>(p, s));
  }
}

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
// pair and head: 1.4e11 at S = 4096, 0.14 ms at 989 TFLOP/s bf16, 0.85 ms
// in float32 at a third of the 495 TFLOP/s TF32 peak, three TF32 products
// standing for one float32 product).
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
// The float32 instance (flash_fwd_kernel_tf32) runs both products on the
// tensor cores too, as three TF32 products, mma.sync m16n8k8 tf32 → f32
// (tf32_tiles.cuh, shared with the backward's float32 kernels): each float32
// operand is split in registers into x_hi = rna(x) and x_lo = rna(x − x_hi)
// and a·b is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, so every product keeps
// ~2⁻²¹ of float32's 2⁻²⁴ (one TF32 product, 2⁻¹¹, misses ATTN_TOL).  The
// grid, band, masks and online softmax are the bfloat16 instance's; what
// differs:
//   - Numerics.  Q is scaled first, as the reference scales it: once per
//     q tile, in shared memory, q·scale rounded to float32 (__fmul_rn),
//     before any split; the scores are not scaled again.  Each kv tile's
//     P·V is summed in a fresh fragment and added to the rescaled O in
//     float32: the tensor cores truncate as they add, which summed in place
//     over a long band biased the backward's dk past its tolerance
//     (flash_attention_bwd.cu).  l is summed from the float32 p.
//   - Staging.  Float32 tiles by cp.async at the wrapper's copy width (16,
//     8 or 4 bytes; a float32 row start is a multiple of 4), ragged rows
//     and head-dim tails zero-filled by the copy's source size, into rows
//     of D + 8 floats (no swizzle); K and V tiles of 64 keys (32 from
//     D = 128 on) in the two-stage ring: 90, 110, 102 and 198 KB at
//     D = 64, 80, 128 and 256, two blocks an SM below D = 256.
//   - Fragments by 64-bit LDS, as in the backward: a lane's k = t, t + 4
//     over the head dim stand for dims 2t, 2t + 1 (one float2 per row);
//     the score accumulator is P·V's A operand in place, its columns 2t,
//     2t + 1 standing for k = t, t + 4; the score product's n index g reads
//     key row perm8(g), so that V, read by rows perm8(2t), perm8(2t + 1),
//     and K, read by rows perm8(g), both hit 32 distinct banks.
//   - Q.  Read from shared memory at each kv tile: Q's split halves for
//     D ≥ 128, or even Q's float32 values, do not fit in registers beside
//     the O accumulator (64-128 registers a thread).  Each warp splits its
//     Q fragments at every kv tile.  Q's hi and lo halves kept resident
//     instead, split once per q tile in a second Q tile of shared memory,
//     were timed slower or level at head dims 64, 80 and 128 (PERF.md).
//   - 64-row q tiles, as the bfloat16 instance's.  At phase 8's training
//     step (B 4, S 128, 8 heads, D 256) that is 64 blocks, whose 4 warps
//     of 16 rows would leave one warp an SM sub-partition, as 32-row tiles
//     spread over 128 SMs would (the kernel is latency-bound there).  So
//     from D = 256 on two warps share each 16 rows (kHalves), both
//     computing all of S and the softmax — the same values, so nothing is
//     traded — and each half of O's columns (64 accumulator registers, not
//     128): 8 warps a block, S's work twice.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"
#include "tf32_tiles.cuh"

namespace {

using namespace fa_tiles;
namespace tf32 = fa_tf32;

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

// ---------------------------------------------------------------------------
// float32: the 3×TF32 tensor-core instance
// ---------------------------------------------------------------------------

// D: the head-dim bucket the products run over (that of the bfloat16
// instance; Dqk and Dv zero-filled up to it), rows of kPitch floats
template <int D>
struct Tf32Cfg {
  // above D = 128 two warps share each 16 query rows, each computing all
  // of S and the softmax (the same values) and half of O's columns
  static constexpr int kHalves = D <= 128 ? 1 : 2;
  static constexpr int kThreads = kMmaThreads * kHalves;
  static constexpr int kPitch = tf32::pitch<D>();
  static constexpr int kBKv = D <= 80 ? 64 : 32;      // keys per kv tile
  static constexpr int kQTile = kMmaBQ * kPitch;      // floats
  static constexpr int kTile = kBKv * kPitch;         // one K or V tile
  static constexpr int kSmem = 4 * (kQTile + 2 * kStages * kTile);
  // the unroll of the score product's loop over the head dim's k8 steps
  // (the backward's float32 kernels found a full unroll slower)
  static constexpr int kUnroll = 4;
  static_assert(kSmem <= 232448,
                "a block has at most 227 KB of shared memory");
};

template <int D, int W>
__global__ void __launch_bounds__(Tf32Cfg<D>::kThreads)
    flash_fwd_kernel_tf32(Params p) {
  using Cfg = Tf32Cfg<D>;
  constexpr int P = Cfg::kPitch;
  constexpr int BK = Cfg::kBKv;
  constexpr int T = Cfg::kThreads;
  constexpr int NS = BK / 8;                  // n8 tiles of a score block
  constexpr int KD = D / 8;                   // k8 steps over the head dim
  constexpr int NC = D / Cfg::kHalves;        // O columns of a warp
  constexpr int NO = NC / 8;                  // n8 tiles of a warp's O
  constexpr int kUnrollKd = Cfg::kUnroll;
  extern __shared__ __align__(128) unsigned char fwd_tf32_smem[];
  float* const s_q = reinterpret_cast<float*>(fwd_tf32_smem);  // q·scale
  float* const s_k = s_q + Cfg::kQTile;       // kStages K tiles,
  float* const s_v = s_k + kStages * Cfg::kTile;  // then kStages V tiles

  const int warp = threadIdx.x / 32 % kMmaWarps;  // its 16 rows
  const int c0 = threadIdx.x / 32 / kMmaWarps * NC;  // its first O column
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int pg = tf32::perm8(lane / 4);       // the key row of n index g
  const int pk[2] = {tf32::perm8(2 * quad), tf32::perm8(2 * quad + 1)};
  const float minus_inf = __int_as_float(0xff800000);
  const int n_qt = (p.Sq + kMmaBQ - 1) / kMmaBQ;
  const long long heads = static_cast<long long>(p.B) * p.H;
  const long long items = heads * n_qt;
  const float* q_all = static_cast<const float*>(p.q);
  const float* k_all = static_cast<const float*>(p.k);
  const float* v_all = static_cast<const float*>(p.v);
  const float* q_row = s_q + (16 * warp + lane / 4) * P;

  // work item: (q tile, batch, head), the last q tile first
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int q0 = (n_qt - 1 - static_cast<int>(item / heads)) * kMmaBQ;
    const int bh = static_cast<int>(item % heads);
    const int b = bh / p.H;
    const int h = bh - b * p.H;
    const int hk = h / (p.H / p.Hkv);
    const float* q = q_all + b * p.q_sb + h * p.q_sh;
    const float* k = k_all + b * p.k_sb + hk * p.k_sh;
    const float* v = v_all + b * p.v_sb + hk * p.v_sh;

    // the kv tiles that meet this q tile's band
    int t_end = (p.Skv + BK - 1) / BK;
    if (p.causal) t_end = min(t_end, (q0 + kMmaBQ - 1) / BK + 1);
    int t_begin = 0;
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;       // first key row q0 sees
      if (lo > 0) t_begin = lo / BK;
    }

    __syncthreads();                          // the last item's readers
    tf32::load_tile<P, D, kMmaBQ, W, T>(smem_u32(s_q), q, p.q_ss, q0, p.Sq,
                                        p.Dqk);
    cp_async_commit();
    if (t_begin < t_end) {
      tf32::load_tile<P, D, BK, W, T>(smem_u32(s_k), k, p.k_ss,
                                      t_begin * BK, p.Skv, p.Dqk);
      tf32::load_tile<P, D, BK, W, T>(smem_u32(s_v), v, p.v_ss,
                                      t_begin * BK, p.Skv, p.Dv);
    }
    cp_async_commit();
    cp_async_wait<1>();                       // Q's group
    __syncthreads();
    // q·scale in float32, as the reference scales q, before any split
    // (zero-filled rows and columns stay 0); the loop's first barrier
    // orders these stores before the fragments' reads
    for (int i = threadIdx.x; i < kMmaBQ * D / 4; i += T) {
      const int r = i / (D / 4);
      const int c = 4 * (i - r * (D / 4));
      float4* x = reinterpret_cast<float4*>(s_q + r * P + c);
      float4 y = *x;
      y.x = __fmul_rn(y.x, p.scale);
      y.y = __fmul_rn(y.y, p.scale);
      y.z = __fmul_rn(y.z, p.scale);
      y.w = __fmul_rn(y.w, p.scale);
      *x = y;
    }

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

    for (int t = t_begin; t < t_end; ++t) {
      const int stage = (t - t_begin) % kStages;
      const float* k_tile = s_k + stage * Cfg::kTile;
      const float* v_tile = s_v + stage * Cfg::kTile;
      if (t + 1 < t_end) {                    // the next tile, meanwhile
        const int nxt = (stage + 1) % kStages;
        tf32::load_tile<P, D, BK, W, T>(
            smem_u32(s_k + nxt * Cfg::kTile), k, p.k_ss, (t + 1) * BK,
            p.Skv, p.Dqk);
        tf32::load_tile<P, D, BK, W, T>(
            smem_u32(s_v + nxt * Cfg::kTile), v, p.v_ss, (t + 1) * BK,
            p.Skv, p.Dv);
      }
      cp_async_commit();
      cp_async_wait<1>();                     // all but the newest group
      __syncthreads();

      // S = (q·scale)·Kᵀ: 16 rows × BK keys per warp, n index g of n8 tile
      // j reading key row 8·j + perm8(g)
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      }
#pragma unroll kUnrollKd
      for (int kk = 0; kk < KD; ++kk) {
        const tf32::FragA aq = tf32::head_a<P>(q_row, kk, quad);
        const int c = 8 * kk + 2 * quad;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 kx = tf32::ld2(k_tile + (8 * j + pg) * P + c);
          tf32::mma_3xtf32(s[j], aq, tf32::FragB(kx.x, kx.y));
        }
      }

      // where the tile crosses the diagonal, the window's edge or Skv,
      // hide keys outside the row's band [lo, hi] with −∞ (the row max
      // starts at NEG_INF, as the reference's hidden scores do, and
      // exp(−∞ − m) = 0 exactly).  Element (j, e) is row r0 + 8·(e / 2),
      // key k0 + 8·j + pk[e % 2].
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
              const int kp = k0 + 8 * j + pk[c];
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

      // O += P·V over this warp's columns: n8 tile j of P is k8 step j
      // (its columns in place), reading V rows 8·j + pk[0] and 8·j + pk[1];
      // each n8 tile of O sums the tile's steps in a fresh fragment
      tf32::FragA a[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) a[j] = tf32::acc_a(s[j]);
      tf32::mma_rows_tf32<NO, NS, P>(acc, a, v_tile + c0 + lane / 4, pk);
      __syncthreads();                        // this stage's readers
    }
    cp_async_wait<0>();

    // epilogue: l over the row's 4 lanes, o = acc / l, lse
    float* o = static_cast<float*>(p.o);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int qp = r0 + 8 * i;
      if (qp >= p.Sq) continue;
      const float li = fmaxf(l[i], 1e-30f);
      float* orow =
          o + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.Dv;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = c0 + 8 * n + 2 * quad;
        if (col < p.Dv) {
          const float x = acc[n][2 * i] / li;
          const float y = acc[n][2 * i + 1] / li;
          if (p.Dv % 2 == 0) {
            *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
          } else {
            orow[col] = x;
            if (col + 1 < p.Dv) orow[col + 1] = y;
          }
        }
      }
      if (quad == 0 && c0 == 0) {
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] =
            m[i] + logf(li);
      }
    }
  }
}

template <int D, int W>
cudaError_t launch_tf32(const Params& p, cudaStream_t stream) {
  using Cfg = Tf32Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_tf32<D, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.B) * p.H *
                          ((p.Sq + kMmaBQ - 1) / kMmaBQ);
  const unsigned grid =
      static_cast<unsigned>(items < 0x7fffffffLL ? items : 0x7fffffffLL);
  flash_fwd_kernel_tf32<D, W>
      <<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_tf32_d(const Params& p, cudaStream_t stream) {
  const int d = p.Dqk > p.Dv ? p.Dqk : p.Dv;
  if (d <= 64) return launch_tf32<64, W>(p, stream);
  if (d <= 80) return launch_tf32<80, W>(p, stream);
  if (d <= 128) return launch_tf32<128, W>(p, stream);
  return launch_tf32<256, W>(p, stream);
}

// the copy width must divide every row start of q, k and v: each base
// address, and each stride in bytes (elements of `esize` bytes) of a
// dimension longer than 1
bool rows_aligned(const Params& p, int width, int esize) {
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
    if (sizes[i] > 1 && (esize * strides[i]) % width) return false;
  }
  return true;
}

}  // namespace

// dtype codes (those of ops.py): 0 = float32, 1 = bfloat16.  q, k, v in
// the model layout with the given element strides of (batch, position,
// head) and a contiguous last dimension; o is written contiguous
// (B, Sq, H, Dv), lse contiguous float32 (B, H, Sq).  `copy_width` is the
// staging width in bytes (float32: 16, 8 or 4; bfloat16: 16, 8, 4 or 2): it
// must divide each of q, k and v's base addresses and (batch, position,
// head) strides in bytes, those of dimensions of size 1 excepted (else the
// call returns cudaErrorMisalignedAddress).  Requires 1 ≤ Dqk, Dv ≤ 256,
// H % Hkv == 0, and B, H ≤ 65535.  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int flash_attention_fwd(
    int dtype, int copy_width, const void* q, const void* k, const void* v,
    void* o, float* lse, int B, int H, int Hkv, int Sq, int Skv, int Dqk,
    int Dv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      Dqk <= 0 || Dqk > 256 || Dv <= 0 || Dv > 256 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // float32 rows take 16-, 8- or 4-byte copies; bfloat16 rows 2 as well
  if (copy_width != 16 && copy_width != 8 && copy_width != 4 &&
      (dtype == 0 || copy_width != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,    k,    v,    o,    lse,  B,    H,    Hkv,    Sq,     Skv,
           Dqk,  Dv,   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,   v_sb,   v_ss,
           v_sh, causal, window, scale};
  if (!rows_aligned(p, copy_width, dtype == 0 ? 4 : 2)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (copy_width) {
      case 16: return static_cast<int>(launch_tf32_d<16>(p, s));
      case 8: return static_cast<int>(launch_tf32_d<8>(p, s));
      default: return static_cast<int>(launch_tf32_d<4>(p, s));
    }
  }
  switch (copy_width) {
    case 16: return static_cast<int>(launch_mma_d<16>(p, s));
    case 8: return static_cast<int>(launch_mma_d<8>(p, s));
    case 4: return static_cast<int>(launch_mma_d<4>(p, s));
    default: return static_cast<int>(launch_mma_d<2>(p, s));
  }
}

// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, causal (+ sliding-window) attention with GQA read in place.
//
// Replaces the Pallas TPU kernels of flash_attention_bwd_bhsd
// (src/repro/kernels/flash_attention/backward.py): _dq_kernel (the
// pallas_call at line 150) and _dkv_kernel (line 178).  They compute what
// those kernels compute, not their block structure:
//   s  = scale · (q · kᵀ) in float32 (the plain version scales q first,
//        (q · scale) · kᵀ: an ulp-level rounding of s apart);
//   p  = exp(s − lse) where key kp is visible from query qp (kp ≤ qp when
//        causal, kp > qp − window when window > 0, both < their lengths),
//        exactly 0 elsewhere — lse is the forward's, m + log(max(l, 1e-30)),
//        so a row with no visible key has p = 0 and o = 0;
//   dp = do · vᵀ;  ds = p ∘ (dp − δ), δ = rowsum(do ∘ o) precomputed by the
//        wrapper (ops.py), as the reference precomputes it in jnp;
//   dq = scale · Σ_kv ds · k;  dv = Σ_q pᵀ · do;  dk = Σ_q dsᵀ · (q · scale),
//        dk and dv summed over the g query heads of each kv head.
// expf and IEEE arithmetic, no --use_fast_math: both dtypes' instances
// differ from the plain version (ref.attention_bwd) in summation order,
// where the scale is applied, and in how their tensor-core products round
// (bfloat16: P and dS in pieces; float32: 3×TF32; both below).
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
//     (GQA, MQA) a block either loops over the g query heads of its kv
//     head, or, when the caller provides a workspace, the group is split
//     over blocks: one block per (kv tile, query head, batch) writes its
//     head's float32 partial dk and dv there, and a second kernel sums the
//     g partials of each element in head order and casts.  No atomics:
//     every output element is summed by one thread in a fixed order, so
//     the result is deterministic.
//
// Bound on an H100 SXM: at the training path's shape (gemma-2b, B·M = 4,
// S = 128, 8 heads, 1 kv head, D = 256) the bytes — q, k, v, do, o, lse
// read once and dq, dk, dv written once — against ~10·D operations per
// visible (q, kv) pair and head (the two score products, dq, dk, dv: 2·D
// each); at long S the operations, at the tensor cores' peak of the type
// (float32: a third of TF32's, three TF32 products standing for one).
//
// The bfloat16 instances (dq_kernel_mma, dkv_kernel_mma) run every product
// on the tensor cores, mma.sync m16n8k16 bf16 → f32, on the tile machinery
// of the forward's bfloat16 kernel (mma_tiles.cuh: XOR-swizzled bf16
// tiles staged by cp.async at a copy width W of 16, 8, 4 or 2 bytes chosen
// by the wrapper, ldmatrix, split_pack); the head dim is a template bucket
// D = 64, 80, 128 or 256 (Dqk and Dv zero-filled up to it), so every loop
// over it has a compile-time bound (unrolled in full, but for dk/dv's
// k16 steps at D = 128: by 4, where the full unroll spilled).  Both
// kernels are bounded to one block an SM's registers
// (__launch_bounds__(·, 1)): without it ptxas capped several instances at
// 168 registers and spilled.
//   - dq: one block of 4 warps per (64-row q tile, head, batch), each warp
//     owning 16 query rows; Q and dO stay in shared memory, the K and V
//     tiles of the band (64 keys; 32 at D = 256) stream through a
//     two-stage cp.async ring.  Per tile, S = Q·Kᵀ and dP = dO·Vᵀ; in
//     registers P = exp(scale·s − lse) on visible pairs and exactly 0
//     elsewhere, dS = P ∘ (dP − δ) with lse and δ per row in registers;
//     dQ += dS·K with dS moved from the accumulator layout to the A
//     operand's in registers and K through ldmatrix.trans.  dq = scale·acc
//     is cast once.  At D = 256 a 16-row dq accumulator is 128 float32
//     registers a thread, and ptxas spilled beside it at some copy widths:
//     there the block has 8 warps, each pair splitting its 16 rows' dq
//     columns in halves and both computing S and dP (4·D more work per
//     pair, on the head dim where the training path's call is
//     latency-bound).
//   - dk/dv: one block of 4 warps per (64-key tile, kv head, batch), each
//     warp owning 16 keys, K and V resident; the q tiles of the band (64
//     rows; 32 at D = 256) stream Q, dO, lse and δ through the ring, and
//     are taken 32 queries at a time.  The scores are computed transposed,
//     Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so the accumulator rows are keys and Pᵀ,
//     dSᵀ are A operands of dV += Pᵀ·dO and dK += dSᵀ·Q (dO and Q through
//     ldmatrix.trans); lse and δ are per column here, read from the
//     ring's shared copy.  dk = scale·acc in float32 in the epilogue.  At
//     D = 256 one warp's 16 keys of dk and dv would need 2 × 16 × 256
//     float32 accumulators, 256 registers a thread: there one block takes
//     dv (S, then P·dO) and another dk (S and dP, then dS·Q) for the same
//     keys, at one more S product per pair.  The GQA group stays
//     deterministic, with no atomics: by default a block loops over the g
//     query heads of its kv head; with a workspace (the wrapper's choice
//     where that grid would leave SMs idle: the MQA training shape has 2
//     kv tiles × 1 kv head × 4 batches) it takes one query head and
//     dkv_reduce_kernel sums the g float32 partials in head order.
//   - Masks are applied only where a tile crosses the diagonal, the
//     window's edge or a length; hidden scores become −∞ after the scale,
//     so p = 0 exactly.  dq must hide keys past Skv (they are summed);
//     dk/dv must hide queries past Sq, while its keys past Skv are rows
//     that are never written.
//   - Numerics.  bf16 × bf16 products are exact in float32, so S and dP
//     differ from the plain version only in summation order and in where
//     the scale is applied (scale·(q·k), not (q·scale)·k: an ulp-level
//     rounding of s).  P and dS are float32 weights that become mma
//     operands: each is split into kPieces = 2 bf16 pieces, x_hi = bf16(x),
//     x_lo = bf16(x − x_hi), both multiplied in one float32 accumulator,
//     so a weight carries at most 2⁻¹⁶ relative error (one bf16 piece
//     would carry 2⁻⁸ and misses the tolerance).  The backward's
//     tolerance is 2e-5 of each gradient's largest entry plus one bf16 ulp
//     of the element, looser than the forward's 1e-6 floor, which two
//     pieces missed there (flash_attention.cu takes three).  With n pieces
//     the tensor-core work per visible pair and head is (4 + 2n)·D for dq
//     and (4 + 4n)·D for dk/dv (at D = 256, (8 + 2n)·D and (6 + 4n)·D),
//     against the 6·D and 8·D of the bound.  expf, no --use_fast_math.
//
//
// The float32 instances (dq_kernel_tf32, dkv_kernel_tf32) run every
// product on the tensor cores too, as three TF32 products, mma.sync
// m16n8k8 tf32 → f32 (tf32_tiles.cuh): each float32 operand is split in
// registers into x_hi = rna(x) and x_lo = rna(x − x_hi), and a·b is
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, so every product keeps ~2⁻²¹ of
// float32's 2⁻²⁴ (one TF32 product would keep 2⁻¹¹ and miss the
// tolerance).  The grids, bands, masks, loop-or-split group rule,
// kDqHalves and kPasses are the bfloat16 kernels'; what differs:
//   - Staging.  Float32 tiles are copied by cp.async at the wrapper's copy
//     width (16, 8 or 4 bytes), ragged rows and head-dim tails zero-filled
//     by the copy's source size, into rows of D + 8 floats (no swizzle),
//     through the same two-stage ring.
//   - Fragments without ldmatrix, which moves 16-bit elements: every
//     fragment is read with 32- or 64-bit LDS.  Over the head dim a lane's
//     k = t and t + 4 stand for dims 2t and 2t + 1 (one float2 per row);
//     the accumulator of S (or Sᵀ) feeds dS·K (Pᵀ·dO, dSᵀ·Q) as the A
//     operand in place, its columns 2t and 2t + 1 standing for k = t and
//     t + 4, the B operand reading those two rows.  A tile read both ways
//     (K in dq; Q and dO in dk/dv) has its rows permuted in the score
//     product (perm8): with the pitch D + 8 both reads are free of bank
//     conflicts at every head-dim bucket.
//   - Accumulation.  The tensor cores truncate as they add into an
//     accumulator; summed in place over a band of 4096 queries and 4
//     heads that biased dk past the tolerance.  dQ, dK and dV therefore
//     sum each step's products in a fresh fragment and add it to the
//     running sum in float32 (mma_rows_tf32).
//   - dq: 4 warps.  Up to D = 128 each owns 16 of 64 query rows; at
//     D = 256 two row warps each split their 16 rows' dq columns over two
//     warps (kDqHalves), which take S and dP of half of each 32-key tile
//     and trade dS through shared memory (rather than both computing all
//     of S and dP, as the bfloat16 dq does).  Q and dO of the 64 (32) rows
//     resident, K and V tiles of 32 keys streamed: 74-208 KB.
//   - dk/dv: 8 warps.  Each of 4 key groups of 16 keys (64 a block, K and
//     V resident) is shared by two warps, each taking half the rows of
//     every streamed q tile (32 queries; 16 from D = 128 on); the second
//     half's partial dk and dv are added to the first's through the ring
//     at the end, in a fixed order, in the K and V tiles' place.  Two
//     warps an SM sub-partition hide each other's latency, where one warp
//     (4 a block) stalled on its own.  74-203 KB.
//   - Unrolling.  The score products' loops over the head dim are
//     unrolled by 4 (a full unroll hoisted loads and made dk/dv slower at
//     D = 256), and every TF32 rounding is two integer operations
//     (to_tf32).
//   - The tolerance is the bfloat16 instances' 2e-5 of each gradient's
//     largest entry, without the bf16 ulp.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tiles.cuh"
#include "tf32_tiles.cuh"

namespace {

using namespace fa_tiles;
namespace tf32 = fa_tf32;
using tf32::acc_a;
using tf32::head_a;
using tf32::ld2;
using tf32::mma_rows_tf32;

constexpr int kThreads = 256;                 // dkv_reduce_kernel's blocks

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

// dk and dv from the partials in `ws`: dkv_reduce_kernel, after the split
// dk/dv kernel on the same stream
template <typename T>
cudaError_t launch_reduce(const Params& p, cudaStream_t stream) {
  const long long n =
      static_cast<long long>(p.B) * p.Skv * p.Hkv * (p.Dqk + p.Dv);
  const long long blocks = (n + kThreads - 1) / kThreads;
  dkv_reduce_kernel<T><<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192),
                         kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core instances
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kStages = 2;                    // the streamed tiles' ring
constexpr int kPieces = 2;                    // bf16 pieces of P and dS

// D: the head-dim bucket the products run over (64, 80, 128 or 256; Dqk
// and Dv zero-filled up to it); kRow: the shared rows' width in elements,
// a power of two ≥ 64 so that the swizzle stays inside the row.
template <int D>
struct BwdCfg {
  static constexpr int kRow = D <= 64 ? 64 : D <= 128 ? 128 : 256;
  static constexpr int kRowBytes = 2 * kRow;
  // dq: Q and dO of 64 query rows resident (16 a warp), K and V tiles of
  // kDqBK keys streamed.  At D = 256 each 16 rows' dq is split over two
  // warps by column halves (8 warps a block), which both compute the same
  // S and dP: a 16 × 256 float32 accumulator is 128 registers a thread,
  // and with it ptxas spilled at some copy widths.
  static constexpr int kDqBQ = 16 * kMmaWarps;
  static constexpr int kDqBK = D <= 128 ? 64 : 32;
  static constexpr int kDqHalves = D <= 128 ? 1 : 2;
  static constexpr int kDqThreads = kMmaThreads * kDqHalves;
  static constexpr int kDqTile = kDqBK * kRowBytes;
  static constexpr int kDqSmem =
      2 * kDqBQ * kRowBytes + 2 * kStages * kDqTile;
  // dk/dv: K and V of 64 keys resident (16 a warp), Q and dO tiles of
  // kKvBQ query rows streamed with their lse and δ, taken kKvSub queries
  // at a time
  static constexpr int kKvBK = 16 * kMmaWarps;
  static constexpr int kKvBQ = D <= 128 ? 64 : 32;
  static constexpr int kKvSub = 32;
  static constexpr int kKvQTile = kKvBQ * kRowBytes;
  static constexpr int kKvStage = 2 * kKvQTile + 2 * kKvBQ * 4;
  static constexpr int kKvSmem = 2 * kKvBK * kRowBytes + kStages * kKvStage;
  // the unroll of dk/dv's loop over the head dim's k16 steps: 4 at
  // D = 128, where the full unroll spilled (ptxas hoisted the ldmatrix
  // loads of all 8 steps beside both accumulators)
  static constexpr int kKvUnroll = D == 128 ? 4 : D / 16;
  // dk/dv passes: at D = 256 one block takes dv and another dk, since both
  // 16 × 256 float32 accumulators would need 256 registers a thread
  static constexpr int kPasses = D <= 128 ? 1 : 2;
};

// (x, y) into columns col, col + 1 of a row of d elements (those < d)
__device__ __forceinline__ void store_pair(bf16* row, int d, int col,
                                           float x, float y) {
  if (col >= d) return;
  if (d % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(x, y);
  } else {
    row[col] = __float2bfloat16_rn(x);
    if (col + 1 < d) row[col + 1] = __float2bfloat16_rn(y);
  }
}

__device__ __forceinline__ void store_pair(float* row, int d, int col,
                                           float x, float y) {
  if (col >= d) return;
  row[col] = x;
  if (col + 1 < d) row[col + 1] = y;
}

// ldmatrix row and chunk offsets of a lane: A operands and trans-B
// operands read row lane % 8 + 8·(lane / 8 % 2), chunk lane / 16; B
// operands read row lane % 8 + 8·(lane / 16), chunk lane / 8 % 2
struct Lanes {
  int a_row, a_chunk, b_row, b_chunk;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane % 8 + 8 * (lane / 8 % 2)),
        a_chunk(lane / 16),
        b_row(lane % 8 + 8 * (lane / 16)),
        b_chunk(lane / 8 % 2) {}
};

// The A operand of k16 step kt, split into kPieces bf16 pieces, from the
// float32 accumulator fragments x[2·kt] and x[2·kt + 1] (16 rows × 16
// columns); x keeps the last rounding residue
template <int N>
__device__ __forceinline__ void split_a(float (&x)[N][4], int kt,
                                        uint32_t (&a)[kPieces][4]) {
#pragma unroll
  for (int piece = 0; piece < kPieces; ++piece) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[piece][e] = split_pack(x[2 * kt + e / 2][2 * (e % 2)],
                               x[2 * kt + e / 2][2 * (e % 2) + 1]);
    }
  }
}

// acc (16 × NC) += a (16 × 16, in pieces) · the 16 rows [row0, row0 + 16)
// and the NC columns from 16-byte chunk c0 on of a swizzled tile, read
// through ldmatrix.trans
template <int ROW, int NC>
__device__ __forceinline__ void mma_rows(float (&acc)[NC / 8][4],
                                         const uint32_t (&a)[kPieces][4],
                                         uint32_t tile, int row0, int c0,
                                         const Lanes& ln) {
#pragma unroll
  for (int n = 0; n < NC / 16; ++n) {
    uint32_t bt[4];
    ldsm_x4_trans(swz<ROW>(tile, row0 + ln.a_row, c0 + 2 * n + ln.a_chunk),
                  bt);
#pragma unroll
    for (int piece = 0; piece < kPieces; ++piece) {
      mma_bf16(acc[2 * n], a[piece], bt[0], bt[1]);
      mma_bf16(acc[2 * n + 1], a[piece], bt[2], bt[3]);
    }
  }
}

// dq: one block of 4 warps (8 at D = 256) per (64-row q tile, head,
// batch), the last q tile first (the longest band under a causal mask)
template <int D, int W>
__global__ void __launch_bounds__(BwdCfg<D>::kDqThreads, 1)
    dq_kernel_mma(Params p) {
  using Cfg = BwdCfg<D>;
  constexpr int ROW = Cfg::kRow;
  constexpr int BQ = Cfg::kDqBQ;
  constexpr int BK = Cfg::kDqBK;
  constexpr int T = Cfg::kDqThreads;
  constexpr int NC = D / Cfg::kDqHalves;      // dq columns of a warp
  constexpr int NS = BK / 8;                  // n8 tiles of a score block
  constexpr int KD = D / 16;                  // k16 steps over the head dim
  constexpr int NO = NC / 8;                  // n8 tiles of a warp's dq
  extern __shared__ __align__(128) unsigned char dq_smem[];
  const uint32_t s_q = smem_u32(dq_smem);
  const uint32_t s_do = s_q + BQ * Cfg::kRowBytes;
  const uint32_t s_k = s_do + BQ * Cfg::kRowBytes;  // kStages K tiles,
  const uint32_t s_v = s_k + kStages * Cfg::kDqTile;  // then kStages V

  const int warp = threadIdx.x / 32 % kMmaWarps;  // its 16 rows
  const int c0 = threadIdx.x / 32 / kMmaWarps * NC;  // its first column
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;                  // column pair in a fragment
  const Lanes ln(lane);
  const float minus_inf = __int_as_float(0xff800000);
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const long long heads = static_cast<long long>(p.B) * p.H;
  const long long items = heads * n_qt;
  const bf16* q_all = static_cast<const bf16*>(p.q);
  const bf16* k_all = static_cast<const bf16*>(p.k);
  const bf16* v_all = static_cast<const bf16*>(p.v);
  const bf16* do_all = static_cast<const bf16*>(p.dout);

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int q0 = (n_qt - 1 - static_cast<int>(item / heads)) * BQ;
    const int bh = static_cast<int>(item % heads);
    const int b = bh / p.H;
    const int h = bh - b * p.H;
    const int hk = h / (p.H / p.Hkv);
    const bf16* q = q_all + b * p.q_sb + h * p.q_sh;
    const bf16* k = k_all + b * p.k_sb + hk * p.k_sh;
    const bf16* v = v_all + b * p.v_sb + hk * p.v_sh;
    const bf16* dout = do_all + b * p.do_sb + h * p.do_sh;

    // the kv tiles that meet this q tile's band
    int t_end = (p.Skv + BK - 1) / BK;
    if (p.causal) t_end = min(t_end, (q0 + BQ - 1) / BK + 1);
    int t_begin = 0;
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;       // first key row q0 sees
      if (lo > 0) t_begin = lo / BK;
    }

    __syncthreads();                          // the last item's readers
    load_tile<ROW, D, BQ, W, T>(s_q, q, p.q_ss, q0, p.Sq, p.Dqk);
    load_tile<ROW, D, BQ, W, T>(s_do, dout, p.do_ss, q0, p.Sq, p.Dv);
    if (t_begin < t_end) {
      load_tile<ROW, D, BK, W, T>(s_k, k, p.k_ss, t_begin * BK, p.Skv,
                                  p.Dqk);
      load_tile<ROW, D, BK, W, T>(s_v, v, p.v_ss, t_begin * BK, p.Skv,
                                  p.Dv);
    }
    cp_async_commit();

    // this thread's rows r0 and r0 + 8, their lse and δ (0 past Sq: those
    // rows are never written)
    const int r0 = q0 + 16 * warp + lane / 4;
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
    float lse[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 8 * i;
      lse[i] = qp < p.Sq ? p.lse[rows + qp] : 0.0f;
      dlt[i] = qp < p.Sq ? p.delta[rows + qp] : 0.0f;
    }
    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    }

    for (int t = t_begin; t < t_end; ++t) {
      const int stage = (t - t_begin) % kStages;
      const uint32_t k_tile = s_k + stage * Cfg::kDqTile;
      const uint32_t v_tile = s_v + stage * Cfg::kDqTile;
      if (t + 1 < t_end) {                    // the next tile, meanwhile
        const int nxt = (stage + 1) % kStages;
        load_tile<ROW, D, BK, W, T>(s_k + nxt * Cfg::kDqTile, k, p.k_ss,
                                    (t + 1) * BK, p.Skv, p.Dqk);
        load_tile<ROW, D, BK, W, T>(s_v + nxt * Cfg::kDqTile, v, p.v_ss,
                                    (t + 1) * BK, p.Skv, p.Dv);
      }
      cp_async_commit();
      cp_async_wait<1>();                     // all but the newest group
      __syncthreads();

      // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows × BK keys per warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[4], ad[4];
        ldsm_x4(swz<ROW>(s_q, 16 * warp + ln.a_row, 2 * kk + ln.a_chunk),
                aq);
        ldsm_x4(swz<ROW>(s_do, 16 * warp + ln.a_row, 2 * kk + ln.a_chunk),
                ad);
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          uint32_t bk[4], bv[4];
          ldsm_x4(swz<ROW>(k_tile, 16 * j + ln.b_row, 2 * kk + ln.b_chunk),
                  bk);
          ldsm_x4(swz<ROW>(v_tile, 16 * j + ln.b_row, 2 * kk + ln.b_chunk),
                  bv);
          mma_bf16(s[2 * j], aq, bk[0], bk[1]);
          mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
          mma_bf16(dp[2 * j], ad, bv[0], bv[1]);
          mma_bf16(dp[2 * j + 1], ad, bv[2], bv[3]);
        }
      }

      // scale; then, where the tile crosses the diagonal, the window's
      // edge or Skv, hide keys outside the row's band [lo, hi] with −∞, so
      // that p = exp(−∞) = 0 exactly; ds = p ∘ (dp − δ) over s.  Element
      // (j, e) is row r0 + 8·(e / 2), key k0 + 8·j + 2·quad + e % 2.
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
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - lse[e / 2]) * (dp[j][e] - dlt[e / 2]);
        }
      }

      // dQ += dS·K, 16 keys a step, K through ldmatrix.trans
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        uint32_t a[kPieces][4];
        split_a(s, kt, a);
        mma_rows<ROW, NC>(acc, a, k_tile, 16 * kt, c0 / 8, ln);
      }
      __syncthreads();                        // this stage's readers
    }
    cp_async_wait<0>();

    // dq = scale · acc, cast once
    bf16* dq = static_cast<bf16*>(p.out0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 8 * i;
      if (qp >= p.Sq) continue;
      bf16* row = dq + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) *
                           p.Dqk;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store_pair(row, p.Dqk, c0 + 8 * n + 2 * quad,
                   __fmul_rn(acc[n][2 * i], p.scale),
                   __fmul_rn(acc[n][2 * i + 1], p.scale));
      }
    }
  }
}

// lse and δ of query rows [q0, q0 + BQ) of head h into dst[0, BQ) and
// dst[BQ, 2·BQ) (float32, 4-byte cp.async), 0 past Sq
template <int BQ>
__device__ __forceinline__ void load_rows_async(uint32_t dst, const Params& p,
                                                int b, int h, int q0) {
  const long long base = (static_cast<long long>(b) * p.H + h) * p.Sq + q0;
  for (int i = threadIdx.x; i < 2 * BQ; i += kMmaThreads) {
    const int r = i < BQ ? i : i - BQ;
    if (q0 + r < p.Sq) {
      const float* src = (i < BQ ? p.lse : p.delta) + base + r;
      copy_full<4>(dst + 4 * i, reinterpret_cast<const char*>(src));
    } else {
      store_zero<4>(dst + 4 * i);
    }
  }
}

// One dk/dv work item: the 64 keys [k0, k0 + 64) of kv head hk against the
// q tiles of their band in query heads [h_begin, h_end).  PASS 0 takes dk
// and dv, 1 dv alone, 2 dk alone.  Writes dk and dv (cast) when the item
// covers the whole group, else its head's float32 partials to p.ws.
template <int D, int W, int PASS>
__device__ __forceinline__ void dkv_item(const Params& p,
                                         unsigned char* smem, int k0,
                                         int b, int hk, int h_begin,
                                         int h_end) {
  using Cfg = BwdCfg<D>;
  constexpr bool kDv = PASS != 2;
  constexpr bool kDk = PASS != 1;
  constexpr int ROW = Cfg::kRow;
  constexpr int BK = Cfg::kKvBK;
  constexpr int BQ = Cfg::kKvBQ;
  constexpr int QS = Cfg::kKvSub;
  constexpr int NQ = QS / 8;                  // n8 tiles of a sub-step
  constexpr int KD = D / 16;
  constexpr int NO = D / 8;
  constexpr int kUnrollKk = Cfg::kKvUnroll;
  const uint32_t s_k = smem_u32(smem);
  const uint32_t s_v = s_k + BK * Cfg::kRowBytes;
  const uint32_t s_ring = s_v + BK * Cfg::kRowBytes;  // kStages × (Q, dO,
                                                      // lse, δ)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const Lanes ln(lane);
  const float minus_inf = __int_as_float(0xff800000);
  const bf16* q_all = static_cast<const bf16*>(p.q);
  const bf16* do_all = static_cast<const bf16*>(p.dout);
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the q tiles that meet this kv tile's band, for each query head
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int qt_begin = p.causal ? min(k0 / BQ, n_q) : 0;
  int qt_end = n_q;
  if (p.window > 0) {
    // the last query row that sees key k0 + BK − 1
    const long long last = static_cast<long long>(k0) + BK - 1 + p.window - 1;
    const long long end = last / BQ + 1;
    qt_end = end < n_q ? static_cast<int>(end) : n_q;
  }
  const int nt = max(qt_end - qt_begin, 0);
  const int steps = (h_end - h_begin) * nt;

  // step i: the q tile qt_begin + i % nt of head h_begin + i / nt
  auto load_step = [&](int i, int stage) {
    const int hq = h_begin + i / nt;
    const int q0 = (qt_begin + i % nt) * BQ;
    const uint32_t base = s_ring + stage * Cfg::kKvStage;
    load_tile<ROW, D, BQ, W, kMmaThreads>(
        base, q_all + b * p.q_sb + hq * p.q_sh, p.q_ss, q0, p.Sq, p.Dqk);
    load_tile<ROW, D, BQ, W, kMmaThreads>(
        base + Cfg::kKvQTile, do_all + b * p.do_sb + hq * p.do_sh, p.do_ss,
        q0, p.Sq, p.Dv);
    load_rows_async<BQ>(base + 2 * Cfg::kKvQTile, p, b, hq, q0);
  };

  __syncthreads();                            // the last item's readers
  load_tile<ROW, D, BK, W, kMmaThreads>(s_k, k, p.k_ss, k0, p.Skv, p.Dqk);
  load_tile<ROW, D, BK, W, kMmaThreads>(s_v, v, p.v_ss, k0, p.Skv, p.Dv);
  if (steps > 0) load_step(0, 0);
  cp_async_commit();

  float dv_acc[kDv ? NO : 1][4], dk_acc[kDk ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kDv) dv_acc[n][e] = 0.0f;
      if constexpr (kDk) dk_acc[n][e] = 0.0f;
    }
  }
  const int kw0 = k0 + 16 * warp;             // this warp's first key
  const int kr = kw0 + lane / 4;              // this thread's keys kr, kr + 8

  for (int i = 0; i < steps; ++i) {
    const int stage = i % kStages;
    if (i + 1 < steps) load_step(i + 1, (i + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();                       // all but the newest group
    __syncthreads();
    const int q0 = (qt_begin + i % nt) * BQ;
    const uint32_t q_tile = s_ring + stage * Cfg::kKvStage;
    const uint32_t do_tile = q_tile + Cfg::kKvQTile;
    const float* lse_s = reinterpret_cast<const float*>(
        smem + (q_tile - s_k) + 2 * Cfg::kKvQTile);
    const float* dlt_s = lse_s + BQ;

#pragma unroll
    for (int qs = 0; qs < BQ; qs += QS) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys × QS queries per warp
      float st[NQ][4], dpt[kDk ? NQ : 1][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.0f;
          if constexpr (kDk) dpt[j][e] = 0.0f;
        }
      }
#pragma unroll kUnrollKk
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4];
        ldsm_x4(swz<ROW>(s_k, 16 * warp + ln.a_row, 2 * kk + ln.a_chunk),
                ak);
#pragma unroll
        for (int j = 0; j < NQ / 2; ++j) {
          uint32_t bq[4];
          ldsm_x4(swz<ROW>(q_tile, qs + 16 * j + ln.b_row,
                           2 * kk + ln.b_chunk), bq);
          mma_bf16(st[2 * j], ak, bq[0], bq[1]);
          mma_bf16(st[2 * j + 1], ak, bq[2], bq[3]);
        }
        if constexpr (kDk) {
          uint32_t av[4];
          ldsm_x4(swz<ROW>(s_v, 16 * warp + ln.a_row, 2 * kk + ln.a_chunk),
                  av);
#pragma unroll
          for (int j = 0; j < NQ / 2; ++j) {
            uint32_t bd[4];
            ldsm_x4(swz<ROW>(do_tile, qs + 16 * j + ln.b_row,
                             2 * kk + ln.b_chunk), bd);
            mma_bf16(dpt[2 * j], av, bd[0], bd[1]);
            mma_bf16(dpt[2 * j + 1], av, bd[2], bd[3]);
          }
        }
      }

      // scale; hide the pairs outside the band with −∞ where the block
      // crosses the diagonal, the window's edge or Sq (keys past Skv are
      // rows that are never written); pᵀ over sᵀ, dsᵀ = pᵀ ∘ (dpᵀ − δ)
      // over dpᵀ.  Element (j, e) is key kr + 8·(e / 2), query
      // q0 + qs + 8·j + 2·quad + e % 2.
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = __fmul_rn(st[j][e], p.scale);
      }
      const int qa = q0 + qs;                 // the sub-step's first query
      if ((p.causal && kw0 + 15 > qa) ||
          (p.window > 0 && kw0 <= qa + QS - 1 - p.window) ||
          qa + QS > p.Sq) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kp = kr + 8 * r;
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int qp = qa + 8 * j + 2 * quad + c;
              if (qp >= p.Sq || (p.causal && kp > qp) ||
                  (p.window > 0 && kp <= qp - p.window)) {
                st[j][2 * r + c] = minus_inf;
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = qs + 8 * j + 2 * quad;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = expf(st[j][e] - (e % 2 ? l2.y : l2.x));
          if constexpr (kDk) {
            dpt[j][e] = pv * (dpt[j][e] - (e % 2 ? d2.y : d2.x));
          }
          st[j][e] = pv;
        }
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q, 16 queries a step, dO and Q through
      // ldmatrix.trans
#pragma unroll
      for (int kt = 0; kt < NQ / 2; ++kt) {
        if constexpr (kDv) {
          uint32_t a[kPieces][4];
          split_a(st, kt, a);
          mma_rows<ROW, D>(dv_acc, a, do_tile, qs + 16 * kt, 0, ln);
        }
        if constexpr (kDk) {
          uint32_t a[kPieces][4];
          split_a(dpt, kt, a);
          mma_rows<ROW, D>(dk_acc, a, q_tile, qs + 16 * kt, 0, ln);
        }
      }
    }
    __syncthreads();                          // this stage's readers
  }
  cp_async_wait<0>();

  // dk = scale · acc; dv = acc: cast into (B, Skv, Hkv, ·), or float32
  // partials of head h_begin into ws (B, H, Skv, Dqk), then (B, H, Skv, Dv)
  const bool split = p.ws != nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kr + 8 * r;
    if (kp >= p.Skv) continue;
    const long long ws_row =
        (static_cast<long long>(b) * p.H + h_begin) * p.Skv + kp;
    const long long out_row =
        (static_cast<long long>(b) * p.Skv + kp) * p.Hkv + hk;
    float* wk = p.ws + ws_row * p.Dqk;
    float* wv = p.ws + static_cast<long long>(p.B) * p.H * p.Skv * p.Dqk +
                ws_row * p.Dv;
    bf16* dk = static_cast<bf16*>(p.out0) + out_row * p.Dqk;
    bf16* dv = static_cast<bf16*>(p.out1) + out_row * p.Dv;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * quad;
      if constexpr (kDk) {
        const float x = __fmul_rn(dk_acc[n][2 * r], p.scale);
        const float y = __fmul_rn(dk_acc[n][2 * r + 1], p.scale);
        if (split) {
          store_pair(wk, p.Dqk, col, x, y);
        } else {
          store_pair(dk, p.Dqk, col, x, y);
        }
      }
      if constexpr (kDv) {
        if (split) {
          store_pair(wv, p.Dv, col, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
        } else {
          store_pair(dv, p.Dv, col, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
        }
      }
    }
  }
}

// dk/dv: one block of 4 warps per (64-key tile, kv head, batch), looping
// over the g query heads; with a workspace, per (64-key tile, query head,
// batch); at D = 256 per pass as well.  The first kv tile first (the
// longest band under a causal mask).
template <int D, int W>
__global__ void __launch_bounds__(kMmaThreads, 1) dkv_kernel_mma(Params p) {
  using Cfg = BwdCfg<D>;
  extern __shared__ __align__(128) unsigned char dkv_smem[];
  const bool split = p.ws != nullptr;
  const int g = p.H / p.Hkv;
  const int heads = split ? p.H : p.Hkv;      // the grid's head axis
  const long long per_tile =
      static_cast<long long>(p.B) * heads * Cfg::kPasses;
  const long long items =
      per_tile * ((p.Skv + Cfg::kKvBK - 1) / Cfg::kKvBK);
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int k0 = static_cast<int>(item / per_tile) * Cfg::kKvBK;
    const int rest = static_cast<int>(item % per_tile);
    const int pass = rest % Cfg::kPasses;
    const int bh = rest / Cfg::kPasses;
    const int b = bh / heads;
    const int hg = bh - b * heads;
    const int hk = split ? hg / g : hg;
    const int h_begin = split ? hg : hk * g;
    const int h_end = split ? h_begin + 1 : h_begin + g;
    if constexpr (Cfg::kPasses == 1) {
      dkv_item<D, W, 0>(p, dkv_smem, k0, b, hk, h_begin, h_end);
    } else if (pass == 0) {
      dkv_item<D, W, 1>(p, dkv_smem, k0, b, hk, h_begin, h_end);
    } else {
      dkv_item<D, W, 2>(p, dkv_smem, k0, b, hk, h_begin, h_end);
    }
  }
}

unsigned grid_of(long long items) {
  return static_cast<unsigned>(items < 0x7fffffffLL ? items : 0x7fffffffLL);
}

template <int D, int W>
cudaError_t launch_dq_mma(const Params& p, cudaStream_t stream) {
  using Cfg = BwdCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel_mma<D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kDqSmem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.B) * p.H *
                          ((p.Sq + Cfg::kDqBQ - 1) / Cfg::kDqBQ);
  dq_kernel_mma<D, W><<<grid_of(items), Cfg::kDqThreads, Cfg::kDqSmem,
                        stream>>>(p);
  return cudaGetLastError();
}

template <int D, int W>
cudaError_t launch_dkv_mma(const Params& p, cudaStream_t stream) {
  using Cfg = BwdCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel_mma<D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kKvSmem);
  if (err != cudaSuccess) return err;
  const bool split = p.ws != nullptr;
  const long long items = static_cast<long long>(p.B) *
                          (split ? p.H : p.Hkv) * Cfg::kPasses *
                          ((p.Skv + Cfg::kKvBK - 1) / Cfg::kKvBK);
  dkv_kernel_mma<D, W><<<grid_of(items), kMmaThreads, Cfg::kKvSmem,
                         stream>>>(p);
  err = cudaGetLastError();
  if (!split || err != cudaSuccess) return err;
  return launch_reduce<bf16>(p, stream);
}

// launch(bucket) at the head-dim bucket of max(Dqk, Dv), 64, 80, 128 or
// 256, given as a compile-time std::integral_constant (both dtypes')
template <typename Launch>
cudaError_t by_bucket(const Params& p, Launch launch) {
  const int d = p.Dqk > p.Dv ? p.Dqk : p.Dv;
  if (d <= 64) return launch(std::integral_constant<int, 64>());
  if (d <= 80) return launch(std::integral_constant<int, 80>());
  if (d <= 128) return launch(std::integral_constant<int, 128>());
  return launch(std::integral_constant<int, 256>());
}

template <int W>
cudaError_t launch_mma(bool dkv, const Params& p, cudaStream_t stream) {
  return by_bucket(p, [&](auto bucket) {
    constexpr int D = decltype(bucket)::value;
    return dkv ? launch_dkv_mma<D, W>(p, stream)
               : launch_dq_mma<D, W>(p, stream);
  });
}

// ---------------------------------------------------------------------------
// float32: the 3×TF32 tensor-core instances
// ---------------------------------------------------------------------------

// D: the head-dim bucket the products run over (that of the bfloat16
// instances; Dqk and Dv zero-filled up to it); rows of kPitch floats
template <int D>
struct Tf32Cfg {
  static constexpr int kPitch = tf32::pitch<D>();
  static constexpr int kRowBytes = 4 * kPitch;
  // dq: 4 warps; each 16 query rows' dq columns split over kDqHalves warps
  // as in the bfloat16 dq (two at D = 256), so kDqRowWarps warps of 16
  // rows; Q and dO of kDqBQ rows resident, K and V tiles of kDqBK keys
  // streamed.  With two halves each warp of a pair takes S and dP of half
  // the tile's keys and the pair trades dS through shared memory (rows of
  // kDsPitch floats, 8·odd as the tiles' pitch).
  static constexpr int kDqHalves = BwdCfg<D>::kDqHalves;
  static constexpr int kDqRowWarps = kMmaWarps / kDqHalves;
  static constexpr int kDqBQ = 16 * kDqRowWarps;
  static constexpr int kDqBK = 32;
  static constexpr int kDqTile = kDqBK * kRowBytes;
  static constexpr int kDsPitch = kDqBK + 8;
  static constexpr int kDqSmem =
      2 * kDqBQ * kRowBytes + 2 * kStages * kDqTile +
      (kDqHalves == 2 ? kDqBQ * kDsPitch * 4 : 0);
  // dk/dv: K and V of kKvBK keys resident, Q, dO, lse and δ of kKvBQ
  // query rows streamed; 8 warps, each 16 keys of 4 key groups and half
  // of each q tile's rows (kKvHalves), the halves' partial sums added in
  // the K and V tiles' place at the end; dk and dv in kPasses blocks as in
  // the bfloat16 dk/dv (two at D = 256)
  static constexpr int kKvBK = 16 * kMmaWarps;
  static constexpr int kKvHalves = 2;
  static constexpr int kKvThreads = kMmaThreads * kKvHalves;
  // 16 from D = 128 on: at D = 128 32 rows (dk and dv both held) spilled
  static constexpr int kKvBQ = D <= 80 ? 32 : 16;
  static constexpr int kKvQTile = kKvBQ * kRowBytes;
  static constexpr int kKvStage = 2 * kKvQTile + 2 * kKvBQ * 4;
  static constexpr int kKvSmem = 2 * kKvBK * kRowBytes + kStages * kKvStage;
  static constexpr int kPasses = BwdCfg<D>::kPasses;
  // the unroll of the score products' loops over the head dim's k8 steps
  // (a full unroll made the dk/dv kernel slower at D = 256)
  static constexpr int kUnroll = 4;
  static_assert(kDqSmem <= 232448 && kKvSmem <= 232448,
                "a block has at most 227 KB of shared memory");
};

// dq: one block of 4 warps per (q tile of kDqBQ rows, head, batch), the
// last q tile first (the longest band under a causal mask)
template <int D, int W>
__global__ void __launch_bounds__(kMmaThreads, 1)
    dq_kernel_tf32(Params p) {
  using Cfg = Tf32Cfg<D>;
  constexpr int P = Cfg::kPitch;
  constexpr int BQ = Cfg::kDqBQ;
  constexpr int BK = Cfg::kDqBK;
  constexpr int NC = D / Cfg::kDqHalves;      // dq columns of a warp
  constexpr int NS = BK / 8;                  // n8 tiles of a score block
  constexpr int NSW = NS / Cfg::kDqHalves;    // those of S a warp takes
  constexpr int KD = D / 8;                   // k8 steps over the head dim
  constexpr int NO = NC / 8;                  // n8 tiles of a warp's dq
  constexpr int kUnrollKd = Cfg::kUnroll;
  extern __shared__ __align__(128) unsigned char dq_tf32_smem[];
  float* const s_q = reinterpret_cast<float*>(dq_tf32_smem);
  float* const s_do = s_q + BQ * P;
  float* const s_k = s_do + BQ * P;           // kStages K tiles,
  float* const s_v = s_k + kStages * BK * P;  // then kStages V tiles,
  float* const s_ds = s_v + kStages * BK * P;  // then dS (two halves)

  const int warp = threadIdx.x / 32 % Cfg::kDqRowWarps;  // its 16 rows
  const int half = threadIdx.x / 32 / Cfg::kDqRowWarps;
  const int c0 = half * NC;                   // its first dq column
  const int j0 = half * NSW;                  // its first n8 tile of S
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int pg = tf32::perm8(lane / 4);       // the key row of n index g
  const int pk[2] = {tf32::perm8(2 * quad), tf32::perm8(2 * quad + 1)};
  const float minus_inf = __int_as_float(0xff800000);
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const long long heads = static_cast<long long>(p.B) * p.H;
  const long long items = heads * n_qt;
  const float* q_all = static_cast<const float*>(p.q);
  const float* k_all = static_cast<const float*>(p.k);
  const float* v_all = static_cast<const float*>(p.v);
  const float* do_all = static_cast<const float*>(p.dout);
  const float* q_row = s_q + (16 * warp + lane / 4) * P;
  const float* do_row = s_do + (16 * warp + lane / 4) * P;
  float* const ds_row = s_ds + (16 * warp + lane / 4) * Cfg::kDsPitch;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int q0 = (n_qt - 1 - static_cast<int>(item / heads)) * BQ;
    const int bh = static_cast<int>(item % heads);
    const int b = bh / p.H;
    const int h = bh - b * p.H;
    const int hk = h / (p.H / p.Hkv);
    const float* q = q_all + b * p.q_sb + h * p.q_sh;
    const float* k = k_all + b * p.k_sb + hk * p.k_sh;
    const float* v = v_all + b * p.v_sb + hk * p.v_sh;
    const float* dout = do_all + b * p.do_sb + h * p.do_sh;

    // the kv tiles that meet this q tile's band
    int t_end = (p.Skv + BK - 1) / BK;
    if (p.causal) t_end = min(t_end, (q0 + BQ - 1) / BK + 1);
    int t_begin = 0;
    if (p.window > 0) {
      const int lo = q0 - p.window + 1;       // first key row q0 sees
      if (lo > 0) t_begin = lo / BK;
    }

    __syncthreads();                          // the last item's readers
    tf32::load_tile<P, D, BQ, W, kMmaThreads>(smem_u32(s_q), q, p.q_ss, q0,
                                              p.Sq, p.Dqk);
    tf32::load_tile<P, D, BQ, W, kMmaThreads>(smem_u32(s_do), dout, p.do_ss,
                                              q0, p.Sq, p.Dv);
    if (t_begin < t_end) {
      tf32::load_tile<P, D, BK, W, kMmaThreads>(smem_u32(s_k), k, p.k_ss,
                                                t_begin * BK, p.Skv, p.Dqk);
      tf32::load_tile<P, D, BK, W, kMmaThreads>(smem_u32(s_v), v, p.v_ss,
                                                t_begin * BK, p.Skv, p.Dv);
    }
    cp_async_commit();

    // this thread's rows r0 and r0 + 8, their lse and δ (0 past Sq: those
    // rows are never written)
    const int r0 = q0 + 16 * warp + lane / 4;
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
    float lse[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 8 * i;
      lse[i] = qp < p.Sq ? p.lse[rows + qp] : 0.0f;
      dlt[i] = qp < p.Sq ? p.delta[rows + qp] : 0.0f;
    }
    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    }

    for (int t = t_begin; t < t_end; ++t) {
      const int stage = (t - t_begin) % kStages;
      const float* k_tile = s_k + stage * BK * P;
      const float* v_tile = s_v + stage * BK * P;
      if (t + 1 < t_end) {                    // the next tile, meanwhile
        const int nxt = (stage + 1) % kStages;
        tf32::load_tile<P, D, BK, W, kMmaThreads>(
            smem_u32(s_k + nxt * BK * P), k, p.k_ss, (t + 1) * BK, p.Skv,
            p.Dqk);
        tf32::load_tile<P, D, BK, W, kMmaThreads>(
            smem_u32(s_v + nxt * BK * P), v, p.v_ss, (t + 1) * BK, p.Skv,
            p.Dv);
      }
      cp_async_commit();
      cp_async_wait<1>();                     // all but the newest group
      __syncthreads();

      // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows × this warp's NSW n8 tiles of
      // keys, n index g of n8 tile j0 + j reading key row
      // 8·(j0 + j) + perm8(g)
      float s[NSW][4], dp[NSW][4];
#pragma unroll
      for (int j = 0; j < NSW; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll kUnrollKd
      for (int kk = 0; kk < KD; ++kk) {
        const tf32::FragA aq = head_a<P>(q_row, kk, quad);
        const tf32::FragA ad = head_a<P>(do_row, kk, quad);
        const int c = 8 * kk + 2 * quad;
#pragma unroll
        for (int j = 0; j < NSW; ++j) {
          const float2 kx = ld2(k_tile + (8 * (j0 + j) + pg) * P + c);
          const float2 vx = ld2(v_tile + (8 * (j0 + j) + pg) * P + c);
          tf32::mma_3xtf32(s[j], aq, tf32::FragB(kx.x, kx.y));
          tf32::mma_3xtf32(dp[j], ad, tf32::FragB(vx.x, vx.y));
        }
      }

      // scale; then, where the tile crosses the diagonal, the window's
      // edge or Skv, hide keys outside the row's band [lo, hi] with −∞, so
      // that p = exp(−∞) = 0 exactly; ds = p ∘ (dp − δ) over s.  Element
      // (j, e) is row r0 + 8·(e / 2), key k0 + 8·(j0 + j) + pk[e % 2].
#pragma unroll
      for (int j = 0; j < NSW; ++j) {
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
          for (int j = 0; j < NSW; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kp = k0 + 8 * (j0 + j) + pk[c];
              if (kp < lo || kp > hi) s[j][2 * i + c] = minus_inf;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NSW; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - lse[e / 2]) * (dp[j][e] - dlt[e / 2]);
        }
      }

      // dQ += dS·K: n8 tile j of dS is k8 step j, reading K rows
      // 8·j + pk[0] and 8·j + pk[1] at this warp's columns; with two
      // halves, the other half's dS tiles come through shared memory
      // (stored and read in the accumulator's column order)
      tf32::FragA a[NS];
      if constexpr (Cfg::kDqHalves == 1) {
#pragma unroll
        for (int j = 0; j < NS; ++j) a[j] = acc_a(s[j]);
      } else {
        constexpr int DP = Cfg::kDsPitch;
#pragma unroll
        for (int j = 0; j < NSW; ++j) {
          const int col = 8 * (j0 + j) + 2 * quad;
          *reinterpret_cast<float2*>(ds_row + col) =
              make_float2(s[j][0], s[j][1]);
          *reinterpret_cast<float2*>(ds_row + 8 * DP + col) =
              make_float2(s[j][2], s[j][3]);
        }
        __syncthreads();                      // both halves' dS
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 x = ld2(ds_row + 8 * j + 2 * quad);
          const float2 y = ld2(ds_row + 8 * DP + 8 * j + 2 * quad);
          a[j] = tf32::FragA(x.x, y.x, x.y, y.y);
        }
      }
      mma_rows_tf32<NO, NS, P>(acc, a, k_tile + c0 + lane / 4, pk);
      __syncthreads();                        // this stage's readers
    }
    cp_async_wait<0>();

    // dq = scale · acc
    float* dq = static_cast<float*>(p.out0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 8 * i;
      if (qp >= p.Sq) continue;
      float* row = dq + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) *
                            p.Dqk;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store_pair(row, p.Dqk, c0 + 8 * n + 2 * quad,
                   __fmul_rn(acc[n][2 * i], p.scale),
                   __fmul_rn(acc[n][2 * i + 1], p.scale));
      }
    }
  }
}

// One float32 dk/dv work item: the kKvBK keys [k0, k0 + kKvBK) of kv head
// hk against the q tiles of their band in query heads [h_begin, h_end).
// PASS 0 takes dk and dv, 1 dv alone, 2 dk alone.  Writes dk and dv when
// the item covers the whole group, else its head's partials to p.ws.
template <int D, int W, int PASS>
__device__ __forceinline__ void dkv_item_tf32(const Params& p,
                                              unsigned char* smem, int k0,
                                              int b, int hk, int h_begin,
                                              int h_end) {
  using Cfg = Tf32Cfg<D>;
  constexpr bool kDv = PASS != 2;
  constexpr bool kDk = PASS != 1;
  constexpr int P = Cfg::kPitch;
  constexpr int BK = Cfg::kKvBK;
  constexpr int BQ = Cfg::kKvBQ;
  constexpr int NQ = BQ / 8 / Cfg::kKvHalves;  // n8 tiles of a warp's rows
  constexpr int T = Cfg::kKvThreads;
  constexpr int KD = D / 8;
  constexpr int NO = D / 8;
  constexpr int kUnrollKd = Cfg::kUnroll;
  float* const s_k = reinterpret_cast<float*>(smem);
  float* const s_v = s_k + BK * P;
  unsigned char* const s_ring =               // kStages × (Q, dO, lse, δ)
      reinterpret_cast<unsigned char*>(s_v + BK * P);
  const int warp = threadIdx.x / 32 % kMmaWarps;  // its 16 keys
  const int half = threadIdx.x / 32 / kMmaWarps;  // its rows of a q tile
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int pg = tf32::perm8(lane / 4);       // the query row of n index g
  const int pq[2] = {tf32::perm8(2 * quad), tf32::perm8(2 * quad + 1)};
  const float minus_inf = __int_as_float(0xff800000);
  const float* q_all = static_cast<const float*>(p.q);
  const float* do_all = static_cast<const float*>(p.dout);
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the q tiles that meet this kv tile's band, for each query head
  const int n_q = (p.Sq + BQ - 1) / BQ;
  const int qt_begin = p.causal ? min(k0 / BQ, n_q) : 0;
  int qt_end = n_q;
  if (p.window > 0) {
    // the last query row that sees key k0 + BK − 1
    const long long last = static_cast<long long>(k0) + BK - 1 + p.window - 1;
    const long long end = last / BQ + 1;
    qt_end = end < n_q ? static_cast<int>(end) : n_q;
  }
  const int nt = max(qt_end - qt_begin, 0);
  const int steps = (h_end - h_begin) * nt;

  // step i: the q tile qt_begin + i % nt of head h_begin + i / nt
  auto load_step = [&](int i, int stage) {
    const int hq = h_begin + i / nt;
    const int q0 = (qt_begin + i % nt) * BQ;
    const uint32_t base = smem_u32(s_ring + stage * Cfg::kKvStage);
    tf32::load_tile<P, D, BQ, W, T>(
        base, q_all + b * p.q_sb + hq * p.q_sh, p.q_ss, q0, p.Sq, p.Dqk);
    tf32::load_tile<P, D, BQ, W, T>(
        base + Cfg::kKvQTile, do_all + b * p.do_sb + hq * p.do_sh, p.do_ss,
        q0, p.Sq, p.Dv);
    load_rows_async<BQ>(base + 2 * Cfg::kKvQTile, p, b, hq, q0);
  };

  __syncthreads();                            // the last item's readers
  tf32::load_tile<P, D, BK, W, T>(smem_u32(s_k), k, p.k_ss, k0, p.Skv,
                                  p.Dqk);
  tf32::load_tile<P, D, BK, W, T>(smem_u32(s_v), v, p.v_ss, k0, p.Skv,
                                  p.Dv);
  if (steps > 0) load_step(0, 0);
  cp_async_commit();

  float dv_acc[kDv ? NO : 1][4], dk_acc[kDk ? NO : 1][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kDv) dv_acc[n][e] = 0.0f;
      if constexpr (kDk) dk_acc[n][e] = 0.0f;
    }
  }
  const int kw0 = k0 + 16 * warp;             // this warp's first key
  const int kr = kw0 + lane / 4;              // this thread's keys kr, kr + 8
  const float* k_row = s_k + (16 * warp + lane / 4) * P;
  const float* v_row = s_v + (16 * warp + lane / 4) * P;
  const int jq = half * NQ;                   // its first n8 tile of a q tile

  for (int i = 0; i < steps; ++i) {
    const int stage = i % kStages;
    if (i + 1 < steps) load_step(i + 1, (i + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();                       // all but the newest group
    __syncthreads();
    const int q0 = (qt_begin + i % nt) * BQ;
    const float* q_tile =
        reinterpret_cast<const float*>(s_ring + stage * Cfg::kKvStage);
    const float* do_tile = q_tile + BQ * P;
    const float* lse_s = do_tile + BQ * P;
    const float* dlt_s = lse_s + BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys × this warp's NQ n8 tiles of
    // queries, n index g of n8 tile jq + j reading query row
    // 8·(jq + j) + perm8(g)
    float st[NQ][4], dpt[kDk ? NQ : 1][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] = 0.0f;
        if constexpr (kDk) dpt[j][e] = 0.0f;
      }
    }
#pragma unroll kUnrollKd
    for (int kk = 0; kk < KD; ++kk) {
      const int c = 8 * kk + 2 * quad;
      const tf32::FragA ak = head_a<P>(k_row, kk, quad);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 qx = ld2(q_tile + (8 * (jq + j) + pg) * P + c);
        tf32::mma_3xtf32(st[j], ak, tf32::FragB(qx.x, qx.y));
      }
      if constexpr (kDk) {
        const tf32::FragA av = head_a<P>(v_row, kk, quad);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float2 dx = ld2(do_tile + (8 * (jq + j) + pg) * P + c);
          tf32::mma_3xtf32(dpt[j], av, tf32::FragB(dx.x, dx.y));
        }
      }
    }

    // scale; hide the pairs outside the band with −∞ where the block
    // crosses the diagonal, the window's edge or Sq (keys past Skv are
    // rows that are never written); pᵀ over sᵀ, dsᵀ = pᵀ ∘ (dpᵀ − δ) over
    // dpᵀ.  Element (j, e) is key kr + 8·(e / 2), query
    // q0 + 8·(jq + j) + pq[e % 2].
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = __fmul_rn(st[j][e], p.scale);
    }
    if ((p.causal && kw0 + 15 > q0) ||
        (p.window > 0 && kw0 <= q0 + BQ - 1 - p.window) || q0 + BQ > p.Sq) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = kr + 8 * r;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qp = q0 + 8 * (jq + j) + pq[c];
            if (qp >= p.Sq || (p.causal && kp > qp) ||
                (p.window > 0 && kp <= qp - p.window)) {
              st[j][2 * r + c] = minus_inf;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * (jq + j) + pq[e % 2];
        const float pv = expf(st[j][e] - lse_s[col]);
        if constexpr (kDk) dpt[j][e] = pv * (dpt[j][e] - dlt_s[col]);
        st[j][e] = pv;
      }
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q: n8 tile j is k8 step j, reading the dO
    // and Q rows 8·(jq + j) + pq[0] and 8·(jq + j) + pq[1]
    if constexpr (kDv) {
      tf32::FragA a[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) a[j] = acc_a(st[j]);
      mma_rows_tf32<NO, NQ, P>(dv_acc, a, do_tile + 8 * jq * P + lane / 4,
                               pq);
    }
    if constexpr (kDk) {
      tf32::FragA a[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) a[j] = acc_a(dpt[j]);
      mma_rows_tf32<NO, NQ, P>(dk_acc, a, q_tile + 8 * jq * P + lane / 4,
                               pq);
    }
    __syncthreads();                          // this stage's readers
  }
  cp_async_wait<0>();

  // the second half's sums into the first's, in the K and V tiles' place
  // (2·kKvBK·(D + 8) floats, at least the kKvBK·D of each accumulator):
  // each lane of a warp of the second half stores its accumulator
  // fragments where the same lane of the first half's warp for those keys
  // reads them
  __syncthreads();                            // K and V's last readers
  float* const red = s_k + warp * NO * 4 * 32 + lane;
  constexpr int kAccFloats = kMmaWarps * NO * 4 * 32;
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kDv) red[(4 * n + e) * 32] = dv_acc[n][e];
        if constexpr (kDk) red[(kDv ? kAccFloats : 0) + (4 * n + e) * 32] =
            dk_acc[n][e];
      }
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kDv) dv_acc[n][e] += red[(4 * n + e) * 32];
      if constexpr (kDk) {
        dk_acc[n][e] += red[(kDv ? kAccFloats : 0) + (4 * n + e) * 32];
      }
    }
  }

  // dk = scale · acc; dv = acc: into (B, Skv, Hkv, ·), or partials of head
  // h_begin into ws (B, H, Skv, Dqk), then (B, H, Skv, Dv)
  const bool split = p.ws != nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kr + 8 * r;
    if (kp >= p.Skv) continue;
    const long long ws_row =
        (static_cast<long long>(b) * p.H + h_begin) * p.Skv + kp;
    const long long out_row =
        (static_cast<long long>(b) * p.Skv + kp) * p.Hkv + hk;
    float* dk = split ? p.ws + ws_row * p.Dqk
                      : static_cast<float*>(p.out0) + out_row * p.Dqk;
    float* dv = split ? p.ws + static_cast<long long>(p.B) * p.H * p.Skv *
                                   p.Dqk + ws_row * p.Dv
                      : static_cast<float*>(p.out1) + out_row * p.Dv;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * quad;
      if constexpr (kDk) {
        store_pair(dk, p.Dqk, col, __fmul_rn(dk_acc[n][2 * r], p.scale),
                   __fmul_rn(dk_acc[n][2 * r + 1], p.scale));
      }
      if constexpr (kDv) {
        store_pair(dv, p.Dv, col, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
    }
  }
}

// dk/dv: one block of 8 warps per (kKvBK-key tile, kv head, batch),
// looping over the g query heads; with a workspace, per (kKvBK-key tile,
// query head, batch); at D = 256 per pass as well.  The first kv tile
// first (the longest band under a causal mask).
template <int D, int W>
__global__ void __launch_bounds__(Tf32Cfg<D>::kKvThreads, 1)
    dkv_kernel_tf32(Params p) {
  using Cfg = Tf32Cfg<D>;
  extern __shared__ __align__(128) unsigned char dkv_tf32_smem[];
  const bool split = p.ws != nullptr;
  const int g = p.H / p.Hkv;
  const int heads = split ? p.H : p.Hkv;      // the grid's head axis
  const long long per_tile =
      static_cast<long long>(p.B) * heads * Cfg::kPasses;
  const long long items =
      per_tile * ((p.Skv + Cfg::kKvBK - 1) / Cfg::kKvBK);
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int k0 = static_cast<int>(item / per_tile) * Cfg::kKvBK;
    const int rest = static_cast<int>(item % per_tile);
    const int pass = rest % Cfg::kPasses;
    const int bh = rest / Cfg::kPasses;
    const int b = bh / heads;
    const int hg = bh - b * heads;
    const int hk = split ? hg / g : hg;
    const int h_begin = split ? hg : hk * g;
    const int h_end = split ? h_begin + 1 : h_begin + g;
    if constexpr (Cfg::kPasses == 1) {
      dkv_item_tf32<D, W, 0>(p, dkv_tf32_smem, k0, b, hk, h_begin, h_end);
    } else if (pass == 0) {
      dkv_item_tf32<D, W, 1>(p, dkv_tf32_smem, k0, b, hk, h_begin, h_end);
    } else {
      dkv_item_tf32<D, W, 2>(p, dkv_tf32_smem, k0, b, hk, h_begin, h_end);
    }
  }
}

template <int D, int W>
cudaError_t launch_dq_tf32(const Params& p, cudaStream_t stream) {
  using Cfg = Tf32Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel_tf32<D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kDqSmem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.B) * p.H *
                          ((p.Sq + Cfg::kDqBQ - 1) / Cfg::kDqBQ);
  dq_kernel_tf32<D, W><<<grid_of(items), kMmaThreads, Cfg::kDqSmem,
                         stream>>>(p);
  return cudaGetLastError();
}

template <int D, int W>
cudaError_t launch_dkv_tf32(const Params& p, cudaStream_t stream) {
  using Cfg = Tf32Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel_tf32<D, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kKvSmem);
  if (err != cudaSuccess) return err;
  const bool split = p.ws != nullptr;
  const long long items = static_cast<long long>(p.B) *
                          (split ? p.H : p.Hkv) * Cfg::kPasses *
                          ((p.Skv + Cfg::kKvBK - 1) / Cfg::kKvBK);
  dkv_kernel_tf32<D, W><<<grid_of(items), Cfg::kKvThreads, Cfg::kKvSmem,
                          stream>>>(p);
  err = cudaGetLastError();
  if (!split || err != cudaSuccess) return err;
  return launch_reduce<float>(p, stream);
}

template <int W>
cudaError_t launch_tf32(bool dkv, const Params& p, cudaStream_t stream) {
  return by_bucket(p, [&](auto bucket) {
    constexpr int D = decltype(bucket)::value;
    return dkv ? launch_dkv_tf32<D, W>(p, stream)
               : launch_dq_tf32<D, W>(p, stream);
  });
}

// the copy width must divide every row start of q, k, v and do: each base
// address, and each stride in bytes (elements of `esize` bytes) of a
// dimension longer than 1
bool rows_aligned(const Params& p, int width, int esize) {
  const long long ptrs[4] = {reinterpret_cast<long long>(p.q),
                             reinterpret_cast<long long>(p.k),
                             reinterpret_cast<long long>(p.v),
                             reinterpret_cast<long long>(p.dout)};
  const long long strides[12] = {p.q_sb,  p.q_ss,  p.q_sh,  p.k_sb,
                                 p.k_ss,  p.k_sh,  p.v_sb,  p.v_ss,
                                 p.v_sh,  p.do_sb, p.do_ss, p.do_sh};
  const int sizes[12] = {p.B, p.Sq,  p.H,   p.B, p.Skv, p.Hkv,
                         p.B, p.Skv, p.Hkv, p.B, p.Sq,  p.H};
  for (long long x : ptrs) {
    if (x % width) return false;
  }
  for (int i = 0; i < 12; ++i) {
    if (sizes[i] > 1 && (esize * strides[i]) % width) return false;
  }
  return true;
}

int run(bool dkv, int dtype, int copy_width, const Params& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 || p.Sq <= 0 ||
      p.Skv <= 0 || p.Dqk <= 0 || p.Dqk > 256 || p.Dv <= 0 || p.Dv > 256 ||
      p.out0 == nullptr || (dkv && p.out1 == nullptr) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // float32 rows take 16-, 8- or 4-byte copies; bfloat16 rows 2 as well
  if (copy_width != 16 && copy_width != 8 && copy_width != 4 &&
      (dtype == 0 || copy_width != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!rows_aligned(p, copy_width, dtype == 0 ? 4 : 2)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (copy_width) {
      case 16: return static_cast<int>(launch_tf32<16>(dkv, p, s));
      case 8: return static_cast<int>(launch_tf32<8>(dkv, p, s));
      default: return static_cast<int>(launch_tf32<4>(dkv, p, s));
    }
  }
  switch (copy_width) {
    case 16: return static_cast<int>(launch_mma<16>(dkv, p, s));
    case 8: return static_cast<int>(launch_mma<8>(dkv, p, s));
    case 4: return static_cast<int>(launch_mma<4>(dkv, p, s));
    default: return static_cast<int>(launch_mma<2>(dkv, p, s));
  }
}

}  // namespace

// dtype codes (those of ops.py): 0 = float32, 1 = bfloat16.  q, k, v and do
// in the model layout with the given element strides of (batch, position,
// head) and a contiguous last dimension; lse and delta contiguous float32
// (B, H, Sq).  `copy_width` is the staging width in bytes (float32: 16, 8
// or 4; bfloat16: 16, 8, 4 or 2): it must divide each of q, k, v and do's
// base addresses and (batch, position, head) strides in bytes, those of
// dimensions of size 1 excepted (else the call returns
// cudaErrorMisalignedAddress).
// flash_attention_bwd_dq writes dq contiguous (B, Sq, H, Dqk) to out0 (out1
// and ws are not read); flash_attention_bwd_dkv writes dk contiguous
// (B, Skv, Hkv, Dqk) to out0 and dv (B, Skv, Hkv, Dv) to out1.  Its `ws`
// chooses how a GQA/MQA group (H > Hkv) is summed: null, each block loops
// over the g query heads of its kv head; else float32 scratch of
// B·H·Skv·(Dqk + Dv) elements, each query head's partials are written there
// and a second kernel sums the g partials of each element in head order
// (with H == Hkv, ws is not needed).  Requires 1 ≤ Dqk, Dv ≤ 256,
// H % Hkv == 0, B ≤ 65535 and H ≤ 65535.  Each launches on `stream` (dk/dv
// with a workspace: its two kernels, in order), does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch
// (0 = success).
#define BWD_ENTRY(NAME, DKV)                                                 \
  extern "C" int NAME(                                                       \
      int dtype, int copy_width, const void* q, const void* k,               \
      const void* v, const void* dout, const float* lse, const float* delta, \
      void* out0, void* out1, float* ws, int B, int H, int Hkv, int Sq,      \
      int Skv, int Dqk, int Dv,                                              \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,        \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,     \
      int causal, int window, float scale, void* stream) {                   \
    const Params p{q,     k,     v,     dout,  lse,   delta, out0,  out1,    \
                   ws,    B,     H,     Hkv,   Sq,    Skv,   Dqk,   Dv,      \
                   q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,    \
                   v_sh,  do_sb, do_ss, do_sh, causal, window, scale};       \
    return run(DKV, dtype, copy_width, p, stream);                           \
  }

BWD_ENTRY(flash_attention_bwd_dq, false)
BWD_ENTRY(flash_attention_bwd_dkv, true)

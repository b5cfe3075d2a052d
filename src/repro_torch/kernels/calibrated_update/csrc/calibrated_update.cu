// Fused calibrated local update for Hopper (sm_90a).
//
//   calibrated_update:       out = x − η_row · (g + λ c)
//   calibrated_update_prox:  out = x − η_row · (g + λ c + μ (x − x₀))
//
// Replaces the Pallas TPU kernels calibrated_update_2d and
// calibrated_update_prox_2d (src/repro/kernels/calibrated_update/kernel.py,
// lines 27-91).  The round calls one of them once per local step on the
// whole (M, P) client matrix.
//
// Contract: x, g, c, x₀ and out are (rows, 128·k), contiguous, 16-byte
// aligned, all float32 or all bfloat16.  η is a per-row (rows,) float32
// device tensor; λ and μ are runtime scalars.  Arithmetic is float32 with
// one rounding per operation (no FMA contraction), in the order of the
// plain PyTorch version (ref.py), and the result is rounded once to x's
// type.  c == nullptr stands for a zero correction (algorithms without ν):
// c is then not read, and the result is the same as with c = 0, λ = 0.
//
// The per-row η folds the K_i mask into the update: a client that has
// finished its local steps gets η = 0, and its row returns x exactly, given
// finite operands (x − 0·t = x).  That makes the masked step one pass —
// 3 reads and 1 write — where the TPU path ran the kernel and then a
// separate select (src/repro/core/flat.py, line 383).
//
// Bound on the card: bytes.  About 5 float32 operations per element against
// (3 reads + 1 write) · rows · cols · sizeof(T) bytes, plus x₀ for prox
// (minus c when it is absent), at 3.35 TB/s on an H100 SXM — far below the
// 67 TFLOP/s float32 rate.  Design for that bound: a grid-stride
// elementwise loop, each thread moving 16 bytes per operand per iteration
// (float4, or 8 bfloat16 in a uint4), neighbouring threads on neighbouring
// addresses, and at most 8 blocks of 256 threads per SM.  Since cols is a
// multiple of 128, a 16-byte vector never straddles two rows, so each
// vector reads one η.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float (&f)[N]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static Raw pack(const float (&f)[N]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static Raw pack(const float (&f)[N]) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    return r;
  }
};

template <bool HAS_C, bool PROX>
__device__ __forceinline__ float update(float x, float g, float c, float x0,
                                        float eta, float lam, float mu) {
  float t = g;
  if (HAS_C) t = __fadd_rn(t, __fmul_rn(lam, c));
  if (PROX) t = __fadd_rn(t, __fmul_rn(mu, __fsub_rn(x, x0)));
  return __fsub_rn(x, __fmul_rn(eta, t));
}

template <typename T, bool HAS_C, bool PROX>
__global__ void __launch_bounds__(kThreads)
    calibrated_update_kernel(const typename Vec<T>::Raw* __restrict__ x,
                             const typename Vec<T>::Raw* __restrict__ g,
                             const typename Vec<T>::Raw* __restrict__ c,
                             const typename Vec<T>::Raw* __restrict__ x0,
                             const float* __restrict__ eta, float lam,
                             float mu, typename Vec<T>::Raw* __restrict__ out,
                             int64_t n_vec, int64_t vec_per_row) {
  using V = Vec<T>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const float e = __ldg(eta + i / vec_per_row);
    float xf[V::N], gf[V::N], cf[V::N] = {}, x0f[V::N] = {}, of[V::N];
    V::unpack(__ldg(x + i), xf);
    V::unpack(__ldg(g + i), gf);
    if (HAS_C) V::unpack(__ldg(c + i), cf);
    if (PROX) V::unpack(__ldg(x0 + i), x0f);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      of[j] = update<HAS_C, PROX>(xf[j], gf[j], cf[j], x0f[j], e, lam, mu);
    }
    out[i] = V::pack(of);
  }
}

template <typename T, bool HAS_C, bool PROX>
int launch(const void* x, const void* g, const void* c, const void* x0,
           const float* eta, float lam, float mu, void* out, int64_t rows,
           int64_t cols, cudaStream_t stream) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  const int64_t vec_per_row = cols / V::N;
  const int64_t n_vec = rows * vec_per_row;
  if (n_vec == 0) return static_cast<int>(cudaSuccess);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  calibrated_update_kernel<T, HAS_C, PROX>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          static_cast<const Raw*>(x), static_cast<const Raw*>(g),
          static_cast<const Raw*>(c), static_cast<const Raw*>(x0), eta, lam,
          mu, static_cast<Raw*>(out), n_vec, vec_per_row);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (the codes of ops.py).
template <bool PROX>
int dispatch(int dtype, const void* x, const void* g, const void* c,
             const void* x0, const float* eta, float lam, float mu, void* out,
             long long rows, long long cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_c = c != nullptr;
  if (dtype == 0) {
    return has_c ? launch<float, true, PROX>(x, g, c, x0, eta, lam, mu, out,
                                             rows, cols, s)
                 : launch<float, false, PROX>(x, g, c, x0, eta, lam, mu, out,
                                              rows, cols, s);
  }
  if (dtype == 1) {
    return has_c ? launch<__nv_bfloat16, true, PROX>(x, g, c, x0, eta, lam,
                                                     mu, out, rows, cols, s)
                 : launch<__nv_bfloat16, false, PROX>(x, g, c, x0, eta, lam,
                                                      mu, out, rows, cols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both entry points launch on `stream`, do not synchronise, allocate
// nothing, and return cudaGetLastError() after the launch (0 = success).
extern "C" int calibrated_update(int dtype, const void* x, const void* g,
                                 const void* c, const float* eta, float lam,
                                 void* out, long long rows, long long cols,
                                 void* stream) {
  return dispatch<false>(dtype, x, g, c, nullptr, eta, lam, 0.0f, out, rows,
                         cols, stream);
}

extern "C" int calibrated_update_prox(int dtype, const void* x, const void* g,
                                      const void* c, const void* x0,
                                      const float* eta, float lam, float mu,
                                      void* out, long long rows,
                                      long long cols, void* stream) {
  return dispatch<true>(dtype, x, g, c, x0, eta, lam, mu, out, rows, cols,
                        stream);
}

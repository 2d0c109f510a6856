// SymWanda pruning for Hopper (sm_90a): kernels B7 and B8.
//
// Replaces the JAX package's Pallas TPU kernels
//   B7 repro/kernels/nm_prune.py    nm_prune_2d    (_nm_kernel)
//   B8 repro/kernels/wanda_score.py wanda_prune_2d (_wanda_kernel)
//
// Layout: w is (d_in, d_out) row-major, bf16 or f32; a score or mask has
// w's shape.  Both kernels return (out = w * keep, mask = keep) with keep
// 1 or 0 in w's dtype.  out is the product, never a select: -w * 0 is -0.0,
// and the bitwise checks see the sign.
//
// B7: keep the n best scores of each group of m consecutive rows (one output
// column, m <= 8).  rank_i = #{k: s_k > s_i} + #{k < i: s_k == s_i}, keep
// rank < n: exactly n survive even among ties, and the -inf scores of padded
// rows rank after every finite score.
//
// B8: recompute the score of each weight from O(d_in + d_out) statistics
// and keep s >= tau_j (the per-output threshold, found outside):
//   wanda     |w| * xf
//   ria       (|w| / rowsum + |w| / colsum) * xf
//   symwanda  ((beta |w|) xf) / mu_in + (((1 - beta) |w|) yn) / mu_out
// xf is xnorm for wanda and symwanda and xnorm^alpha for ria: the wrapper
// raises the (d_in,) vector to alpha with torch.pow, the same call as the
// plain version, so the two see the same bits (torch.pow(x, 0.5) is sqrt).
// A single ulp at a column's k-th score flips a mask entry, so the score is
// evaluated in the plain version's order with the round-to-nearest
// intrinsics; the build passes no fast-math flag and disables FMA
// contraction.
//
// Bound: both are elementwise passes, bound by bytes (3.35 TB/s on an H100
// SXM).  Per bf16 element B8 reads w (2 B) and writes out and mask (4 B);
// B7 also reads an f32 score (10 B in all).  The arithmetic, at most a dozen
// f32 operations per element, is far below the card's rate.
//
// Design: a first, simple one.  One thread per output column, which walks
// rows: B8 one row per grid row, B7 one group of m rows per grid row, with
// the group's m scores kept in registers.  A warp covers 32 neighbouring
// columns, so every access is coalesced (64 B per warp instruction for bf16;
// wider per-thread vectors are later work).  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 8;
constexpr unsigned int kMaxGridY = 65535;

enum Mode { kWanda = 0, kRia = 1, kSymWanda = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// out = w * keep (exact: keep is 0 or 1), mask = keep, both in T.
template <typename T>
__device__ __forceinline__ void store_kept(T* out, T* mask, int64_t off,
                                           float wf, bool kept) {
  const float keep = kept ? 1.0f : 0.0f;
  mask[off] = from_f32<T>(keep);
  out[off] = from_f32<T>(__fmul_rn(wf, keep));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nm_prune_kernel(const T* __restrict__ w, const float* __restrict__ s,
                T* __restrict__ out, T* __restrict__ mask, int64_t groups,
                int64_t d_out, int n, int m) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d_out) return;
  for (int64_t g = blockIdx.y; g < groups; g += gridDim.y) {
    const int64_t base = g * m * d_out + col;
    float sv[kMaxM] = {};
#pragma unroll
    for (int i = 0; i < kMaxM; ++i)
      if (i < m) sv[i] = s[base + i * d_out];
    // fully unrolled with guards, so sv stays in registers
#pragma unroll
    for (int i = 0; i < kMaxM; ++i) {
      if (i < m) {
        int rank = 0;
#pragma unroll
        for (int k = 0; k < kMaxM; ++k)
          if (k < m) rank += (sv[k] > sv[i]) + (k < i && sv[k] == sv[i]);
        const int64_t off = base + i * d_out;
        store_kept(out, mask, off, to_f32(w[off]), rank < n);
      }
    }
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
wanda_prune_kernel(const T* __restrict__ w, const float* __restrict__ xf,
                   const float* __restrict__ tau,
                   const float* __restrict__ rowsum,
                   const float* __restrict__ colsum,
                   const float* __restrict__ ynorm, T* __restrict__ out,
                   T* __restrict__ mask, int64_t d_in, int64_t d_out,
                   float beta, float one_minus_beta, float mu_in,
                   float mu_out) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d_out) return;
  const float t = tau[col];
  const float cs = kMode == kRia ? colsum[col] : 0.0f;
  const float yn = kMode == kSymWanda ? ynorm[col] : 0.0f;
  for (int64_t r = blockIdx.y; r < d_in; r += gridDim.y) {
    const int64_t off = r * d_out + col;
    const float wf = to_f32(w[off]);
    const float aw = fabsf(wf);
    const float x = xf[r];
    float score;
    if (kMode == kWanda) {
      score = __fmul_rn(aw, x);
    } else if (kMode == kRia) {
      score = __fmul_rn(__fadd_rn(__fdiv_rn(aw, rowsum[r]), __fdiv_rn(aw, cs)), x);
    } else {
      score = __fadd_rn(__fdiv_rn(__fmul_rn(__fmul_rn(beta, aw), x), mu_in),
                        __fdiv_rn(__fmul_rn(__fmul_rn(one_minus_beta, aw), yn),
                                  mu_out));
    }
    store_kept(out, mask, off, wf, score >= t);
  }
}

// (blocks over columns, grid rows); false when the shape does not fit.
bool grid_for(int64_t rows, int64_t d_out, dim3* grid) {
  const int64_t bx = (d_out + kThreads - 1) / kThreads;
  if (rows <= 0 || bx <= 0 || bx > 0x7fffffffLL) return false;
  *grid = dim3(static_cast<unsigned int>(bx),
               static_cast<unsigned int>(rows < kMaxGridY ? rows : kMaxGridY));
  return true;
}

template <typename T>
int nm_prune(const T* w, const float* s, T* out, T* mask, long long d_in,
             long long d_out, int n, int m, cudaStream_t stream) {
  if (d_in == 0 || d_out == 0) return 0;
  dim3 grid;
  if (m < 1 || m > kMaxM || d_in % m || !grid_for(d_in / m, d_out, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  nm_prune_kernel<T><<<grid, kThreads, 0, stream>>>(w, s, out, mask, d_in / m,
                                                    d_out, n, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wanda_prune(const T* w, const float* xf, const float* tau,
                const float* rowsum, const float* colsum, const float* ynorm,
                T* out, T* mask, long long d_in, long long d_out, int mode,
                float beta, float one_minus_beta, float mu_in, float mu_out,
                cudaStream_t stream) {
  if (d_in == 0 || d_out == 0) return 0;
  dim3 grid;
  if (!grid_for(d_in, d_out, &grid)) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_WANDA_LAUNCH(M)                                               \
  wanda_prune_kernel<T, M><<<grid, kThreads, 0, stream>>>(                  \
      w, xf, tau, rowsum, colsum, ynorm, out, mask, d_in, d_out, beta,      \
      one_minus_beta, mu_in, mu_out)
  switch (mode) {
    case kWanda: REPRO_WANDA_LAUNCH(kWanda); break;
    case kRia: REPRO_WANDA_LAUNCH(kRia); break;
    case kSymWanda: REPRO_WANDA_LAUNCH(kSymWanda); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_WANDA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each entry launches on `stream`
// without synchronizing and returns cudaGetLastError() (0 on success).
extern "C" {

int repro_nm_prune_2d_f32(const float* w, const float* s, float* out,
                          float* mask, long long d_in, long long d_out, int n,
                          int m, cudaStream_t stream) {
  return nm_prune(w, s, out, mask, d_in, d_out, n, m, stream);
}

int repro_nm_prune_2d_bf16(const __nv_bfloat16* w, const float* s,
                           __nv_bfloat16* out, __nv_bfloat16* mask,
                           long long d_in, long long d_out, int n, int m,
                           cudaStream_t stream) {
  return nm_prune(w, s, out, mask, d_in, d_out, n, m, stream);
}

int repro_wanda_prune_2d_f32(const float* w, const float* xf, const float* tau,
                             const float* rowsum, const float* colsum,
                             const float* ynorm, float* out, float* mask,
                             long long d_in, long long d_out, int mode,
                             float beta, float one_minus_beta, float mu_in,
                             float mu_out, cudaStream_t stream) {
  return wanda_prune(w, xf, tau, rowsum, colsum, ynorm, out, mask, d_in, d_out,
                     mode, beta, one_minus_beta, mu_in, mu_out, stream);
}

int repro_wanda_prune_2d_bf16(const __nv_bfloat16* w, const float* xf,
                              const float* tau, const float* rowsum,
                              const float* colsum, const float* ynorm,
                              __nv_bfloat16* out, __nv_bfloat16* mask,
                              long long d_in, long long d_out, int mode,
                              float beta, float one_minus_beta, float mu_in,
                              float mu_out, cudaStream_t stream) {
  return wanda_prune(w, xf, tau, rowsum, colsum, ynorm, out, mask, d_in, d_out,
                     mode, beta, one_minus_beta, mu_in, mu_out, stream);
}

}  // extern "C"

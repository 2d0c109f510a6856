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
// and keep s >= tau_j:
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
// B8 has two modes, instances of one kernel template:
// * tau given (select == 0, the TPU kernel's contract): stream w once.  A
//   thread owns 8 neighbouring columns (one 16-byte bf16 vector, two for
//   f32) and 2 rows, whose loads it issues before any arithmetic; a warp
//   covers 512 contiguous bytes of a bf16 row.  The column vectors are read
//   once.  Stores stream past L2 (st.global.cs).  2 rows a thread rather
//   than 4 leave registers for 5 blocks an SM, which hides ria's and
//   symwanda's two divisions an element better (measured on the card).
// * selecting (select != 0): the kernel finds tau_j itself, the k-th
//   largest score of real column j over the real rows, as
//   torch.topk(scores.T, k).values[:, -1] does, and writes it out.  A block
//   owns a strip of 8 columns and all rows; a cluster of 4 blocks (32
//   columns) shares its shared memory, so that stage and mask move 64
//   contiguous bytes of each bf16 row: a lone strip's 16-byte row pieces
//   wrote half sectors and ran slower on the card.
//   1. Stage: block q of the cluster scores rows [q, q + 1) * d_in / 4 of
//      all 32 columns, each score once (its divisions too), and stores the
//      score's order key (below) column-major into the shared memory of the
//      block that owns the column.
//   2. Select: warp c finds column c's k-th largest key by a bitwise search
//      from the MSB.  Step b counts the keys >= cand | 2^b (one compare per
//      key, __reduce_add_sync) and keeps the bit if at least k are.  Once
//      the keys left in the live range [cand, cand + 2^b) number at most
//      256, the warp gathers them (a count pass, a prefix over the lanes, a
//      write pass) into 8 registers per lane and the remaining steps count
//      only those, plus the count above the range.  Deterministic, no
//      atomics.  The search is bound by instruction issue: about 12 steps
//      run over whole columns before the gather.
//   3. Mask: block q re-reads its rows of w (mostly from L2), compares each
//      key with its column's tau key and writes out and mask.
//   A strip taller than shared memory holds (d_in > 7008 rows) is not
//   staged: each key is recomputed from w in global memory at every step.
//
// Traps the selecting mode keeps:
// * Order keys.  key(s) maps a float to a uint32 that orders as the float
//   does: -0.0 is taken as +0.0 (they compare equal), and every NaN maps to
//   0xffffffff, above +inf, because torch.topk ranks NaN above everything.
//   keep = key >= key(tau) && key != NaN, i.e. s >= tau in floats: a NaN
//   score is never kept, and a NaN tau (k or more NaN scores in a column)
//   keeps nothing.  A NaN tau is written as 0x7fffffff, the card's own NaN.
//   Scores are >= +0 (|w| times non-negative statistics), so no -0.0 meets
//   a threshold.
// * Padding.  Rows past `rows` (xnorm 0 in the padded tiles) stay out of
//   the selection but are masked against tau like any row, as in the plain
//   version; columns past `cols` get tau = +inf and keep nothing finite.
// * Ties.  tau is the k-th largest value and s >= tau keeps every tie, so a
//   column may keep more than k.
//
// Bound: B7 and tau-given B8 are elementwise passes, bound by bytes (3.35
// TB/s on an H100 SXM).  Per bf16 element B8 reads w (2 B) and writes out
// and mask (4 B); B7 also reads an f32 score (10 B in all).  Selecting B8
// moves the same bytes; its search adds compare-adds (32 steps over at most
// d_in keys per column, fewer after the gather), counted in chip_smoke.py.
//
// B7's design: a first, simple one.  One thread per output column, which
// walks the groups of m rows one per grid row, with the group's m scores
// kept in registers.  A warp covers 32 neighbouring columns, so every
// access is coalesced (64 B per warp instruction for bf16).  Offsets are
// 64-bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "resources.cuh"

namespace {

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// B8
// ---------------------------------------------------------------------------
constexpr int kVec = 8;                     // columns per thread (one vector)
constexpr int kStreamRows = 2;              // tau given: rows per thread
constexpr int kStreamWarps = kThreads / 32;
constexpr int kStreamBlockCols = 32 * kVec;                 // 256
constexpr int kStreamBlockRows = kStreamWarps * kStreamRows;  // 16
constexpr int kStrip = kVec;                // selecting: columns per block
constexpr int kCluster = 4;                 // selecting: blocks (strips) per cluster
constexpr int kRowThreads = kThreads / kCluster;   // rows a block stages per pass
constexpr int kLive = 256;                  // keys gathered per warp
constexpr int kLivePerLane = kLive / 32;
// selecting launch's dynamic shared memory: the tau keys and the gather
// buffers, then, when staged, kStagedRowSmem bytes of keys per row of d_in
constexpr int kSelectHeadSmem = (kStrip + kStrip * kLive) * 4;
constexpr int kStagedRowSmem = kStrip * 4;
constexpr unsigned int kFull = 0xffffffffu;
constexpr uint32_t kNanKey = 0xffffffffu;

// 8 neighbouring elements of w as loaded (one or two 16-byte vectors)
template <typename T> struct Raw8;
template <> struct Raw8<float> { float4 a, b; };
template <> struct Raw8<__nv_bfloat16> { uint4 a; };

__device__ __forceinline__ Raw8<float> load8(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {q[0], q[1]};
}
__device__ __forceinline__ Raw8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&v)[kVec]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}
// bf16 -> f32 is exact: the bf16 bits are the f32's upper half
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r,
                                       float (&v)[kVec]) {
  const uint32_t u[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
// Stores are streaming (st.global.cs, evict first): nothing reads out or
// mask back in the kernel, and keeping them out of L2 leaves it to w.
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  float4* q = reinterpret_cast<float4*>(p);
  __stcs(q, make_float4(v[0], v[1], v[2], v[3]));
  __stcs(q + 1, make_float4(v[4], v[5], v[6], v[7]));
}
// the values stored are bf16 values times 0 or 1: the rounding is exact
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
            << 16);
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(u[0], u[1], u[2], u[3]));
}

// out = w * keep (exact: keep is 0 or 1), mask = keep, 8 columns of a row
template <typename T>
__device__ __forceinline__ void store_kept8(T* out, T* mask, int64_t off,
                                            const float (&wf)[kVec],
                                            const bool (&kept)[kVec]) {
  float o[kVec], m[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    m[c] = kept[c] ? 1.0f : 0.0f;
    o[c] = __fmul_rn(wf[c], m[c]);
  }
  store8(mask + off, m);
  store8(out + off, o);
}

struct Stats {
  const float* xf;       // (d_in,)
  const float* rowsum;   // (d_in,), ria
  const float* colsum;   // (d_out,), ria
  const float* ynorm;    // (d_out,), symwanda
  float beta, one_minus_beta, mu_in, mu_out;
};

// the score of one weight; x = xf[r], rs = rowsum[r], cs = colsum[j], yn =
// ynorm[j] (the unused ones are 0)
template <int kMode>
__device__ __forceinline__ float score(float wf, float x, float rs, float cs,
                                       float yn, const Stats& st) {
  const float aw = fabsf(wf);
  if (kMode == kWanda) return __fmul_rn(aw, x);
  if (kMode == kRia)
    return __fmul_rn(__fadd_rn(__fdiv_rn(aw, rs), __fdiv_rn(aw, cs)), x);
  return __fadd_rn(__fdiv_rn(__fmul_rn(__fmul_rn(st.beta, aw), x), st.mu_in),
                   __fdiv_rn(__fmul_rn(__fmul_rn(st.one_minus_beta, aw), yn),
                             st.mu_out));
}

// A uint32 that orders as the float does, -0.0 == +0.0, NaN above +inf.
__device__ __forceinline__ uint32_t order_key(float s) {
  if (s != s) return kNanKey;
  uint32_t b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == kNanKey) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}
// s >= tau in floats, from the keys
__device__ __forceinline__ bool key_kept(uint32_t key, uint32_t tau_key) {
  return key >= tau_key && key != kNanKey;
}

// The column statistics of 8 columns from col0, read once.
template <int kMode>
__device__ __forceinline__ void col_stats8(const Stats& st, int64_t col0,
                                          float (&cs)[kVec], float (&yn)[kVec]) {
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    cs[c] = kMode == kRia ? st.colsum[col0 + c] : 0.0f;
    yn[c] = kMode == kSymWanda ? st.ynorm[col0 + c] : 0.0f;
  }
}

template <int kMode>
__device__ __forceinline__ void scores8(const float (&wf)[kVec], const Stats& st,
                                        int64_t r, const float (&cs)[kVec],
                                        const float (&yn)[kVec], float (&s)[kVec]) {
  const float x = st.xf[r];
  const float rs = kMode == kRia ? st.rowsum[r] : 0.0f;
#pragma unroll
  for (int c = 0; c < kVec; ++c) s[c] = score<kMode>(wf[c], x, rs, cs[c], yn[c], st);
}

// Keys of one column held in shared memory (column-major strip, 16-byte
// aligned); n = the real rows.
struct SmemKeys {
  const uint32_t* k;
  int64_t n;
  __device__ __forceinline__ uint32_t key(int64_t r) const { return k[r]; }
  __device__ __forceinline__ int count_ge(uint32_t t, int lane) const {
    int c = 0;
    const int64_t n4 = n >> 2;
    const uint4* k4 = reinterpret_cast<const uint4*>(k);
#pragma unroll 8
    for (int64_t i = lane; i < n4; i += 32) {
      const uint4 v = k4[i];
      c += (v.x >= t) + (v.y >= t) + (v.z >= t) + (v.w >= t);
    }
    const int64_t r = (n4 << 2) + lane;
    if (r < n) c += k[r] >= t;
    return c;
  }
};

// Keys of one column recomputed from w in global memory (strips too tall to
// stage); the same arithmetic as the staged keys.
template <typename T, int kMode>
struct GlobalKeys {
  const T* w;
  int64_t d_out, col, n;
  Stats st;
  float cs, yn;
  __device__ __forceinline__ uint32_t key(int64_t r) const {
    const float rs = kMode == kRia ? st.rowsum[r] : 0.0f;
    return order_key(score<kMode>(to_f32(w[r * d_out + col]), st.xf[r], rs, cs, yn, st));
  }
  __device__ __forceinline__ int count_ge(uint32_t t, int lane) const {
    int c = 0;
    for (int64_t r = lane; r < n; r += 32) c += key(r) >= t;
    return c;
  }
};

// The k-th largest key of one column (1 <= k <= n), found by one warp.
// live: this warp's kLive-key gather buffer in shared memory.
template <class Keys>
__device__ uint32_t select_key(const Keys& keys, int64_t k, uint32_t* live,
                               int lane) {
  const int64_t n = keys.n;
  uint32_t cand = 0;
  int64_t at_cand = n;    // keys >= cand
  int64_t above = 0;      // keys >= cand + 2^(b+1): past the live range
  int64_t base = 0;       // keys above the gathered range
  bool gathered = false;
  uint32_t mine[kLivePerLane];
  for (int b = 31; b >= 0; --b) {
    const uint32_t t = cand | (1u << b);
    int64_t c;
    if (!gathered) {
      c = __reduce_add_sync(kFull, keys.count_ge(t, lane));
    } else {
      int m = 0;
#pragma unroll
      for (int i = 0; i < kLivePerLane; ++i) m += mine[i] >= t;
      c = base + __reduce_add_sync(kFull, m);
    }
    if (c >= k) {
      cand = t;
      at_cand = c;
    } else {
      above = c;
    }
    // the live range is now [cand, cand + 2^b), holding at_cand - above keys
    if (!gathered && b > 0 && at_cand - above <= kLive) {
      // two passes, no ballot chain: count this lane's keys in the range
      // (unsigned: key - cand < span means cand <= key < cand + span), take
      // the exclusive prefix over the lanes, then write them from there
      const uint32_t span = 1u << b;
      int in_lane = 0;
      for (int64_t r = lane; r < n; r += 32) in_lane += keys.key(r) - cand < span;
      int at = in_lane;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, at, d);
        if (lane >= d) at += v;
      }
      at -= in_lane;
      for (int64_t r = lane; r < n; r += 32) {
        const uint32_t key = keys.key(r);
        if (key - cand < span) live[at++] = key;
      }
      const int n_live = static_cast<int>(at_cand - above);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kLivePerLane; ++i) {
        const int j = lane + 32 * i;
        mine[i] = j < n_live ? live[j] : 0u;   // key 0 is below every t
      }
      base = above;
      gathered = true;
    }
  }
  return cand;
}

// tau given: stream w; block = 32 lanes x 8 warps, a thread 8 columns x
// kStreamRows rows, kStreamWarps apart.
template <typename T, int kMode>
__device__ __forceinline__ void mask_given_tau(const T* __restrict__ w,
                                               const float* __restrict__ tau,
                                               const Stats& st, T* __restrict__ out,
                                               T* __restrict__ mask, int64_t d_in,
                                               int64_t d_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) * 32 + lane) * kVec;
  if (col0 >= d_out) return;
  float t[kVec], cs[kVec], yn[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) t[c] = tau[col0 + c];
  col_stats8<kMode>(st, col0, cs, yn);
  const int64_t row_blocks = (d_in + kStreamBlockRows - 1) / kStreamBlockRows;
  for (int64_t rb = blockIdx.y; rb < row_blocks; rb += gridDim.y) {
    const int64_t r0 = rb * kStreamBlockRows + warp;
    Raw8<T> raw[kStreamRows];
#pragma unroll
    for (int i = 0; i < kStreamRows; ++i) {
      const int64_t r = r0 + i * kStreamWarps;
      if (r < d_in) raw[i] = load8(w + r * d_out + col0);
    }
#pragma unroll
    for (int i = 0; i < kStreamRows; ++i) {
      const int64_t r = r0 + i * kStreamWarps;
      if (r >= d_in) break;
      float wf[kVec], s[kVec];
      bool kept[kVec];
      unpack8(raw[i], wf);
      scores8<kMode>(wf, st, r, cs, yn, s);
#pragma unroll
      for (int c = 0; c < kVec; ++c) kept[c] = s[c] >= t[c];
      store_kept8(out, mask, r * d_out + col0, wf, kept);
    }
  }
}

// selecting: block = one strip of kStrip columns, warp c selects column c.
// A cluster of kCluster blocks covers kCluster strips (32 columns, 64 bytes
// of a bf16 row): block q stages and masks rows [q, q + 1) * d_in / kCluster
// of all 32 columns, a thread 8 columns of a row, and reaches the strip
// those columns belong to through distributed shared memory.  So each row
// segment is read and written 64 contiguous bytes at a time, whole sectors,
// where a lone strip would write half sectors.  Dynamic shared memory:
// [kStrip] tau keys, [kStrip][kLive] gather buffers, then, if staged, the
// [kStrip][d_in] keys.
template <typename T, int kMode>
__device__ __forceinline__ void mask_selecting(const T* __restrict__ w,
                                               float* __restrict__ tau,
                                               const Stats& st, T* __restrict__ out,
                                               T* __restrict__ mask, int64_t d_in,
                                               int64_t d_out, int64_t k,
                                               int64_t rows, int64_t cols,
                                               bool staged) {
  extern __shared__ uint4 smem_raw[];
  uint32_t* tau_keys = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* live = tau_keys + kStrip;
  uint32_t* keys = live + kStrip * kLive;
  const cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = threadIdx.x % kCluster;      // the strip of this thread's columns
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) - q + s) * kStrip;
  const int64_t r_lo = d_in / kCluster * q, r_hi = r_lo + d_in / kCluster;
  const int64_t r0 = r_lo + threadIdx.x / kCluster;
  float cs[kVec], yn[kVec];
  col_stats8<kMode>(st, col0, cs, yn);
  uint32_t* keys_s = cluster.map_shared_rank(keys, s);

  if (staged) {                              // 1. score each weight once
#pragma unroll 2
    for (int64_t r = r0; r < r_hi; r += kRowThreads) {
      float wf[kVec], sc[kVec];
      unpack8(load8(w + r * d_out + col0), wf);
      scores8<kMode>(wf, st, r, cs, yn, sc);
#pragma unroll
      for (int c = 0; c < kVec; ++c) keys_s[c * d_in + r] = order_key(sc[c]);
    }
  }
  cluster.sync();

  const int64_t col = static_cast<int64_t>(blockIdx.x) * kStrip + warp;   // 2. select
  uint32_t tk = order_key(__int_as_float(0x7f800000));   // +inf: keeps nothing finite
  if (col < cols) {
    uint32_t* buf = live + warp * kLive;
    if (staged) {
      tk = select_key(SmemKeys{keys + warp * d_in, rows}, k, buf, lane);
    } else {
      tk = select_key(GlobalKeys<T, kMode>{w, d_out, col, rows, st,
                                           kMode == kRia ? st.colsum[col] : 0.0f,
                                           kMode == kSymWanda ? st.ynorm[col] : 0.0f},
                      k, buf, lane);
    }
  }
  if (lane == 0) {
    tau_keys[warp] = tk;
    tau[col] = key_value(tk);
  }
  cluster.sync();

  const uint32_t* tk_s = cluster.map_shared_rank(tau_keys, s);   // 3. mask
  uint32_t t[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) t[c] = tk_s[c];
#pragma unroll 2
  for (int64_t r = r0; r < r_hi; r += kRowThreads) {
    const int64_t off = r * d_out + col0;
    float wf[kVec];
    bool kept[kVec];
    unpack8(load8(w + off), wf);
    if (staged) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) kept[c] = key_kept(keys_s[c * d_in + r], t[c]);
    } else {
      float sc[kVec];
      scores8<kMode>(wf, st, r, cs, yn, sc);
#pragma unroll
      for (int c = 0; c < kVec; ++c) kept[c] = key_kept(order_key(sc[c]), t[c]);
    }
    store_kept8(out, mask, off, wf, kept);
  }
  cluster.sync();                            // peers may still read these keys
}

// One kernel, two modes: kSelect finds tau (and writes it), otherwise tau
// is read.
template <typename T, int kMode, bool kSelect>
__global__ void __launch_bounds__(kThreads)
wanda_prune_kernel(const T* __restrict__ w, float* __restrict__ tau, Stats st,
                   T* __restrict__ out, T* __restrict__ mask, int64_t d_in,
                   int64_t d_out, int64_t k, int64_t rows, int64_t cols,
                   bool staged) {
  if constexpr (kSelect)
    mask_selecting<T, kMode>(w, tau, st, out, mask, d_in, d_out, k, rows, cols, staged);
  else
    mask_given_tau<T, kMode>(w, tau, st, out, mask, d_in, d_out);
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

// The selecting launch's dynamic shared memory for d_in rows: the tau keys
// and the gather buffers, then the strip's keys when they fit the device's
// opt-in limit (7008 rows on an H100's 227 KB).
cudaError_t selecting_smem(int64_t d_in, int64_t* smem, bool* staged) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int64_t staged_bytes = kSelectHeadSmem + kStagedRowSmem * d_in;
  *staged = staged_bytes <= optin;
  *smem = *staged ? staged_bytes : kSelectHeadSmem;
  return cudaSuccess;
}

template <typename T, int kMode, bool kSelect>
int launch_wanda(const T* w, float* tau, const Stats& st, T* out, T* mask,
                 int64_t d_in, int64_t d_out, int64_t k, int64_t rows,
                 int64_t cols, cudaStream_t stream) {
  const auto kernel = wanda_prune_kernel<T, kMode, kSelect>;
  if (!kSelect) {
    const int64_t bx = (d_out + kStreamBlockCols - 1) / kStreamBlockCols;
    const int64_t by = (d_in + kStreamBlockRows - 1) / kStreamBlockRows;
    if (bx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned int>(bx),
                    static_cast<unsigned int>(by < kMaxGridY ? by : kMaxGridY));
    kernel<<<grid, kThreads, 0, stream>>>(w, tau, st, out, mask, d_in, d_out, 0, d_in,
                                          d_out, false);
    return static_cast<int>(cudaGetLastError());
  }
  int64_t smem = 0;
  bool staged = false;
  cudaError_t err = selecting_smem(d_in, &smem, &staged);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t strips = d_out / kStrip;
  if (strips > 0x7fffffffLL || strips % kCluster || d_in % kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(strips));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, w, tau, st, out, mask, d_in, d_out, k, rows,
                           cols, staged);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// select != 0: find tau (written to `tau`) from the k-th largest score of
// each of the first `cols` columns over the first `rows` rows; otherwise
// read tau.  d_out must be a multiple of 32 (selecting; 8 given), d_in of 4
// (selecting), and w 16-byte aligned.
template <typename T>
int wanda_prune(const T* w, const float* xf, float* tau, const float* rowsum,
                const float* colsum, const float* ynorm, T* out, T* mask,
                long long d_in, long long d_out, int mode, float beta,
                float one_minus_beta, float mu_in, float mu_out, int select,
                long long k, long long rows, long long cols, cudaStream_t stream) {
  if (d_in == 0 || d_out == 0) return 0;
  if (d_in < 0 || d_out < 0 || d_out % kVec) return static_cast<int>(cudaErrorInvalidValue);
  if (select && (rows < 1 || rows > d_in || cols < 0 || cols > d_out || k < 1 || k > rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Stats st{xf, rowsum, colsum, ynorm, beta, one_minus_beta, mu_in, mu_out};
#define REPRO_WANDA_LAUNCH(M)                                                    \
  return select ? launch_wanda<T, M, true>(w, tau, st, out, mask, d_in, d_out, k, \
                                           rows, cols, stream)                   \
                : launch_wanda<T, M, false>(w, tau, st, out, mask, d_in, d_out, 0, \
                                            d_in, d_out, stream)
  switch (mode) {
    case kWanda: REPRO_WANDA_LAUNCH(kWanda);
    case kRia: REPRO_WANDA_LAUNCH(kRia);
    case kSymWanda: REPRO_WANDA_LAUNCH(kSymWanda);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_WANDA_LAUNCH
}

// B8's instances in the report's order: (f32, bf16) x (wanda, ria,
// symwanda) x (tau given, selecting).
template <typename T>
const void* wanda_instance(int mode, bool select) {
  switch (mode * 2 + select) {
    case 0: return (const void*)wanda_prune_kernel<T, kWanda, false>;
    case 1: return (const void*)wanda_prune_kernel<T, kWanda, true>;
    case 2: return (const void*)wanda_prune_kernel<T, kRia, false>;
    case 3: return (const void*)wanda_prune_kernel<T, kRia, true>;
    case 4: return (const void*)wanda_prune_kernel<T, kSymWanda, false>;
    default: return (const void*)wanda_prune_kernel<T, kSymWanda, true>;
  }
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

int repro_wanda_prune_2d_f32(const float* w, const float* xf, float* tau,
                             const float* rowsum, const float* colsum,
                             const float* ynorm, float* out, float* mask,
                             long long d_in, long long d_out, int mode,
                             float beta, float one_minus_beta, float mu_in,
                             float mu_out, int select, long long k,
                             long long rows, long long cols, cudaStream_t stream) {
  return wanda_prune(w, xf, tau, rowsum, colsum, ynorm, out, mask, d_in, d_out,
                     mode, beta, one_minus_beta, mu_in, mu_out, select, k, rows,
                     cols, stream);
}

int repro_wanda_prune_2d_bf16(const __nv_bfloat16* w, const float* xf,
                              float* tau, const float* rowsum,
                              const float* colsum, const float* ynorm,
                              __nv_bfloat16* out, __nv_bfloat16* mask,
                              long long d_in, long long d_out, int mode,
                              float beta, float one_minus_beta, float mu_in,
                              float mu_out, int select, long long k,
                              long long rows, long long cols, cudaStream_t stream) {
  return wanda_prune(w, xf, tau, rowsum, colsum, ynorm, out, mask, d_in, d_out,
                     mode, beta, one_minus_beta, mu_in, mu_out, select, k, rows,
                     cols, stream);
}

// RC003's resource report (resources.cuh) of kernel idx, each as its entry
// above launches it: 0 B7 f32, 1 B7 bf16, then B8 at 2 + ((t * 3 + mode) * 2
// + select) for t = 0 f32, 1 bf16; a selecting B8 at d_in rows.
int repro_prune_resources(int idx, long long d_in, long long* out, char* name,
                          int name_len) {
  constexpr int kCount = 14;
  if (idx == 0 || idx == 1)
    return static_cast<int>(repro_resources::report(
        idx ? (const void*)nm_prune_kernel<__nv_bfloat16> : (const void*)nm_prune_kernel<float>,
        idx ? "nm_prune_kernel<bf16>" : "nm_prune_kernel<float>", kCount, kThreads, 0, 1,
        false, out, name, name_len));
  if (idx < 2 || idx >= kCount) return static_cast<int>(cudaErrorInvalidValue);
  const int i = idx - 2, t = i / 6, mode = (i / 2) % 3;
  const bool select = i % 2;
  if (select && d_in < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t smem = 0;
  bool staged = false;
  if (select) {
    const cudaError_t err = selecting_smem(d_in, &smem, &staged);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  static const char* const kModes[] = {"wanda", "ria", "symwanda"};
  char label[64];
  snprintf(label, sizeof(label), "wanda_prune_kernel<%s,%s,%s>", t ? "bf16" : "float",
           kModes[mode], select ? "select" : "given");
  return static_cast<int>(repro_resources::report(
      t ? wanda_instance<__nv_bfloat16>(mode, select) : wanda_instance<float>(mode, select),
      label, kCount, kThreads, static_cast<size_t>(smem), select ? kCluster : 1, staged,
      out, name, name_len));
}

}  // extern "C"

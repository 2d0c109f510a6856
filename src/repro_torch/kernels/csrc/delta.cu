// One slot's delta apply for Hopper (sm_90a): kernel D1.
//
// Replaces no TPU kernel.  The JAX package computes a slot's parameters as
// debucketize(base + pool[table]) inside one jit (repro/serve/engine.py,
// vmapped over slots), and XLA fuses the gather, the add and the casts
// there.  The port ran them as three PyTorch passes (an index_select into a
// transient f32 `eff`, an add, a cast per leaf), ~26 B an element; this
// kernel is their fusion.
//
// What it computes, for every element i of the layout's [0, d):
//   sum = base[i] + pool[table[i / bs] * bs + i % bs]       (one f32 add)
//   out[leaf of i][i - leaf offset] = bf16_rn(sum) or sum    (the leaf's dtype)
// into the serving engine's parameter tree, in place.  The zero row 0 is
// added like any other (-0.0 + 0.0 is +0.0), and the build's flags (no FMA
// contraction, no flush-to-zero) keep the add one IEEE f32 add and the cast
// __float2bfloat16_rn: the tree is bit for bit debucketize(index_select(
// pool, table) + base), denormals included.
//
// Bound: bytes (3.35 TB/s on an H100 SXM).  Per element it reads base
// (4 B) and the pool's row (4 B) once and writes the leaf (2 B bf16, 4 B
// f32): 10 B for a bf16 tree, against ~26 B for the three passes, with no
// f32 `eff` in device memory.  The table costs 4 B per bucket of bs
// elements, and the arithmetic one add and one convert per element.
//
// Design: the layout is fixed, so the host builds a work list once, when the
// tree is made: pieces (out pointer of the piece's first element, flat
// start, length, is_bf16), each within one leaf and at most the wrapper's
// PIECE elements long.
// One block walks one piece.  Each thread loads 16-byte float4s of base and
// pool (bs is a multiple of 4, so a vector aligned in the flat index never
// crosses a bucket: one table read a vector) and stores 8 bytes (four bf16)
// or 16 bytes (four f32); kUnroll vectors are in flight per thread, so the
// card keeps enough bytes in flight to stream.  Loads take the read-only
// path (__ldg): at mamba2-2.7b's layout on an H100 it ran 5% faster than
// streaming loads (__ldcs), and pieces of 2^14 elements ran ~1% faster than
// pieces of 2^16.  A piece's elements before
// the first 4-aligned flat index, the ragged tail, and all of a piece whose
// output is not aligned with its input take a scalar path.  Offsets within
// a piece are 32-bit; the flat index and every address are 64-bit (the
// main path's layout has 2.7e9 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "resources.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                                  // f32 per 16-byte load
constexpr int kUnroll = 4;                               // vectors in flight a thread
constexpr int kPieceFields = 4;                          // out, start, length, is_bf16

__device__ __forceinline__ void store_one(char* out, int k, bool bf16, float v) {
  if (bf16)
    reinterpret_cast<__nv_bfloat16*>(out)[k] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(out)[k] = v;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__global__ void __launch_bounds__(kThreads)
delta_apply_kernel(const float* __restrict__ base, const float* __restrict__ pool,
                   const int32_t* __restrict__ table, const long long* __restrict__ pieces,
                   int lg_bs) {
  const long long* p = pieces + static_cast<int64_t>(blockIdx.x) * kPieceFields;
  char* const out = reinterpret_cast<char*>(__ldg(p));
  const int64_t start = __ldg(p + 1);
  const int len = static_cast<int>(__ldg(p + 2));
  const bool bf16 = __ldg(p + 3) != 0;
  const int esize = bf16 ? 2 : 4;
  const int64_t bs_mask = (int64_t{1} << lg_bs) - 1;

  // element k of the piece is flat index start + k
  const float* const b0 = base + start;
  auto pool_at = [&](int64_t i) {
    const int64_t row = __ldg(table + (i >> lg_bs));
    return pool + (row << lg_bs) + (i & bs_mask);
  };
  auto scalar = [&](int k) {
    const int64_t i = start + k;
    store_one(out, k, bf16, __ldg(b0 + k) + __ldg(pool_at(i)));
  };

  int head = static_cast<int>((-start) & (kVec - 1));
  if (head > len) head = len;
  const uintptr_t at = reinterpret_cast<uintptr_t>(out) + static_cast<uintptr_t>(head) * esize;
  if (at % (static_cast<uintptr_t>(kVec) * esize)) head = len;   // misaligned output
  const int nvec = (len - head) / kVec;

  for (int k = threadIdx.x; k < head; k += kThreads) scalar(k);

  for (int v0 = threadIdx.x; v0 < nvec; v0 += kThreads * kUnroll) {
    float4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nvec) {
        const int k = head + v * kVec;
        a[u] = __ldg(reinterpret_cast<const float4*>(b0 + k));
        b[u] = __ldg(reinterpret_cast<const float4*>(pool_at(start + k)));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nvec) {
        const int k = head + v * kVec;
        const float s0 = a[u].x + b[u].x, s1 = a[u].y + b[u].y;
        const float s2 = a[u].z + b[u].z, s3 = a[u].w + b[u].w;
        if (bf16) {
          uint2 w;
          w.x = bf16_bits(s0) | (bf16_bits(s1) << 16);
          w.y = bf16_bits(s2) | (bf16_bits(s3) << 16);
          *reinterpret_cast<uint2*>(out + static_cast<int64_t>(k) * 2) = w;
        } else {
          *reinterpret_cast<float4*>(out + static_cast<int64_t>(k) * 4) =
              make_float4(s0, s1, s2, s3);
        }
      }
    }
  }

  for (int k = head + nvec * kVec + threadIdx.x; k < len; k += kThreads) scalar(k);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Launches on `stream` without
// synchronizing and returns cudaGetLastError() (0 on success).  `pieces` is
// (n_pieces, kPieceFields) int64 on the device; each length fits 32 bits
// (the wrapper's PIECE); bs = 1 << lg_bs.
extern "C" {

int repro_delta_apply(const float* base, const float* pool, const int32_t* table,
                      const long long* pieces, long long n_pieces, int lg_bs,
                      cudaStream_t stream) {
  if (n_pieces <= 0) return 0;
  if (n_pieces > 0x7fffffffLL || lg_bs < 2 || lg_bs > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  delta_apply_kernel<<<static_cast<unsigned int>(n_pieces), kThreads, 0, stream>>>(
      base, pool, table, pieces, lg_bs);
  return static_cast<int>(cudaGetLastError());
}

// RC003's resource report (resources.cuh) of kernel idx: 0 D1, as the entry
// above launches it.
int repro_delta_resources(int idx, long long d_in, long long* out, char* name,
                          int name_len) {
  (void)d_in;
  if (idx != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(repro_resources::report(
      (const void*)delta_apply_kernel, "delta_apply_kernel", 1, kThreads, 0, 1, false,
      out, name, name_len));
}

}  // extern "C"

// Blockwise absmax int-s quantization for Hopper (sm_90a): kernels B1-B3
// and B6.
//
// Replaces the JAX package's Pallas TPU kernels
//   B1 repro/kernels/quant8.py  quant_dequant_2d     (_quant_kernel)
//   B2 repro/kernels/bitpack.py quant_pack_2d        (_quant_pack_kernel)
//   B3 repro/kernels/bitpack.py unpack_dequant_2d    (_unpack_dequant_kernel)
//   B6 repro/kernels/stream.py  stream_quant_pack_2d (_stream_kernel)
//
// Input layout: the flat tensor viewed as (rows, 512) row-major, one
// quantization block (one scale) per row.  Per row:
//   scale = absmax * f32(1/s)            (1.0 where the row is all zero)
//   q     = clip(floor(x / scale + u), -s, s)
//   B1 out = q * scale;  B2 and B6 out = (int8 q, scale);  B3 out = q * scale.
//
// Numerics are the contract, bit for bit with the plain PyTorch versions in
// repro_torch/kernels/ref.py and with the Pallas kernels: the reciprocal is
// rounded to f32 once, the division is correctly rounded (__fdiv_rn), the add
// and multiply are the explicit round-to-nearest intrinsics (no FMA
// contraction), and the build passes no fast-math flag.
//
// Bound: all three are elementwise passes over device memory, so bytes bound
// them (3.35 TB/s on an H100 SXM).  Per element: B1 reads x and u and writes
// out, 12 B; B2 and B6 read 8 B and write 1 B plus 4 B per row; B3 reads 1 B plus
// 4 B per row and writes 4 B.  The arithmetic (about 6 flops per element)
// is far below the card's f32 rate.
//
// Design: one warp per 512-wide row, eight rows (warps) per 256-thread block.
// Lane l owns elements l*4 + k*128 + j (k < 4, j < 4): each of the four
// steps is one 16-byte float4 (or 4-byte char4) access per lane, so a warp
// touches 512 contiguous bytes of f32 (128 of int8) per instruction, fully
// coalesced.  The row's absmax is reduced in registers, then across the warp
// with __shfl_xor_sync, so x is read exactly once and nothing but the
// outputs is written.  All offsets are 64-bit: the main path's delta has
// 1.83e9 elements, whose f32 byte offsets exceed 2^32.  A first, simple
// design for B1-B3: no TMA or shared-memory staging.
//
// B6 is B2 with the data movement the TPU kernel owns: its two-slot VMEM
// ring copies tile k+1 in while tile k is quantized.  Here persistent blocks
// (as many as fit on the card) walk the 8 x 512 tiles, each with a two-stage
// shared-memory ring of x and noise tiles (2 x 32 KB, dynamic shared memory):
// tile k+1's rows are copied in with cp.async (16 B per copy, one commit
// group per tile) while tile k computes, and cp.async.wait_group 1 lets the
// newer group stay in flight.  One warp per row computes from shared memory
// with B2's lane mapping and arithmetic (quant1, the same scale), so B6
// equals B2 bit for bit: the row's absmax is a max, which no reduction order
// changes.  Each lane reads back only the 16-byte slots it copied itself, so
// the ring needs no barrier beyond each thread's own wait.  q and the scales
// are stored straight to device memory: the TPU ring's outbound half (copy
// the packed tile out while the next computes) has no counterpart, because
// a GPU store does not hold the thread that issues it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resources.cuh"

namespace {

constexpr int kQBlock = 512;
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr int kSteps = kQBlock / (kWarp * 4);  // 4 vector steps per lane
constexpr int kStages = 2;                     // B6 ring depth
// B6 shared memory: [stage][row][x | noise][512 f32] = 2 x 32 KB
constexpr int kRowVec = kQBlock / 4;           // float4 slots per row and plane
constexpr int kStreamSmem = kStages * kRowsPerBlock * 2 * kQBlock * 4;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float absmax4(float m, const float4& v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ float quant1(float x, float u, float scale,
                                        float s) {
  const float q = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return fminf(fmaxf(q, -s), s);
}

// B1 (kPack=false) and B2 (kPack=true) share everything up to the store.
template <bool kPack>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, const float* __restrict__ u,
             float* __restrict__ out, int8_t* __restrict__ q_out,
             float* __restrict__ scale_out, int64_t rows, float s,
             float inv_s) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t base = row * kQBlock + lane * 4;

  float4 xv[kSteps];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    xv[k] = *reinterpret_cast<const float4*>(x + base + k * kWarp * 4);
    m = absmax4(m, xv[k]);
  }
  m = warp_max(m);
  float scale = __fmul_rn(m, inv_s);
  if (scale == 0.0f) scale = 1.0f;

#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int64_t off = base + k * kWarp * 4;
    const float4 uv = *reinterpret_cast<const float4*>(u + off);
    const float q0 = quant1(xv[k].x, uv.x, scale, s);
    const float q1 = quant1(xv[k].y, uv.y, scale, s);
    const float q2 = quant1(xv[k].z, uv.z, scale, s);
    const float q3 = quant1(xv[k].w, uv.w, scale, s);
    if (kPack) {
      *reinterpret_cast<char4*>(q_out + off) = make_char4(
          static_cast<signed char>(q0), static_cast<signed char>(q1),
          static_cast<signed char>(q2), static_cast<signed char>(q3));
    } else {
      *reinterpret_cast<float4*>(out + off) =
          make_float4(__fmul_rn(q0, scale), __fmul_rn(q1, scale),
                      __fmul_rn(q2, scale), __fmul_rn(q3, scale));
    }
  }
  if (kPack && lane == 0) scale_out[row] = scale;
}

__global__ void __launch_bounds__(kThreads)
unpack_dequant_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int64_t rows) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const float scale = scales[row];
  const int64_t base = row * kQBlock + lane * 4;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int64_t off = base + k * kWarp * 4;
    const char4 c = *reinterpret_cast<const char4*>(q + off);
    *reinterpret_cast<float4*>(out + off) = make_float4(
        __fmul_rn(static_cast<float>(c.x), scale),
        __fmul_rn(static_cast<float>(c.y), scale),
        __fmul_rn(static_cast<float>(c.z), scale),
        __fmul_rn(static_cast<float>(c.w), scale));
  }
}

// One 16-byte asynchronous copy device memory -> shared memory (cp.async,
// bypassing L1), and its commit / wait.
__device__ __forceinline__ void cp_async16(float4* smem, const float* gmem) {
  const unsigned int dst =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_newest_pending() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
stream_quant_pack_kernel(const float* __restrict__ x,
                         const float* __restrict__ u,
                         int8_t* __restrict__ q_out,
                         float* __restrict__ scale_out, int64_t n_tiles,
                         float s, float inv_s) {
  extern __shared__ float4 ring[];  // [kStages][kRowsPerBlock][2][kRowVec]
  const int lane = threadIdx.x % kWarp;
  const int r = threadIdx.x / kWarp;  // the warp's row within a tile
  // this lane's slot for step k of plane p (0 = x, 1 = noise) in a stage
  auto slot = [&](int stage, int p, int k) {
    return ring + ((stage * kRowsPerBlock + r) * 2 + p) * kRowVec +
           k * kWarp + lane;
  };
  auto offset = [&](int64_t tile) {
    return (tile * kRowsPerBlock + r) * kQBlock + lane * 4;
  };
  // the lane copies exactly the float4s it will compute on (B2's mapping)
  auto fill = [&](int stage, int64_t tile) {
    const int64_t base = offset(tile);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      cp_async16(slot(stage, 0, k), x + base + k * kWarp * 4);
      cp_async16(slot(stage, 1, k), u + base + k * kWarp * 4);
    }
  };

  int64_t tile = blockIdx.x;
  if (tile < n_tiles) fill(0, tile);
  cp_async_commit();
  for (int stage = 0; tile < n_tiles; tile += gridDim.x, stage ^= 1) {
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles) fill(stage ^ 1, next);  // tile k+1 copies in ...
    cp_async_commit();                          // (an empty group at the end)
    cp_async_wait_newest_pending();             // ... while tile k computes

    float4 xv[kSteps];
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      xv[k] = *slot(stage, 0, k);
      m = absmax4(m, xv[k]);
    }
    m = warp_max(m);
    float scale = __fmul_rn(m, inv_s);
    if (scale == 0.0f) scale = 1.0f;

    const int64_t base = offset(tile);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const float4 uv = *slot(stage, 1, k);
      *reinterpret_cast<char4*>(q_out + base + k * kWarp * 4) = make_char4(
          static_cast<signed char>(quant1(xv[k].x, uv.x, scale, s)),
          static_cast<signed char>(quant1(xv[k].y, uv.y, scale, s)),
          static_cast<signed char>(quant1(xv[k].z, uv.z, scale, s)),
          static_cast<signed char>(quant1(xv[k].w, uv.w, scale, s)));
    }
    if (lane == 0) scale_out[tile * kRowsPerBlock + r] = scale;
  }
}

// Grid for `rows` rows; 0 when the count does not fit a 1-D grid.
unsigned int grid_for(int64_t rows) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned int>(blocks);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each entry launches on `stream`
// without synchronizing and returns cudaGetLastError() (0 on success).
extern "C" {

int repro_quant_dequant_2d(const float* x, const float* u, float* out,
                           long long rows, int s, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const unsigned int grid = grid_for(rows);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float fs = static_cast<float>(s);
  quant_kernel<false><<<grid, kThreads, 0, stream>>>(
      x, u, out, nullptr, nullptr, rows, fs, 1.0f / fs);
  return static_cast<int>(cudaGetLastError());
}

int repro_quant_pack_2d(const float* x, const float* u, int8_t* q,
                        float* scales, long long rows, int s,
                        cudaStream_t stream) {
  if (rows <= 0) return 0;
  const unsigned int grid = grid_for(rows);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float fs = static_cast<float>(s);
  quant_kernel<true><<<grid, kThreads, 0, stream>>>(
      x, u, nullptr, q, scales, rows, fs, 1.0f / fs);
  return static_cast<int>(cudaGetLastError());
}

int repro_unpack_dequant_2d(const int8_t* q, const float* scales, float* out,
                            long long rows, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const unsigned int grid = grid_for(rows);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  unpack_dequant_kernel<<<grid, kThreads, 0, stream>>>(q, scales, out, rows);
  return static_cast<int>(cudaGetLastError());
}

// B6: `rows` must be a whole number of 8-row tiles.  The grid is persistent:
// as many 256-thread blocks as fit on the card at once (64 KB of dynamic
// shared memory each), never more than there are tiles.
int repro_stream_quant_pack_2d(const float* x, const float* u, int8_t* q,
                               float* scales, long long rows, int s,
                               cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (rows % kRowsPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stream_quant_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStreamSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stream_quant_pack_kernel, kThreads, kStreamSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t n_tiles = rows / kRowsPerBlock;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const unsigned int grid =
      static_cast<unsigned int>(n_tiles < resident ? n_tiles : resident);
  const float fs = static_cast<float>(s);
  stream_quant_pack_kernel<<<grid, kThreads, kStreamSmem, stream>>>(
      x, u, q, scales, n_tiles, fs, 1.0f / fs);
  return static_cast<int>(cudaGetLastError());
}

// RC003's resource report (resources.cuh) of kernel idx: 0 B1, 1 B2, 2 B3,
// 3 B6, each as its entry above launches it.
int repro_quant_resources(int idx, long long d_in, long long* out, char* name,
                          int name_len) {
  (void)d_in;
  switch (idx) {
    case 0:
      return static_cast<int>(repro_resources::report(
          (const void*)quant_kernel<false>, "quant_kernel<false>", 4, kThreads, 0, 1,
          false, out, name, name_len));
    case 1:
      return static_cast<int>(repro_resources::report(
          (const void*)quant_kernel<true>, "quant_kernel<true>", 4, kThreads, 0, 1,
          false, out, name, name_len));
    case 2:
      return static_cast<int>(repro_resources::report(
          (const void*)unpack_dequant_kernel, "unpack_dequant_kernel", 4, kThreads, 0,
          1, false, out, name, name_len));
    case 3:
      return static_cast<int>(repro_resources::report(
          (const void*)stream_quant_pack_kernel, "stream_quant_pack_kernel", 4,
          kThreads, kStreamSmem, 1, false, out, name, name_len));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Presence-mask bit packing for Hopper (sm_90a): kernels B4 and B5.
//
// Replaces the JAX package's Pallas TPU kernels
//   B4 repro/kernels/bitpack.py pack_mask_2d   (_pack_kernel)
//   B5 repro/kernels/bitpack.py unpack_mask_2d (_unpack_kernel)
//
// Layout: a (32, W) mask, row-major, one byte per coordinate (bool or uint8;
// B4 reads nonzero as set, B5 writes 0 or 1), and W 32-bit words: bit j of
// word w is mask[j, w].  Seen from a flat mask of d <= 32 W coordinates
// (ops.pack_bits), bit j of word w is mask[j*W + w]: the stride-W order that
// is the sparse_bitmap wire format.  A warp ballot over 32 consecutive
// coordinates would give another order, and payloads would no longer
// cross-decode with the JAX package's.
//
// Bound: bytes (3.35 TB/s on an H100 SXM).  Per coordinate B4 reads 1 B and
// writes 1/8 B; B5 reads 1/8 B and writes 1 B.  The arithmetic (a compare,
// a shift and an or per coordinate) is far below the card's rate.
//
// Design: a first, simple one.  One thread per word: thread w touches the
// 32 bytes j*W + w (j < 32), so for each j a warp reads or writes 32
// consecutive bytes, one 32-byte sector, fully coalesced but one byte per
// thread per access.  Wider accesses (four words per thread, one 4-byte
// access per row) are later work.  Offsets are 64-bit: the main path's
// mask has 1.83e9 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resources.cuh"

namespace {

constexpr int kBits = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_mask_kernel(const uint8_t* __restrict__ mask, uint32_t* __restrict__ words,
                 int64_t w_count) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= w_count) return;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < kBits; ++j)
    word |= static_cast<uint32_t>(mask[j * w_count + w] != 0) << j;
  words[w] = word;
}

__global__ void __launch_bounds__(kThreads)
unpack_mask_kernel(const uint32_t* __restrict__ words, uint8_t* __restrict__ mask,
                   int64_t w_count) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= w_count) return;
  const uint32_t word = words[w];
#pragma unroll
  for (int j = 0; j < kBits; ++j)
    mask[j * w_count + w] = static_cast<uint8_t>((word >> j) & 1u);
}

// Grid for `w_count` words; 0 when the count does not fit a 1-D grid.
unsigned int grid_for(int64_t w_count) {
  const int64_t blocks = (w_count + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned int>(blocks);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each entry launches on `stream`
// without synchronizing and returns cudaGetLastError() (0 on success).
extern "C" {

int repro_pack_mask_2d(const uint8_t* mask, uint32_t* words, long long w_count,
                       cudaStream_t stream) {
  if (w_count <= 0) return 0;
  const unsigned int grid = grid_for(w_count);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  pack_mask_kernel<<<grid, kThreads, 0, stream>>>(mask, words, w_count);
  return static_cast<int>(cudaGetLastError());
}

int repro_unpack_mask_2d(const uint32_t* words, uint8_t* mask, long long w_count,
                         cudaStream_t stream) {
  if (w_count <= 0) return 0;
  const unsigned int grid = grid_for(w_count);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  unpack_mask_kernel<<<grid, kThreads, 0, stream>>>(words, mask, w_count);
  return static_cast<int>(cudaGetLastError());
}

// RC003's resource report (resources.cuh) of kernel idx: 0 B4, 1 B5, each
// as its entry above launches it.
int repro_bitmask_resources(int idx, long long d_in, long long* out, char* name,
                            int name_len) {
  (void)d_in;
  switch (idx) {
    case 0:
      return static_cast<int>(repro_resources::report(
          (const void*)pack_mask_kernel, "pack_mask_kernel", 2, kThreads, 0, 1, false,
          out, name, name_len));
    case 1:
      return static_cast<int>(repro_resources::report(
          (const void*)unpack_mask_kernel, "unpack_mask_kernel", 2, kThreads, 0, 1,
          false, out, name, name_len));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

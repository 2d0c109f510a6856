// Launch-resource report of one kernel, for the lint's RC003 card check
// (python -m repro_torch.lint; repro_torch/lint/contracts.py).
//
// Each .cu file has one plain-C entry, repro_<file>_resources(idx, d_in,
// out, name, name_len), that fills out[kFields] for its kernel `idx` as the
// file's launch entry launches it (d_in matters only to the selecting B8,
// whose dynamic shared memory depends on it).  Host code only: it launches
// nothing and changes no kernel.
#pragma once

#include <cuda_runtime.h>
#include <stdio.h>

namespace repro_resources {

enum Field {
  kCount = 0,        // kernels this file reports
  kThreads,          // threads per block of the launch
  kDynSmem,          // dynamic shared memory per block of the launch
  kClusterSize,      // blocks per cluster (1: no cluster)
  kRegs,             // cudaFuncAttributes::numRegs
  kStaticSmem,       // cudaFuncAttributes::sharedSizeBytes
  kLocal,            // cudaFuncAttributes::localSizeBytes
  kMaxThreads,       // cudaFuncAttributes::maxThreadsPerBlock
  kOccupancy,        // resident blocks per SM, or clusters on the device
  kStaged,           // the selecting B8 staged its keys (else 0)
  kOptin,            // the device's opt-in shared memory per block
  kFields
};

// Fill `out` for `kernel` launched with `threads` x `smem` bytes in clusters
// of `cluster` blocks.  Like the launch, it raises the kernel's dynamic
// shared memory limit first when `smem` exceeds the default 48 KB.
// Occupancy: cudaOccupancyMaxActiveBlocksPerMultiprocessor, or, for a
// cluster launch, cudaOccupancyMaxActiveClusters.
inline cudaError_t report(const void* kernel, const char* label, int count,
                          int threads, size_t smem, int cluster, bool staged,
                          long long* out, char* name, int name_len) {
  int dev = 0, optin = 0, occupancy = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && cluster == 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel, threads, smem);
  } else if (err == cudaSuccess) {
    cudaLaunchAttribute la;
    la.id = cudaLaunchAttributeClusterDimension;
    la.val.clusterDim.x = cluster;
    la.val.clusterDim.y = 1;
    la.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(cluster);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.attrs = &la;
    config.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&occupancy, kernel, &config);
  }
  if (err != cudaSuccess) return err;
  out[kCount] = count;
  out[kThreads] = threads;
  out[kDynSmem] = static_cast<long long>(smem);
  out[kClusterSize] = cluster;
  out[kRegs] = attr.numRegs;
  out[kStaticSmem] = static_cast<long long>(attr.sharedSizeBytes);
  out[kLocal] = static_cast<long long>(attr.localSizeBytes);
  out[kMaxThreads] = attr.maxThreadsPerBlock;
  out[kOccupancy] = occupancy;
  out[kStaged] = staged ? 1 : 0;
  out[kOptin] = optin;
  snprintf(name, static_cast<size_t>(name_len), "%s", label);
  return cudaSuccess;
}

}  // namespace repro_resources

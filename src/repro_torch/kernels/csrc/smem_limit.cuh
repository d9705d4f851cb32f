// allow_smem: let a kernel function take `smem` bytes of dynamic shared
// memory, shared by block_fft.cu, abft_fft.cu and ft_matmul.cu.
//
// Above the default 48 KB a launch needs the function's
// cudaFuncAttributeMaxDynamicSharedMemorySize to be at least its size. The
// attribute belongs to the function on a device, not to one launch, so two
// host threads that launch one function at different sizes race if each
// sets it to its own size: one lowers it between the other's raise and its
// launch (or its cudaOccupancyMaxActiveClusters query), which then fails
// (or reports 0 clusters). allow_smem only ever raises the limit, under one
// lock, and remembers what it set for each (device, function).
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace turbofft {

inline cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex lock;
  static std::map<std::pair<int, const void*>, int> allowed;
  std::lock_guard<std::mutex> held(lock);
  int& limit = allowed[{device, kernel}];
  if (limit >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) limit = smem;
  return err;
}

}  // namespace turbofft

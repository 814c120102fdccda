// Launch set-up done once per (device, kernel), not once per call. Shared by
// the port's CUDA sources.
//
// cudaFuncSetAttribute costs host time on every call that makes it. A
// kernel's C entry instead asks `launch_setup` with the device index its
// wrapper passes in (the wrapper makes that device current): the first call
// for a (device, kernel) opts the kernel in to its largest dynamic shared
// memory, under a lock; every later call finds it in the table. Safe for the
// threads of a serving process.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <utility>

namespace launch_cache {

// `kernel` identifies the instance (its address). On first use for (device,
// kernel): opt it in to `max_smem` bytes of dynamic shared memory (when
// above the 48 KB default).
inline cudaError_t launch_setup(int device, const void* kernel,
                                size_t max_smem) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(device, kernel);
  if (done.count(key)) return cudaSuccess;
  if (max_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(max_smem));
    if (e != cudaSuccess) return e;
  }
  done.insert(key);
  return cudaSuccess;
}

}  // namespace launch_cache

// The opt-in above 48 KB of dynamic shared memory, once per device.
//
// CUDA keeps a function's attributes per device: cudaFuncSetAttribute on
// one card does not raise a kernel's limit on another, and a launch there
// asking for more than 48 KB is refused.  So each kernel records the size
// it was granted for each device ordinal (cudaGetDevice: the wrappers set
// the tensors' device as current before a launch), and a process that
// drives several cards opts in on each of them the first time it launches
// there.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace ta3n {

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared memory limit on the current device to at
// least `bytes` (and, with wide_clusters, let it launch in clusters of up
// to 16 blocks, past the portable 8).  `granted` is the kernel's own
// table, one slot a device ordinal, holding the largest size granted
// there (0: none yet).
template <class Kernel>
cudaError_t allow_smem_on_device(Kernel kernel, std::atomic<int>* granted,
                                 int bytes, bool wide_clusters = false) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = granted[device];
  if (bytes <= slot.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && wide_clusters)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  int seen = slot.load(std::memory_order_relaxed);
  while (seen < bytes &&
         !slot.compare_exchange_weak(seen, bytes, std::memory_order_release,
                                     std::memory_order_relaxed)) {
  }
  return cudaSuccess;
}

}  // namespace ta3n

// The per-device launch state the sources keep: the current device and its
// number of SMs, and a kernel's limit of dynamic shared memory raised once a
// device.  Included by scanline_tiles.cuh, walker.cuh and region_voting.cu.
//
// Everything here lies in an unnamed namespace: each source that includes
// the header has its own copy.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

// The most devices whose per-device state (launch attributes, side streams)
// a source keeps.
constexpr int MAX_DEVICES = 64;

// The current device and its number of SMs (kept per device; the first
// calls of two host threads may both read it).
inline cudaError_t current_device(int* device, int* sm_count) {
  static std::atomic<int> sms[MAX_DEVICES];  // 0 at first
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int n = sms[*device].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *device);
    if (err != cudaSuccess) return err;
    sms[*device].store(n, std::memory_order_relaxed);
  }
  *sm_count = n;
  return cudaSuccess;
}

// Raises a kernel's limit of dynamic shared memory to `bytes` on the current
// device once: `done` is the caller's flag of that kernel and device.  The
// first calls of two host threads may both set it, which does no harm.
template <typename Kernel>
cudaError_t allow_shared_bytes(std::atomic<bool>& done, Kernel* kernel, size_t bytes) {
  if (done.load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.store(true, std::memory_order_release);
  return err;
}

}  // namespace

// What the two strip walkers of the aggregation share: the rect mean's
// (aggregate.cu, rect_walker_kernel) and the cross aggregation's
// (cross_aggregate.cu, cross_walker_kernel).  Both keep a ring of float64
// table rows in shared memory and bring their input rows in by cp.async one
// step ahead; each sizes its blocks against the same shared-memory limit and
// sets its launch attributes once a device.
//
// Everything here lies in an unnamed namespace: each source that includes
// the header has its own copy.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "device.cuh"

namespace {

constexpr size_t WALK_SHARED_LIMIT = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace

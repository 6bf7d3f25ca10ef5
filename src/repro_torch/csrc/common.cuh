// Shared launch helpers of the repro_torch CUDA kernels.
//
// Every launch function has a plain C interface (pointers, sizes, the
// stream), launches on the stream it is given, does not synchronise,
// allocates nothing, and returns cudaGetLastError() — 0 on success — which
// the Python wrapper turns into an exception.
#pragma once

#include <cuda_runtime.h>

constexpr int kThreads = 256;  // threads per block of every kernel here

static inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// Asynchronous copies from device to shared memory (sm_80+): `cp.async`
// with zero fill — `bytes` 0 writes zeros and reads nothing, so a masked
// row or column never touches device memory.  The 16-byte form bypasses
// L1 (cg), the 4-byte one cannot (ca).  A group of copies is committed,
// then waited for with at most `kPending` younger groups still in flight.
static __device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}
static __device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
static __device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

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

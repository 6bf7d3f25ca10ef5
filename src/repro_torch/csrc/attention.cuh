// Shared pieces of the two attention kernels (flash_attention.cu,
// flash_decode.cu): the softmax sentinel and reductions over lane groups
// (element types in floats.cuh).
#pragma once

#include "floats.cuh"

// masked scores take this value and the running maximum starts at it, as in
// the TPU kernels (not -inf: exp(m_prev - m_new) stays finite)
constexpr float kNegInf = -1e30f;

// max / sum over aligned groups of `kWidth` lanes (kWidth a power of two <= 32);
// every lane of the warp must call it
template <int kWidth>
static __device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, off));
  return x;
}
template <int kWidth>
static __device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
  return x;
}

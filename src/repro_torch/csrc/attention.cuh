// Shared pieces of the two attention kernels (flash_attention.cu,
// flash_decode.cu): element types, the softmax sentinel and reductions over
// lane groups.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

// masked scores take this value and the running maximum starts at it, as in
// the TPU kernels (not -inf: exp(m_prev - m_new) stays finite)
constexpr float kNegInf = -1e30f;

// element type codes of the launch functions (cuda_build.FLOAT_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

static __device__ __forceinline__ float to_f32(float x) { return x; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
static __device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

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

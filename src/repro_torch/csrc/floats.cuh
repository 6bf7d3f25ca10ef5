// Element types of the floating-point kernels: the codes their launch
// functions take (cuda_build.FLOAT_CODES) and the conversions to and from
// the float32 every one of them computes in.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

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

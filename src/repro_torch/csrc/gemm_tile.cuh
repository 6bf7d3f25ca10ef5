// The inner loop of moe_gemm.cu's float32 CUDA-core route (cin_interaction.cu
// has its own, with a larger register tile): a block of kGemmThreads threads holds a
// (BM x BN) tile of the output, one (TM x TN) register tile per thread, and
// adds the product of a (BK x BM) tile of the left operand, stored
// transposed, and a (BK x BN) tile of the right one, both in shared memory,
// with float32 FMAs on the CUDA cores (no TF32: the products are the
// float32 products the plain versions take).
//
// Thread (tm, tn), tid = tm * THR_N + tn, owns rows tm * TM + r (r < TM) and
// the columns gemm_col<TN, THR_N>(tn, c) (c < TN): groups of up to four
// consecutive columns, THR_N * 4 apart, so that a warp reads a row of the
// right tile as consecutive words.
#pragma once

#include "common.cuh"

constexpr int kGemmThreads = 256;

template <int TN, int THR_N>
static __device__ __forceinline__ int gemm_col(int tn, int c) {
  constexpr int kV = TN < 4 ? TN : 4;
  return (c / kV) * (THR_N * kV) + tn * kV + (c % kV);
}

// acc += A^T-tile (as[k * lda + m]) x B-tile (bs[k * BN + n]) over BK steps;
// bs 16-byte aligned and BN a multiple of 4 when TN is
template <int TM, int TN, int THR_N, int BN, int BK>
static __device__ __forceinline__ void gemm_tile_fma(const float* as, int lda, const float* bs,
                                                     int tm, int tn, float (&acc)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM];
    float b[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) a[r] = as[kk * lda + tm * TM + r];
    if constexpr (TN % 4 == 0) {
      // one 16-byte load per group: a warp's loads then take the fewest
      // shared-memory wavefronts (scalar loads 4 words apart would conflict)
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(bs + kk * BN + q * THR_N * 4 + tn * 4);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = bs[kk * BN + gemm_col<TN, THR_N>(tn, c)];
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

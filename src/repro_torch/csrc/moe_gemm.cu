// moe_gemm: the grouped expert product over the MoE dispatch buffer.
//
// Replaces the TPU kernel `moe_gemm_call` of
// src/repro/kernels/moe_gemm/kernel.py:51 (with its op,
// src/repro/kernels/moe_gemm/ops.py:11).  Contract:
//
//   buf (E, C, D), w (E, D, F), each float32 or bf16 and contiguous;
//   out (E, C, F) float32, out[e, c, f] = sum over d of buf[e, c, d] *
//   w[e, d, f], each operand widened to float32 and summed with float32
//   FMAs (a bf16 x bf16 product is exact in float32).
//
// The Pallas kernel runs one MXU product per (expert, 128-row, 512-column)
// grid step with a VMEM accumulator carried across the D steps, C padded to
// 128 and D, F to 512.  Here one launch covers every expert (grid z); a
// block owns a (BM x BN) output tile of one expert and loops over D in
// slices of 16, staging both slices in shared memory as float32; nothing is
// padded — at decode C is 1 and F = 1,408 is no multiple of 512 — and the
// ragged edges are masked.  Two tile shapes: (64 x 128) with 4 x 8 outputs a
// thread for prefill-sized C, and (4 x 256), one column a thread, for C <= 4
// (decode), where a wider row tile would spend its FMAs on masked rows.
//
// Bound on this card: at prefill operations — 2 * E * C * D * F FLOPs; the
// data sheet's peak for bf16 operands is the tensor cores' 989 TFLOP/s,
// which this first design (CUDA-core FMAs, at most 67 TFLOP/s) cannot reach;
// at decode bytes — the E * D * F weights once over 3.35 TB/s.
#include "floats.cuh"
#include "gemm_tile.cuh"

namespace {

constexpr int kBK = 16;

template <typename AT, typename BT, int TM, int TN, int THR_M, int THR_N>
__global__ void __launch_bounds__(kGemmThreads)
moe_gemm_kernel(const AT* __restrict__ buf, const BT* __restrict__ w, float* __restrict__ out,
                int c, int d, int f) {
  constexpr int kBM = TM * THR_M;
  constexpr int kBN = TN * THR_N;
  constexpr int kLda = kBM + 1;  // the transposed left tile, padded against bank conflicts
  static_assert(THR_M * THR_N == kGemmThreads, "one thread per register tile");
  __shared__ __align__(16) float as[kBK * kLda];  // buf slice, [d][c]
  __shared__ __align__(16) float bs[kBK * kBN];   // w slice, [d][f]
  const int tid = threadIdx.x;
  const int tm = tid / THR_N;
  const int tn = tid % THR_N;
  const long long ex = blockIdx.z;
  const int c0 = blockIdx.y * kBM;
  const int f0 = blockIdx.x * kBN;
  const AT* a = buf + ex * c * d;
  const BT* b = w + ex * d * f;
  float* o = out + ex * c * f;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;
  }

  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int e = tid; e < kBK * kBM; e += kGemmThreads) {
      const int kk = e % kBK;  // neighbouring threads on neighbouring d
      const int mm = e / kBK;
      const int row = c0 + mm;
      const int col = k0 + kk;
      as[kk * kLda + mm] =
          (row < c && col < d) ? to_f32(a[static_cast<long long>(row) * d + col]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
      const int kk = e / kBN;
      const int nn = e - kk * kBN;
      const int row = k0 + kk;
      const int col = f0 + nn;
      bs[e] = (row < d && col < f) ? to_f32(b[static_cast<long long>(row) * f + col]) : 0.f;
    }
    __syncthreads();
    gemm_tile_fma<TM, TN, THR_N, kBN, kBK>(as, kLda, bs, tm, tn, acc);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = c0 + tm * TM + r;
    if (row >= c) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int col = f0 + gemm_col<TN, THR_N>(tn, q);
      if (col < f) o[static_cast<long long>(row) * f + col] = acc[r][q];
    }
  }
}

template <typename AT, typename BT, int TM, int TN, int THR_M, int THR_N>
int launch(const void* buf, const void* w, float* out, int e, int c, int d, int f,
           cudaStream_t stream) {
  constexpr int kBM = TM * THR_M;
  constexpr int kBN = TN * THR_N;
  const dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, e);
  moe_gemm_kernel<AT, BT, TM, TN, THR_M, THR_N><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const AT*>(buf), static_cast<const BT*>(w), out, c, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename AT, typename BT>
int launch_tile(const void* buf, const void* w, float* out, int e, int c, int d, int f,
                cudaStream_t stream) {
  if (c <= 4) return launch<AT, BT, 4, 1, 1, 256>(buf, w, out, e, c, d, f, stream);
  return launch<AT, BT, 4, 8, 16, 16>(buf, w, out, e, c, d, f, stream);
}

}  // namespace

// (buf, w, out, E, C, D, F, buf dtype, w dtype, stream)
extern "C" int moe_gemm_launch(const void* buf, const void* w, float* out, int e, int c, int d,
                               int f, int buf_dtype, int w_dtype, cudaStream_t stream) {
  if (e <= 0 || c <= 0 || f <= 0) return 0;
  if (d < 0 || e > 65535 || (buf_dtype != kF32 && buf_dtype != kBF16)
      || (w_dtype != kF32 && w_dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf16 = __nv_bfloat16;
  if (buf_dtype == kBF16) {
    return w_dtype == kBF16 ? launch_tile<bf16, bf16>(buf, w, out, e, c, d, f, stream)
                            : launch_tile<bf16, float>(buf, w, out, e, c, d, f, stream);
  }
  return w_dtype == kBF16 ? launch_tile<float, bf16>(buf, w, out, e, c, d, f, stream)
                          : launch_tile<float, float>(buf, w, out, e, c, d, f, stream);
}

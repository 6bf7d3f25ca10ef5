// cin_layer: one xDeepFM CIN layer without the outer-product tensor.
//
// Replaces the TPU kernel `cin_layer_call` of
// src/repro/kernels/cin_interaction/kernel.py:49 (with its op,
// src/repro/kernels/cin_interaction/ops.py:11).  Contract:
//
//   x0 (B, m, D), xk (B, Hk, D), w (m * Hk, H), all float32 and contiguous;
//   out (B, H, D) float32,
//     out[b, h, d] = sum over i < m, j < Hk of w[i * Hk + j, h] * z,
//     z = x0[b, i, d] * xk[b, j, d] rounded to float32 (as the plain
//   version's einsum forms it), summed with float32 FMAs.  (The module
//   docstring of the TPU kernel writes W[h, i*Hk + j]: transposed; its code,
//   followed here, indexes w[i*Hk + j, h].)
//
// As a matrix product: M = H, K = m * Hk, N = B * D, out[h, n] with
// n = b * D + d.  The TPU kernel forms the (BBLK, m*Hk, 128) interaction
// tile in VMEM for 8 batch rows at a time and hands it to the MXU with all
// of W resident (B padded to 8, D to 128).  Here a block owns a (40 x 256)
// tile of (h, n) and walks K in steps of 16: it loads the (16 x 40) slice
// of W and forms the (16 x 256) slice of the right operand in shared
// memory, one column per thread, from x0 and xk — the outer product never
// reaches device memory, and no axis is padded (ragged edges are masked).
// W (6.2 MB at m = 39, Hk = H = 200) is streamed in K-slices and stays in
// L2.  K is walked with i inner (k' = j * m + i) so that a thread keeps
// xk[b, j, d] in a register across m steps and x0's m values of its column
// stay in L1.  40 rows divide H = 200, so no block computes dead rows.
//
// Bound on this card: operations — 2 * H * m * Hk * B * D float32 FLOPs over
// 67 TFLOP/s (the outer product adds one multiply per K*N element, which a
// block repeats for each of its H / 40 row tiles).
#include "gemm_tile.cuh"

namespace {

constexpr int kTM = 5;
constexpr int kTN = 8;
constexpr int kThrM = 8;
constexpr int kThrN = 32;
constexpr int kBM = kTM * kThrM;  // 40 rows of h
constexpr int kBN = kTN * kThrN;  // 256 columns of n = b * D + d
constexpr int kBK = 16;
static_assert(kThrM * kThrN == kGemmThreads, "one thread per register tile");
static_assert(kBN == kGemmThreads, "one right-tile column per thread");

__global__ void __launch_bounds__(kGemmThreads)
cin_layer_kernel(const float* __restrict__ x0, const float* __restrict__ xk,
                 const float* __restrict__ w, float* __restrict__ out, long long n_total,
                 int m, int hk, int h, int d) {
  __shared__ __align__(16) float ws[kBK * kBM];  // W slice, [k'][h]
  __shared__ __align__(16) float zs[kBK * kBN];  // outer-product slice, [k'][n]
  const int tid = threadIdx.x;
  const int tm = tid / kThrN;
  const int tn = tid % kThrN;
  const long long n0 = blockIdx.x * static_cast<long long>(kBN);
  const int h0 = blockIdx.y * kBM;
  const int kdim = m * hk;

  // the column of the right tile this thread forms: n = n0 + tid
  const long long zn = n0 + tid;
  const bool zlive = zn < n_total;
  const long long zb = zlive ? zn / d : 0;
  const int zd = zlive ? static_cast<int>(zn - zb * d) : 0;
  const float* x0c = x0 + zb * m * d + zd;                               // x0[zb, i, zd]
  const float* xkc = xk + zb * static_cast<long long>(hk) * d + zd;      // xk[zb, j, zd]

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    for (int e = tid; e < kBK * kBM; e += kGemmThreads) {
      const int kk = e / kBM;
      const int mm = e - kk * kBM;
      const int kp = k0 + kk;
      const int hh = h0 + mm;
      float val = 0.f;
      if (kp < kdim && hh < h) {
        const int j = kp / m;
        const int i = kp - j * m;
        val = w[(static_cast<long long>(i) * hk + j) * h + hh];
      }
      ws[e] = val;
    }
    {
      int j = k0 / m;
      int i = k0 - j * m;
      float xkv = zlive ? xkc[static_cast<long long>(j) * d] : 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float z = 0.f;
        if (zlive && k0 + kk < kdim) z = x0c[static_cast<long long>(i) * d] * xkv;
        zs[kk * kBN + tid] = z;
        if (++i == m) {
          i = 0;
          ++j;
          if (zlive && j < hk) xkv = xkc[static_cast<long long>(j) * d];
        }
      }
    }
    __syncthreads();
    gemm_tile_fma<kTM, kTN, kThrN, kBN, kBK>(ws, kBM, zs, tm, tn, acc);
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kTN; ++c) {
    const long long n = n0 + gemm_col<kTN, kThrN>(tn, c);
    if (n >= n_total) continue;
    const long long b = n / d;
    const int dd = static_cast<int>(n - b * d);
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
      const int hh = h0 + tm * kTM + r;
      if (hh < h) out[(b * h + hh) * d + dd] = acc[r][c];
    }
  }
}

}  // namespace

// (x0, xk, w, out, B, m, Hk, H, D, stream)
extern "C" int cin_layer_launch(const float* x0, const float* xk, const float* w, float* out,
                                long long b, int m, int hk, int h, int d,
                                cudaStream_t stream) {
  if (b <= 0 || h <= 0 || d <= 0) return 0;
  if (m <= 0 || hk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_total = b * d;
  const dim3 grid(static_cast<unsigned int>((n_total + kBN - 1) / kBN),
                  static_cast<unsigned int>((h + kBM - 1) / kBM));
  cin_layer_kernel<<<grid, kGemmThreads, 0, stream>>>(x0, xk, w, out, n_total, m, hk, h, d);
  return static_cast<int>(cudaGetLastError());
}

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
// of W resident (B padded to 8, D to 128).  Here it is an SGEMM on the CUDA
// cores whose right operand is formed on chip and never written to device
// memory; no axis is padded (ragged edges are masked or zero-filled).
//
// Bound on this card: operations — 2 * H * m * Hk * B * D float32 FLOPs over
// 67 TFLOP/s (plus one multiply per K * N element for the outer product).
// The design aims at that rate:
//
// * Tiles.  A block of 160 threads owns a (200 x 64) tile of (h, n): 200
//   rows, so H = 200 (every xDeepFM CIN layer) is one row tile with no dead
//   row, and z is formed once per column.  Each thread keeps a (10 x 8)
//   register tile: 80 float32 accumulators.  Its rows are two groups of 4
//   and one of 2 (tm*4, 80 + tm*4, 160 + tm*2) and its columns two groups
//   of 4 (tn*4, 32 + tn*4), so a step of the inner loop reads its A and B
//   fragments from shared memory as 2 + 1 + 2 vector loads; a warp holds
//   4 rows x 8 columns of threads, so each load takes one wavefront: 5
//   wavefronts per 80 warp-FMAs (the first port's 5 x 8 tile took 13 per
//   40), a quarter of a wavefront per FMA issue clock.
// * K order.  K is walked as k' = j * m + i (i inner), the indices carried
//   from row to row (no integer divide in the loop): a thread forming a
//   column of z keeps xk[b, j, d] in a register across m rows and re-reads
//   x0[b, i, d] from L1 (its m values per column stay there); the W rows of
//   a step, w[i * Hk + j, h0 : h0 + 200], are each contiguous.
// * Double buffering, one barrier per K step of 16.  While the block
//   multiplies step s out of one pair of shared buffers, the W slice of
//   step s + 1 arrives in the other by `cp.async` (16-byte copies when w's
//   rows are 16-byte aligned, H a multiple of 4; 4-byte copies else; 10
//   threads a row, each carrying its row's indices), and 128 threads form
//   step s + 1's z (8 rows of one column each) before the step's FMAs:
//   x0 / xk come from L1, and the other warps' FMAs cover the wait (holding
//   those values in registers across the FMAs spilled at 3 blocks an SM and
//   ran slower on the card).  Two instances: 128 registers a
//   thread, 3 blocks an SM, when the grid fills every SM with three blocks
//   (serve_bulk); up to 204 registers where it does not (a 512-row batch is
//   80 blocks, one an SM).
// * The epilogue writes the tile through shared memory, so that a warp
//   stores consecutive columns of one row: consecutive addresses.
//
// Numerics: unchanged from the first port and the plain version — every z
// rounded once to float32, every product added by a float32 FMA (round to
// nearest; TF32 plays no part), in the k' order above.  A float32 sum of n
// terms in any order lies within gamma_n of the sum of their magnitudes;
// chip_smoke.py holds each element within 2 gamma_(m Hk + 2) of it.
//
// Why not the tensor cores.  A split-precision scheme (A and B each as the
// sum of two TF32 terms, three products) would add with truncation, which
// puts its first-order error at the edge of that 2 gamma_n limit; `mma.sync`
// in TF32 barely beats a good SIMT kernel on this card, and `wgmma` in TF32
// takes both operands K-major, the formed z swizzled by hand; and a kernel
// faster than its own float32 bound would read over 100 % of the roofline
// PERF.md states for this work.  So this is a float32 CUDA-core kernel.
#include "common.cuh"

namespace {

constexpr int kTM = 10;  // rows of h a thread
constexpr int kTN = 8;   // columns of n a thread
constexpr int kThrM = 20;
constexpr int kThrN = 8;
constexpr int kCinThreads = kThrM * kThrN;  // 160
constexpr int kBM = kTM * kThrM;            // 200 rows of h
constexpr int kBN = kTN * kThrN;            // 64 columns of n = b * D + d
constexpr int kBK = 16;
constexpr int kZThreads = 2 * kBN;               // threads that form z: 128
constexpr int kZRows = kBK * kBN / kZThreads;    // rows of a step each forms: 8
static_assert(kZThreads <= kCinThreads && kZRows * 2 == kBK, "two z threads a column");
constexpr int kWThreads = kCinThreads / kBK;  // threads that copy one W row of a slice: 10
// shared memory: two W and two z slices in the loop, the output tile after it
constexpr int kLoopFloats = 2 * kBK * kBM + 2 * kBK * kBN;
constexpr int kSmemBytes = 4 * (kLoopFloats > kBM * kBN ? kLoopFloats : kBM * kBN);
static_assert(kWThreads * kBK == kCinThreads, "whole W rows a thread group");

// row r of thread tm's register tile, and column c of thread tn's
__device__ __forceinline__ int tile_row(int tm, int r) {
  return r < 4 ? tm * 4 + r : r < 8 ? 4 * kThrM + tm * 4 + (r - 4) : 8 * kThrM + tm * 2 + (r - 8);
}
__device__ __forceinline__ int tile_col(int tn, int c) {
  return c < 4 ? tn * 4 + c : 4 * kThrN + tn * 4 + (c - 4);
}

template <bool kW16, int kMinBlocks>
__global__ void __launch_bounds__(kCinThreads, kMinBlocks)
cin_layer_kernel(const float* __restrict__ x0, const float* __restrict__ xk,
                 const float* __restrict__ w, float* __restrict__ out, long long n_total,
                 int m, int hk, int h, int d) {
  extern __shared__ __align__(16) float smem[];
  float* const ws = smem;                 // two W slices, [k'][h], kBK * kBM apart
  float* const zs = smem + 2 * kBK * kBM;  // two z slices, [k'][n], kBK * kBN apart
  const int tid = threadIdx.x;
  const int tm = tid / kThrN;
  const int tn = tid % kThrN;
  const long long n0 = blockIdx.x * static_cast<long long>(kBN);
  const int h0 = blockIdx.y * kBM;
  const int n_steps = (m * hk + kBK - 1) / kBK;

  // z: thread tid < kZThreads forms column zc, rows zh * kZRows + e of each
  // step; (zi, zj) are the indices of the next row it forms (k' = zj m + zi)
  const bool zthread = tid < kZThreads;
  const int zc = tid % kBN;
  const int zh = zthread ? tid / kBN : 0;
  const long long zn = n0 + zc;
  const bool zlive = zthread && zn < n_total;
  const long long zb = zlive ? zn / d : 0;
  const int zd = zlive ? static_cast<int>(zn - zb * d) : 0;
  const float* x0c = x0 + zb * m * d + zd;                           // x0[zb, i, zd] at i d
  const float* xkc = xk + zb * static_cast<long long>(hk) * d + zd;  // xk[zb, j, zd] at j d
  int zi = zh * kZRows;
  int zj = 0;
  while (zi >= m) {
    zi -= m;
    ++zj;
  }
  float xkv = zlive && zj < hk ? xkc[static_cast<long long>(zj) * d] : 0.f;
  float x0r[kZRows], xkr[kZRows];
  // the x0 / xk values of this thread's rows of the next step, then on by kBK rows
  auto fetch_z = [&]() {
#pragma unroll
    for (int e = 0; e < kZRows; ++e) {
      const bool live = zlive && zj < hk;
      x0r[e] = live ? x0c[zi * d] : 0.f;
      xkr[e] = live ? xkv : 0.f;
      if (++zi == m) {
        zi = 0;
        ++zj;
        xkv = zlive && zj < hk ? xkc[static_cast<long long>(zj) * d] : 0.f;
      }
    }
    zi += kBK - kZRows;
    while (zi >= m) {
      zi -= m;
      ++zj;
      xkv = zlive && zj < hk ? xkc[static_cast<long long>(zj) * d] : 0.f;
    }
  };
  auto store_z = [&](float* zbuf) {
#pragma unroll
    for (int e = 0; e < kZRows; ++e) zbuf[(zh * kZRows + e) * kBN + zc] = x0r[e] * xkr[e];
  };

  // W: thread tid loads row wk of each slice, kWThreads threads to a row;
  // (wi, wj) are that row's indices in the next slice to load
  const int wk = tid / kWThreads;
  const int wp = tid % kWThreads;
  int wi = wk;
  int wj = 0;
  while (wi >= m) {
    wi -= m;
    ++wj;
  }
  auto load_w = [&](float* wbuf) {
    constexpr int kPer = kW16 ? kBM / 4 : kBM;  // copies a row
    const bool row_live = wj < hk;
    const float* src = w + (static_cast<long long>(wi) * hk + wj) * h + h0;
    for (int q = wp; q < kPer; q += kWThreads) {
      const int c = q * (kW16 ? 4 : 1);
      const bool live = row_live && h0 + c < h;
      if constexpr (kW16) {
        cp_async16(wbuf + wk * kBM + c, live ? src + c : w, live);
      } else {
        cp_async4(wbuf + wk * kBM + c, live ? src + c : w, live);
      }
    }
    wi += kBK;
    while (wi >= m) {
      wi -= m;
      ++wj;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;
  }

  if (zthread) fetch_z();
  load_w(ws);
  cp_async_commit();
  if (zthread) store_z(zs);
  cp_async_wait<0>();
  __syncthreads();
  for (int step = 0; step < n_steps; ++step) {
    const int cur = step & 1;
    const bool more = step + 1 < n_steps;
    if (more) {
      load_w(ws + (cur ^ 1) * kBK * kBM);
      cp_async_commit();
      if (zthread) {
        fetch_z();
        store_z(zs + (cur ^ 1) * kBK * kBN);
      }
    }
    const float* as = ws + cur * kBK * kBM;
    const float* bs = zs + cur * kBK * kBN;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kBM + tm * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kBM + 4 * kThrM + tm * 4);
      const float2 a2 = *reinterpret_cast<const float2*>(as + kk * kBM + 8 * kThrM + tm * 2);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kBN + tn * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kBN + 4 * kThrN + tn * 4);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y};
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
    }
    if (more) {
      cp_async_wait<0>();
    }
    __syncthreads();  // the next buffers are full, and this step's are free
  }

  // the (200 x 64) tile through shared memory (the loop's last barrier freed
  // it), then out a row of the tile at a time: consecutive columns n = b D +
  // dd of row h lie at consecutive addresses (b H + h) D + dd within each b
  float* tile = smem;  // [kBM][kBN]
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q) {
      *reinterpret_cast<float4*>(tile + tile_row(tm, r) * kBN + tile_col(tn, 4 * q)) =
          make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
    }
  }
  __syncthreads();
  const int rows = h - h0 < kBM ? h - h0 : kBM;
  for (int e = tid; e < rows * kBN; e += kCinThreads) {
    const long long n = n0 + e % kBN;
    if (n < n_total) {
      const long long b = n / d;
      out[(b * h + h0 + e / kBN) * d + (n - b * d)] = tile[e];
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
  // 16-byte copies of w's rows when every row starts 16-byte aligned; at
  // most 136 registers a thread (3 blocks an SM) when the grid fills three
  // blocks on every SM, else up to 204 (a small batch: one block an SM)
  const bool w16 = reinterpret_cast<unsigned long long>(w) % 16 == 0 && h % 4 == 0;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool full = static_cast<long long>(grid.x) * grid.y >= 3LL * sms;
  auto kernel = !w16 ? cin_layer_kernel<false, 2>
                     : full ? cin_layer_kernel<true, 3> : cin_layer_kernel<true, 2>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kCinThreads, kSmemBytes, stream>>>(x0, xk, w, out, n_total, m, hk, h, d);
  return static_cast<int>(cudaGetLastError());
}

// moe_gemm: the grouped expert product over the MoE dispatch buffer.
//
// Replaces the TPU kernel `moe_gemm_call` of
// src/repro/kernels/moe_gemm/kernel.py:51 (with its op,
// src/repro/kernels/moe_gemm/ops.py:11).  Contract:
//
//   buf (E, C, D), w (E, D, F), each float32 or bf16 and contiguous;
//   out (E, C, F) float32, out[e, c, f] = sum over d of buf[e, c, d] *
//   w[e, d, f], each product exact in float32 (a bf16 x bf16 product is),
//   summed in float32 in some order.
//
// The Pallas kernel runs one MXU product per (expert, 128-row, 512-column)
// grid step with a VMEM accumulator carried across the D steps, C padded to
// 128 and D, F to 512.  Here one launch covers every expert (grid z) and
// nothing is padded.  The wrapper picks one of three routes from dtypes,
// shapes and alignment alone (kernels/moe_gemm/ops.py `moe_gemm_route`) and
// passes it in; a launch whose operands do not fit its route is refused.
//
// * wgmma (bf16 x bf16, D and F multiples of 8, 16-byte aligned operands;
//   prefill).  Bound: operations, 2 E C D F FLOPs over the tensor cores'
//   989 TFLOP/s.  One block per (expert, 128-row, 128-column) output tile:
//   a producer warp keeps a 3-stage TMA ring of (128 x 64) buf slices and
//   (64 x 128) w slices in flight (128-byte swizzle, 32 KB a stage; zeros
//   fill the ragged C, D and F edges), two consumer warpgroups each run
//   wgmma m64n128k16 on 64 rows (buf a K-major A, w row-major an MN-major B
//   read with the transpose bit), the float32 accumulators stay in
//   registers, and the epilogue writes them with the ragged C / F edges
//   masked.  Two blocks share an SM, so one's epilogue overlaps the other's
//   loads.  Tensor cores add with truncation, not round to nearest (Fasi,
//   Higham, Mikaitis, Pranesh 2021): a sum of n products is within n 2^-23
//   of the sum of their magnitudes to first order, which the check's
//   2 gamma_(D+1) (u = 2^-24) covers.
// * small_c (bf16 x bf16, C <= 8, F a multiple of 8, w 16-byte aligned;
//   decode).  Bound: bytes, the E D F weights read once over 3.35 TB/s.
//   Each thread reads 16 bytes of w (8 columns) a row, straight from device
//   memory, and keeps C x 8 float32 sums; the 8 warps of a block split D
//   and add their sums once through shared memory, in warp order.
// * fma (everything else: float32 or mixed operands, bf16 shapes the other
//   two cannot take).  The CUDA-core kernel of the first port: a block owns
//   a (BM x BN) tile and loops over D in slices of 16 staged in shared
//   memory as float32; (64 x 128) tiles with 4 x 8 outputs a thread, or
//   (4 x 256) for C <= 4.  Bound: 2 E C D F FLOPs over the float32 rate
//   (67 TFLOP/s) for float32 operands.
#include "floats.cuh"
#include "gemm_tile.cuh"
#include "wgmma.cuh"

namespace {

// ---- the fma route ----

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

// ---- the small_c route ----
constexpr int kScWarps = 8;
constexpr int kScCols = 8 * 32;  // columns of a block: 8 a lane
constexpr int kScUnroll = 4;     // rows of w in flight a warp

// acc[r][q] += buf row r's value at d-index k times the 8 bf16 of w in v
template <int NC>
static __device__ __forceinline__ void add_w_row(float (&acc)[NC][8], const __nv_bfloat16* a,
                                                 int d, int k, const uint4& v) {
  const __nv_bfloat16* wv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int r = 0; r < NC; ++r) {
    const float x = __bfloat162float(a[static_cast<long long>(r) * d + k]);
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(x, __bfloat162float(wv[q]), acc[r][q]);
  }
}

// NC == C, the rows of every expert
template <int NC>
__global__ void __launch_bounds__(kScWarps * 32)
moe_gemm_small_c_kernel(const __nv_bfloat16* __restrict__ buf,
                        const __nv_bfloat16* __restrict__ w, float* __restrict__ out, int d,
                        int f) {
  extern __shared__ float part[];  // [kScWarps][NC][kScCols]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long ex = blockIdx.y;
  const int col = blockIdx.x * kScCols + lane * 8;
  const __nv_bfloat16* a = buf + ex * NC * d;
  const __nv_bfloat16* b = w + ex * d * f + col;

  float acc[NC][8];
#pragma unroll
  for (int r = 0; r < NC; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;

  if (col < f) {  // f is a multiple of 8: a lane's 8 columns live together
    // warp `warp` takes rows warp, warp + 8, ...; kScUnroll of them in flight
    int k = warp;
    for (; k + (kScUnroll - 1) * kScWarps < d; k += kScUnroll * kScWarps) {
      uint4 v[kScUnroll];
#pragma unroll
      for (int u = 0; u < kScUnroll; ++u) {
        const long long row = k + u * kScWarps;
        v[u] = __ldg(reinterpret_cast<const uint4*>(b + row * f));
      }
#pragma unroll
      for (int u = 0; u < kScUnroll; ++u) add_w_row<NC>(acc, a, d, k + u * kScWarps, v[u]);
    }
    for (; k < d; k += kScWarps) {
      add_w_row<NC>(acc, a, d, k,
                    __ldg(reinterpret_cast<const uint4*>(b + static_cast<long long>(k) * f)));
    }
  }
#pragma unroll
  for (int r = 0; r < NC; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) part[(warp * NC + r) * kScCols + lane * 8 + q] = acc[r][q];
  __syncthreads();
  // thread t adds column t's sums over the warps, in warp order, row by row
  const int oc = blockIdx.x * kScCols + threadIdx.x;
  if (oc < f) {
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kScWarps; ++p) s += part[(p * NC + r) * kScCols + threadIdx.x];
      out[(ex * NC + r) * f + oc] = s;
    }
  }
}

template <int NC>
int launch_small_c(const void* buf, const void* w, float* out, int e, int d, int f,
                   cudaStream_t stream) {
  const int bytes = kScWarps * NC * kScCols * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_small_c_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((f + kScCols - 1) / kScCols, e);
  moe_gemm_small_c_kernel<NC><<<grid, kScWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(buf), static_cast<const __nv_bfloat16*>(w), out, d, f);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kSmallC = 8;  // most rows the small_c route takes

int launch_small_c_any(const void* buf, const void* w, float* out, int e, int c, int d, int f,
                       cudaStream_t stream) {
  switch (c) {
    case 1: return launch_small_c<1>(buf, w, out, e, d, f, stream);
    case 2: return launch_small_c<2>(buf, w, out, e, d, f, stream);
    case 3: return launch_small_c<3>(buf, w, out, e, d, f, stream);
    case 4: return launch_small_c<4>(buf, w, out, e, d, f, stream);
    case 5: return launch_small_c<5>(buf, w, out, e, d, f, stream);
    case 6: return launch_small_c<6>(buf, w, out, e, d, f, stream);
    case 7: return launch_small_c<7>(buf, w, out, e, d, f, stream);
    case 8: return launch_small_c<8>(buf, w, out, e, d, f, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the wgmma route ----
constexpr int kTcBM = 128;                    // output rows of a block (two warpgroups of 64)
constexpr int kTcBN = 128;                    // output columns of a block
constexpr int kTcBK = 64;                     // d-values of a stage: one 128-byte row
constexpr int kTcStages = 3;
constexpr int kTcThreads = 288;               // warps 0-7 consume, warp 8 produces
constexpr int kTcA = kTcBM * kTcBK;           // bf16 of a buf slice (16 KB)
constexpr int kTcBHalf = kTcBK * 64;          // bf16 of 64 columns of a w slice (8 KB)
constexpr int kTcStage = kTcA + 2 * kTcBHalf; // bf16 of a stage (32 KB)
constexpr int kTcSmem = kTcStages * kTcStage * 2 + 2 * kTcStages * 8 + wg::kAtomBytes;

__global__ void __launch_bounds__(kTcThreads, 2)
moe_gemm_wgmma_kernel(__grid_constant__ const CUtensorMap tm_buf,
                      __grid_constant__ const CUtensorMap tm_w, float* __restrict__ out, int c,
                      int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::align_atom(smem_raw);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTcStages * kTcStage * 2);
  uint64_t* empty = full + kTcStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f0 = blockIdx.x * kTcBN;
  const int c0 = blockIdx.y * kTcBM;
  const int ex = blockIdx.z;
  const int nk = (d + kTcBK - 1) / kTcBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      wg::Ring<kTcStages> ring;
      for (int k = 0; k < nk; ++k) {
        wg::mbar_wait(empty + ring.stage, ring.phase ^ 1u);
        __nv_bfloat16* st = tiles + ring.stage * kTcStage;
        uint64_t* bar = full + ring.stage;
        wg::mbar_expect_tx(bar, kTcStage * 2);
        wg::tma_load_3d(st, &tm_buf, bar, k * kTcBK, c0, ex);
        wg::tma_load_3d(st + kTcA, &tm_w, bar, f0, k * kTcBK, ex);
        wg::tma_load_3d(st + kTcA + kTcBHalf, &tm_w, bar, f0 + 64, k * kTcBK, ex);
        ring.advance();
      }
    }
    return;
  }

  // consumers: warpgroup g owns output rows c0 + 64 g ... + 63
  const int g = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wg::Ring<kTcStages> ring;
  int held = -1;  // the stage whose products may still be running
  for (int k = 0; k < nk; ++k) {
    wg::mbar_wait(full + ring.stage, ring.phase);
    const __nv_bfloat16* a = tiles + ring.stage * kTcStage + g * 64 * kTcBK;
    const __nv_bfloat16* b = tiles + ring.stage * kTcStage + kTcA;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // 16 d-values: 32 bytes into each row of A, 16 rows down B
      wg::mma_ss_m64n128k16<1>(acc, wg::kmajor_desc(a + kk * 16),
                               wg::mnmajor_desc(b + kk * 16 * 64, kTcBHalf * 2), 1);
    }
    wg::commit_group();
    wg::wait_group<1>();  // the previous stage's products are done: release it
    wg::fence_operands(acc);
    if (held >= 0 && lane == 0) wg::mbar_arrive(empty + held);
    held = ring.stage;
    ring.advance();
  }
  wg::wait_group<0>();
  wg::fence_operands(acc);
  if (held >= 0 && lane == 0) wg::mbar_arrive(empty + held);

  float* o = out + static_cast<long long>(ex) * c * f;
  const int row0 = c0 + g * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const int row = row0 + 8 * ((j / 2) % 2);
    const int col = f0 + 8 * (j / 4) + 2 * (lane % 4);
    if (row < c && col < f) {  // f is even: col + 1 < f too
      *reinterpret_cast<float2*>(o + static_cast<long long>(row) * f + col) =
          make_float2(acc[j], acc[j + 1]);
    }
  }
}

int launch_wgmma(const void* buf, const void* w, float* out, int e, int c, int d, int f,
                 cudaStream_t stream) {
  CUtensorMap tm_buf;
  CUtensorMap tm_w;
  const uint64_t buf_dims[3] = {static_cast<uint64_t>(d), static_cast<uint64_t>(c),
                                static_cast<uint64_t>(e)};
  const uint64_t buf_strides[2] = {static_cast<uint64_t>(d) * 2,
                                   static_cast<uint64_t>(c) * d * 2};
  const uint32_t buf_box[3] = {kTcBK, kTcBM, 1};
  const uint64_t w_dims[3] = {static_cast<uint64_t>(f), static_cast<uint64_t>(d),
                              static_cast<uint64_t>(e)};
  const uint64_t w_strides[2] = {static_cast<uint64_t>(f) * 2, static_cast<uint64_t>(d) * f * 2};
  const uint32_t w_box[3] = {64, kTcBK, 1};
  cudaError_t err = wg::make_tensor_map(&tm_buf, buf, 3, buf_dims, buf_strides, buf_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = wg::make_tensor_map(&tm_w, w, 3, w_dims, w_strides, w_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(moe_gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((f + kTcBN - 1) / kTcBN, (c + kTcBM - 1) / kTcBM, e);
  moe_gemm_wgmma_kernel<<<grid, kTcThreads, kTcSmem, stream>>>(tm_buf, tm_w, out, c, d, f);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// route codes (kernels/moe_gemm/ops.py ROUTE_CODES)
constexpr int kRouteFma = 0;
constexpr int kRouteWgmma = 1;
constexpr int kRouteSmallC = 2;

// (buf, w, out, E, C, D, F, buf dtype, w dtype, route, stream)
extern "C" int moe_gemm_launch(const void* buf, const void* w, float* out, int e, int c, int d,
                               int f, int buf_dtype, int w_dtype, int route,
                               cudaStream_t stream) {
  if (e <= 0 || c <= 0 || f <= 0) return 0;
  if (d < 0 || e > 65535 || (buf_dtype != kF32 && buf_dtype != kBF16)
      || (w_dtype != kF32 && w_dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool both_bf16 = buf_dtype == kBF16 && w_dtype == kBF16;
  if (route == kRouteWgmma) {
    if (!both_bf16 || d == 0 || d % 8 != 0 || f % 8 != 0 || !aligned16(buf) || !aligned16(w)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_wgmma(buf, w, out, e, c, d, f, stream);
  }
  if (route == kRouteSmallC) {
    if (!both_bf16 || c > kSmallC || f % 8 != 0 || !aligned16(w)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_small_c_any(buf, w, out, e, c, d, f, stream);
  }
  if (route != kRouteFma) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  if (buf_dtype == kBF16) {
    return w_dtype == kBF16 ? launch_tile<bf16, bf16>(buf, w, out, e, c, d, f, stream)
                            : launch_tile<bf16, float>(buf, w, out, e, c, d, f, stream);
  }
  return w_dtype == kBF16 ? launch_tile<float, bf16>(buf, w, out, e, c, d, f, stream)
                          : launch_tile<float, float>(buf, w, out, e, c, d, f, stream);
}

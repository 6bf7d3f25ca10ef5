// flash_decode: one-token GQA attention over a KV cache, in model layout.
//
// Replaces the TPU kernel `flash_decode_call` of
// src/repro/kernels/flash_decode/kernel.py:84 (with the layout work of its
// op, src/repro/kernels/flash_decode/ops.py).  Contract:
//
//   q (B, 1, H, hd), k / v caches (B, S, K, hd), any strides whose last one
//   is 1; positions (B,) int32; row b sees the cache rows s < positions[b] + 1;
//   head h reads KV head h / G (G = H / K, at most kMaxGroup);
//   q and the caches are cast to f32 each on its own (an f32 model's q meets
//   a bf16 cache: q is never rounded to the cache's type), q is then scaled
//   (scale = 1/sqrt(hd)); online softmax in f32 with m starting at kNegInf,
//   masked scores set to it and their p to 0; out (B, H, hd) f32 =
//   acc / max(l, 1e-30) (the wrapper casts it to q's dtype).
//
// The Pallas kernel walks (batch*kv_head, cache block) in grid order with
// (m, l, acc) in VMEM across the cache axis, reading the valid lengths by
// scalar prefetch and masking the tail blocks it still streams.  Here one
// block owns one (batch, KV head) row with its G query heads and loops over
// kKeys-row tiles of the cache itself, up to the row's length and no further.
//
// Bound on this card: bytes, the K and V rows up to each length (plus q and
// out) once each over 3.35 TB/s; 4 G hd FLOPs per cache row are far below
// the arithmetic rate.  This first design has B*K blocks, so at a small batch
// most SMs idle (4 x 8 = 32 of 132 at the smoke run's batch) and each block
// streams its row alone; splitting the cache axis over blocks with a combine
// pass is later work.  Within a block the loads are
// coalesced (consecutive threads on consecutive elements of a cache row) and
// the next tile's loads are issued into registers before the current tile is
// computed, so that load latency overlaps the arithmetic; the k tile is
// padded one word a row so that lanes on consecutive keys hit distinct
// banks, and each thread keeps its (head, column) outputs in registers across
// tiles.
#include "attention.cuh"

namespace {

constexpr int kKeys = 64;          // cache rows per tile
constexpr int kDecThreads = 256;   // 8 warps
constexpr int kWarps = kDecThreads / 32;
constexpr int kMaxGroup = 16;      // query heads per KV head (ops.MAX_GROUP)

struct FdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* positions;
  float* out;
  int s, kh, g;
  float scale;
  long long qsb, qsh;       // element strides of q over batch, head
  long long ksb, kss, ksh;  // of the k cache over batch, row, head
  long long vsb, vss, vsh;
};

// shared memory of one block, in floats
template <int HD>
struct FdSmem {
  static constexpr int kK = kKeys * (HD + 1);
  static constexpr int kV = kKeys * HD;
  static constexpr int kQ = kMaxGroup * HD;
  static constexpr int kP = kMaxGroup * kKeys;
  static constexpr int kStats = 3 * kMaxGroup;  // m, l, corr per head
  static constexpr int kBytes = (kK + kV + kQ + kP + kStats) * 4;
};

template <typename QElem, typename KVElem, int HD>
__global__ void __launch_bounds__(kDecThreads) flash_decode_kernel(FdArgs a) {
  constexpr int kAcc = (kMaxGroup * HD + kDecThreads - 1) / kDecThreads;
  constexpr int kPer = kKeys * HD / kDecThreads;  // tile elements each thread loads
  extern __shared__ float smem[];
  float* ks = smem;                  // [kKeys][HD + 1]
  float* vs = ks + FdSmem<HD>::kK;   // [kKeys][HD]
  float* qs = vs + FdSmem<HD>::kV;   // [G][HD], scaled
  float* ps = qs + FdSmem<HD>::kQ;   // [G][kKeys]
  float* ms = ps + FdSmem<HD>::kP;   // [G] running max
  float* ls = ms + kMaxGroup;        // [G] running sum
  float* cs = ls + kMaxGroup;        // [G] this tile's correction

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x;  // b * K + kvh
  const int b = row / a.kh;
  const int kvh = row % a.kh;
  const int g_n = a.g;
  // live cache rows: s < positions[b] + 1, and s < S
  const int end = min(a.positions[b] + 1, a.s);
  const QElem* qg = static_cast<const QElem*>(a.q) + b * a.qsb + kvh * g_n * a.qsh;
  const KVElem* kg = static_cast<const KVElem*>(a.k) + b * a.ksb + kvh * a.ksh;
  const KVElem* vg = static_cast<const KVElem*>(a.v) + b * a.vsb + kvh * a.vsh;

  for (int e = tid; e < g_n * HD; e += kDecThreads) {
    const int g = e / HD;
    const int d = e % HD;
    qs[g * HD + d] = to_f32(qg[g * a.qsh + d]) * a.scale;
  }
  for (int g = tid; g < g_n; g += kDecThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // the tile's k / v values, raw, in registers: the next tile's loads are
  // issued before this tile is computed, so they are in flight meanwhile
  KVElem kr[kPer];
  KVElem vr[kPer];
  const KVElem zero = from_f32<KVElem>(0.f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kDecThreads;
    const int s = e / HD;
    kr[i] = s < end ? kg[s * a.kss + e % HD] : zero;
    vr[i] = s < end ? vg[s * a.vss + e % HD] : zero;
  }
  __syncthreads();

  for (int s0 = 0; s0 < end; s0 += kKeys) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kDecThreads;
      const int j = e / HD;
      const int d = e % HD;
      ks[j * (HD + 1) + d] = to_f32(kr[i]);
      vs[j * HD + d] = to_f32(vr[i]);
    }
    __syncthreads();
    if (s0 + kKeys < end) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kDecThreads;
        const int s = s0 + kKeys + e / HD;
        kr[i] = s < end ? kg[s * a.kss + e % HD] : zero;
        vr[i] = s < end ? vg[s * a.vss + e % HD] : zero;
      }
    }

    // scores: (head g, key j) pairs, consecutive threads on consecutive keys
    for (int e = tid; e < g_n * kKeys; e += kDecThreads) {
      const int g = e / kKeys;
      const int j = e % kKeys;
      float x[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: FMA latency overlaps
#pragma unroll 8
      for (int d = 0; d < HD; ++d) x[d & 3] = fmaf(qs[g * HD + d], ks[j * (HD + 1) + d], x[d & 3]);
      ps[g * kKeys + j] = s0 + j < end ? (x[0] + x[1]) + (x[2] + x[3]) : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head, two keys per lane
    for (int g = warp; g < g_n; g += kWarps) {
      const float x0 = ps[g * kKeys + lane];
      const float x1 = ps[g * kKeys + lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, group_max<32>(fmaxf(x0, x1)));
      const float p0 = s0 + lane < end ? expf(x0 - m_new) : 0.f;
      const float p1 = s0 + lane + 32 < end ? expf(x1 - m_new) : 0.f;
      ps[g * kKeys + lane] = p0;
      ps[g * kKeys + lane + 32] = p1;
      const float sum = group_sum<32>(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v, over this thread's (head, column) pairs
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kDecThreads;
      if (e < g_n * HD) {
        const int g = e / HD;
        const int d = e % HD;
        float x[2] = {acc[i] * cs[g], 0.f};
#pragma unroll 8
        for (int j = 0; j < kKeys; ++j) x[j & 1] = fmaf(ps[g * kKeys + j], vs[j * HD + d], x[j & 1]);
        acc[i] = x[0] + x[1];
      }
    }
    __syncthreads();  // before the next tile overwrites k, v and p
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kDecThreads;
    if (e < g_n * HD) {
      const int g = e / HD;
      const int d = e % HD;
      a.out[(static_cast<long long>(row) * g_n + g) * HD + d] = acc[i] / fmaxf(ls[g], 1e-30f);
    }
  }
}

template <typename QElem, typename KVElem, int HD>
int launch(const FdArgs& a, int rows, cudaStream_t stream) {
  constexpr int bytes = FdSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<QElem, KVElem, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<QElem, KVElem, HD><<<rows, kDecThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename QElem, typename KVElem>
int launch_hd(const FdArgs& a, int hd, int rows, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<QElem, KVElem, 16>(a, rows, stream);
    case 32: return launch<QElem, KVElem, 32>(a, rows, stream);
    case 64: return launch<QElem, KVElem, 64>(a, rows, stream);
    case 128: return launch<QElem, KVElem, 128>(a, rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const int* positions, float* out, int b, int s, int h,
                                   int kh, int hd, int q_dtype, int kv_dtype, float scale,
                                   long long qsb, long long qsh, long long ksb, long long kss,
                                   long long ksh, long long vsb, long long vss, long long vsh,
                                   cudaStream_t stream) {
  if (b <= 0 || h <= 0) return 0;
  if (s < 0 || kh <= 0 || h % kh != 0 || h / kh > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FdArgs a{q, k, v, positions, out, s, kh, h / kh, scale,
                 qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const int rows = b * kh;
  const bool q16 = q_dtype == kBF16;
  const bool kv16 = kv_dtype == kBF16;
  if ((q_dtype != kF32 && !q16) || (kv_dtype != kF32 && !kv16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q16) {
    return kv16 ? launch_hd<__nv_bfloat16, __nv_bfloat16>(a, hd, rows, stream)
                : launch_hd<__nv_bfloat16, float>(a, hd, rows, stream);
  }
  return kv16 ? launch_hd<float, __nv_bfloat16>(a, hd, rows, stream)
              : launch_hd<float, float>(a, hd, rows, stream);
}

// flash_attention: GQA attention forward, causal or not, in model layout.
//
// Replaces the TPU kernel `flash_fwd_call` of
// src/repro/kernels/flash_attention/kernel.py:83 (with the layout work of its
// op, src/repro/kernels/flash_attention/ops.py).  Contract:
//
//   q (B, T, H, hd), k / v (B, S, K, hd), any strides whose last one is 1;
//   head h reads KV head h / G (G = H / K);
//   out[b, t, h] = sum_s p[s] v[b, s, h / G], p = softmax over the keys
//   s < S (and s <= t under causal, both counted from 0) of
//   (scale * q[b, t, h]) . k[b, s, h / G];
//   q, k and v are cast to f32 first and q is then scaled (scale = 1/sqrt(hd));
//   online softmax in f32 with m starting at kNegInf, masked scores set to
//   it and their p to 0; out = acc / max(l, 1e-30), written in q's dtype
//   (f32 or bf16), contiguous (B, T, H, hd).
//
// The Pallas kernel walks (batch*kv_head, q block, kv block) in grid order
// with (m, l, acc) in VMEM across the kv axis, after its op has transposed
// q/k/v and padded hd to 128 and T / S to 256 / 512 (TPU tiling).  Here one
// block owns (batch, head, kRows query rows) and loops over kKeys-key tiles
// itself, reads the model layout by strides (no copy, no padding: the
// ragged edges are masked) and, under causal, stops at the diagonal: tiles
// wholly above it are never loaded, where the Pallas grid walks and masks
// them.
//
// Bound on this card: operations, 4 B H T S hd FLOPs (half that under
// causal) against 989 TFLOP/s for bf16 (tensor cores) or 67 TFLOP/s for f32;
// q, k, v and out cross device memory once each, a small fraction of that
// time.  This first design computes on the CUDA cores in f32 FMAs, not on
// the tensor cores, so for bf16 it can reach at most 67/989 of the bound; a
// wgmma / TMA pipeline is later work.  What it does about the FMA rate: each
// thread holds a 4 x 4 block of the 64 x 64 score tile and a 4 x hd/16 block
// of the output in registers, so each shared-memory load feeds 2 (scores) to
// 2.7 (p.v) FMAs; q, k and v tiles sit in shared memory as f32, rows padded
// by one word so that the 16 lanes reading 16 keys hit 16 banks; the tile of
// probabilities reuses the k tile's space, which keeps a block under 100 KB
// at hd 128 so that two blocks share an SM.
#include "attention.cuh"

namespace {

constexpr int kRows = 64;                    // query rows per block
constexpr int kKeys = 64;                    // keys per tile
constexpr int kFaThreads = 256;              // 16 x 16: ty = row group, tx = column lane
constexpr int kLanes = 16;                   // lanes sharing one row group
constexpr int kRowsPerThread = kRows / 16;   // 4
constexpr int kKeysPerThread = kKeys / kLanes;  // 4 score columns: tx + 16 c

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int t, s, h, g, causal;
  float scale;
  long long qsb, qst, qsh;  // element strides of q over batch, time, head
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
};

// shared memory of one block, in floats
template <int HD>
struct FaSmem {
  static constexpr int kQ = kRows * (HD + 1);   // q tile, scaled
  static constexpr int kKTile = kKeys * (HD + 1);
  static constexpr int kPTile = kRows * (kKeys + 1);
  static constexpr int kK = kKTile > kPTile ? kKTile : kPTile;  // k tile, then p tile
  static constexpr int kV = kKeys * HD;
  static constexpr int kBytes = (kQ + kK + kV) * 4;
};

template <typename Elem, int HD>
__global__ void __launch_bounds__(kFaThreads, 2) flash_attention_kernel(FaArgs a) {
  constexpr int kCols = HD / kLanes;  // output columns per thread: tx + 16 c
  extern __shared__ float smem[];
  float* qs = smem;                    // [kRows][HD + 1]
  float* ks = qs + FaSmem<HD>::kQ;     // [kKeys][HD + 1]
  float* ps = ks;                      // [kRows][kKeys + 1], once the scores are taken
  float* vs = ks + FaSmem<HD>::kK;     // [kKeys][HD]

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const int q0 = blockIdx.x * kRows;
  const int b = blockIdx.y / a.h;
  const int h = blockIdx.y % a.h;
  const int kvh = h / a.g;
  const Elem* qg = static_cast<const Elem*>(a.q) + b * a.qsb + h * a.qsh;
  const Elem* kg = static_cast<const Elem*>(a.k) + b * a.ksb + kvh * a.ksh;
  const Elem* vg = static_cast<const Elem*>(a.v) + b * a.vsb + kvh * a.vsh;

  // the q tile: cast to f32, then scaled; rows past T are zeros
  for (int e = tid; e < kRows * HD; e += kFaThreads) {
    const int r = e / HD;
    const int d = e % HD;
    const int t = q0 + r;
    qs[r * (HD + 1) + d] = t < a.t ? to_f32(qg[t * a.qst + d]) * a.scale : 0.f;
  }

  float acc[kRowsPerThread][kCols];
  float m[kRowsPerThread];
  float l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // under causal no key past the block's last row is seen
  const int kv_end = a.causal ? min(a.s, q0 + kRows) : a.s;
  for (int s0 = 0; s0 < kv_end; s0 += kKeys) {
    __syncthreads();  // the previous tile's p and v are read (and the q tile written)
    // eight elements of k and v per thread in flight at a time
#pragma unroll 8
    for (int i = 0; i < kKeys * HD / kFaThreads; ++i) {
      const int e = tid + i * kFaThreads;
      const int j = e / HD;
      const int d = e % HD;
      const int s = s0 + j;
      float kx = 0.f;
      float vx = 0.f;
      if (s < a.s) {
        kx = to_f32(kg[s * a.kss + d]);
        vx = to_f32(vg[s * a.vss + d]);
      }
      ks[j * (HD + 1) + d] = kx;
      vs[j * HD + d] = vx;
    }
    __syncthreads();

    // scores of rows ty*4 + i against keys tx + 16 c
    float sc[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) sc[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[kRowsPerThread];
      float kb[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qa[i] = qs[(ty * kRowsPerThread + i) * (HD + 1) + d];
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) kb[c] = ks[(tx + kLanes * c) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kKeysPerThread; ++c) sc[i][c] = fmaf(qa[i], kb[c], sc[i][c]);
    }
    __syncthreads();  // every score is taken: the k tile's space takes p

    // online softmax, one row at a time over the row group's 16 lanes
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      const int t = q0 + r;
      bool live[kKeysPerThread];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) {
        const int s = s0 + tx + kLanes * c;
        live[c] = s < a.s && (!a.causal || s <= t);
        if (!live[c]) sc[i][c] = kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max<kLanes>(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) {
        const float p = live[c] ? expf(sc[i][c] - m_new) : 0.f;
        ps[r * (kKeys + 1) + tx + kLanes * c] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum<kLanes>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float pa[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pa[i] = ps[(ty * kRowsPerThread + i) * (kKeys + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vb = vs[j * HD + tx + kLanes * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

  Elem* og = static_cast<Elem*>(a.out);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = q0 + ty * kRowsPerThread + i;
    if (t >= a.t) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    Elem* row = og + ((static_cast<long long>(b) * a.t + t) * a.h + h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[tx + kLanes * c] = from_f32<Elem>(acc[i][c] / denom);
  }
}

template <typename Elem, int HD>
int launch(const FaArgs& a, int batch, cudaStream_t stream) {
  constexpr int bytes = FaSmem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<Elem, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.t + kRows - 1) / kRows, batch * a.h);
  flash_attention_kernel<Elem, HD><<<grid, kFaThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int t, int s, int h, int kh, int hd, int dtype,
                                      int causal, float scale, long long qsb, long long qst,
                                      long long qsh, long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh,
                                      cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0) return 0;
  if (s <= 0 || kh <= 0 || h % kh != 0 || static_cast<long long>(b) * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FaArgs a{q, k, v, out, t, s, h, h / kh, causal, scale,
                 qsb, qst, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const bool bf16 = dtype == kBF16;
  if (dtype != kF32 && !bf16) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return bf16 ? launch<__nv_bfloat16, 16>(a, b, stream)
                      : launch<float, 16>(a, b, stream);
    case 32: return bf16 ? launch<__nv_bfloat16, 32>(a, b, stream)
                      : launch<float, 32>(a, b, stream);
    case 64: return bf16 ? launch<__nv_bfloat16, 64>(a, b, stream)
                      : launch<float, 64>(a, b, stream);
    case 128: return bf16 ? launch<__nv_bfloat16, 128>(a, b, stream)
                      : launch<float, 128>(a, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
//   scale * q[b, t, h] . k[b, s, h / G] (scale = 1/sqrt(hd));
//   online softmax in f32 with m starting at kNegInf, masked scores set to
//   it and their p to 0; out = acc / max(l, 1e-30), written in q's dtype
//   (f32 or bf16), contiguous (B, T, H, hd); where the caller passes an lse
//   buffer (training: the backward's residual), also the natural
//   log-sum-exp of each row's scaled scores, lse = m + log(max(l, 1e-30)),
//   float32, contiguous (B, T, H) (the reference's (B, T, K, G)).  The
//   wgmma instance keeps m and l in base 2 (scores times scale * log2(e)),
//   so it writes (m2 + log2(max(l, 1e-30))) * ln 2.
//
// The Pallas kernel walks (batch*kv_head, q block, kv block) in grid order
// with (m, l, acc) in VMEM across the kv axis, after its op has transposed
// q/k/v and padded hd to 128 and T / S to 256 / 512 (TPU tiling).  Here a
// block owns (batch, head, a tile of query rows) and loops over key tiles
// itself, reads the model layout by strides (no copy, no padding: the ragged
// edges are masked) and, under causal, stops at the diagonal: tiles wholly
// above it are never loaded, where the Pallas grid walks and masks them.
//
// Bound on this card: operations, 4 B H T S hd FLOPs (about half that under
// causal) against 989 TFLOP/s for bf16 (tensor cores) or 67 TFLOP/s for
// f32; q, k, v and out cross device memory once each, a small fraction of
// that time.  The wrapper picks one of two instances (kernels/flash_attention
// /ops.py `flash_attention_route`) and passes it in:
//
// * wgmma (bf16 q / k / v, hd 64 or 128, strides multiples of 16 bytes,
//   16-byte aligned pointers), in the manner of FlashAttention-3.  A block
//   of 128 query rows: two consumer warpgroups of 64 rows and a producer
//   warpgroup whose one thread starts the copies (it hands registers to the
//   consumers: 40 against 232 a thread).  Q is loaded once by TMA; K / V
//   tiles of 128 keys stream through a 2-stage TMA ring (4-D tensor maps
//   over the model layout with its real strides; zeros past T and S).
//   S = Q K^T by wgmma with both operands in shared memory (K-major);
//   scale * log2(e) is applied to the f32 scores and the online softmax
//   runs in registers (a row spreads over a quad of lanes); P goes to
//   registers as A fragments and O += P V by wgmma from registers with V an
//   MN-major B.  The two warpgroups take turns to start Q K^T (named
//   barriers), so that one's softmax overlaps the other's products.  Under
//   causal only the tiles that cross the diagonal are masked, and the
//   blocks with the most tiles start first.  GQA heads sharing a KV head
//   re-read it through L2.
//
//   Numerics.  The plain version casts to f32, scales q, then multiplies in
//   f32 (as the reference, src/repro/kernels/flash_attention/kernel.py:53-58,
//   75-76).  A bf16 x bf16 product is exact in f32, so Q K^T on the tensor
//   cores differs from it only in the order of the sums and in scaling
//   after the sum (at most 2^-24 relative per term), both far inside the
//   bf16 limit (2^-7 |want| + 1e-5).  P must not be rounded once to bf16:
//   that moves the output by up to 2^-9 sum(p |v|) / l, which breaks the
//   limit wherever the output is near zero (rows of v that cancel).  So P
//   is split into bf16 terms, P_hi = bf16(p), P_mid = bf16(p - P_hi), P_lo =
//   bf16(p - P_hi - P_mid), and one wgmma a term adds it times V into the
//   same accumulator: the error is then at most 2^-27 sum(p |v|) / l plus
//   float32 sums (the tensor cores add with truncation: 2^-23 relative an
//   add).  Two terms (2^-18) leave less than a 4x margin to the limit on
//   cancelling rows of +-5 (flash_attention_split_torch on float32 outputs;
//   chip_smoke.py reports both splits' shares); three keep it.  l sums the
//   f32 p.  The tensor cores then do twice the one-pass FLOPs (Q K^T
//   once, P V three times): the design's own ceiling is twice the bound.
// * fma (f32, or hd 16 / 32, or strides TMA cannot take).  The CUDA-core
//   kernel of the first port: q, k and v are cast to f32 into shared memory
//   (q then scaled), each thread holds a 4 x 4 block of the 64 x 64 score
//   tile and a 4 x hd/16 block of the output in registers, rows padded by
//   one word against bank conflicts, the p tile reusing the k tile's space
//   (under 100 KB at hd 128, two blocks an SM).  For bf16 it reaches at
//   most 67/989 of the bound.
#include "attention.cuh"
#include "wgmma.cuh"

namespace {

// ---- the fma instance ----
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
  float* lse;  // (B, T, H) or null
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
    const long long bth = (static_cast<long long>(b) * a.t + t) * a.h + h;
    if (a.lse != nullptr && tx == 0) a.lse[bth] = m[i] + logf(denom);
    Elem* row = og + bth * HD;
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

// ---- the wgmma instance (bf16, hd 64 / 128) ----
constexpr int kTcRows = 128;    // query rows of a block: two warpgroups of 64
constexpr int kTcKeys = 128;    // keys of a K / V tile
constexpr int kTcStages = 2;
constexpr int kTcThreads = 384; // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int kPTerms = 3;      // P = P_hi + P_mid + P_lo

template <int HD>
struct TcSmem {
  static constexpr int kHalves = HD / 64;      // 128-byte column blocks of a tile
  static constexpr int kQ = kTcRows * HD;      // bf16 of the Q tile
  static constexpr int kKV = kTcKeys * HD;     // bf16 of one K or V tile
  static constexpr int kBytes =
      (kQ + 2 * kTcStages * kKV) * 2 + (2 * kTcStages + 1) * 8 + wg::kAtomBytes;
};

struct TcArgs {
  void* out;
  float* lse;  // (B, T, H) or null
  int t, s, h, g, causal;
  float scale_log2;  // scale * log2(e), applied to the f32 scores
};

// O += P V for one 16-key slice: m64n{HD}k16 from registers
template <int HD>
static __device__ __forceinline__ void pv_mma(float (&o)[HD / 2], const uint32_t (&p)[4],
                                              uint64_t v) {
  if constexpr (HD == 128) {
    wg::mma_rs_m64n128k16<1>(o, p, v, 1);
  } else {
    wg::mma_rs_m64n64k16<1>(o, p, v, 1);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                             __grid_constant__ const CUtensorMap tm_k,
                             __grid_constant__ const CUtensorMap tm_v, TcArgs a) {
  using Smem = TcSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::align_atom(smem_raw);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [half][128 rows][64]
  __nv_bfloat16* ks = qs + Smem::kQ;                            // [stage][half][128 keys][64]
  __nv_bfloat16* vs = ks + kTcStages * Smem::kKV;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kTcStages * Smem::kKV);
  uint64_t* empty = full + kTcStages;
  uint64_t* qbar = empty + kTcStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // the longest causal blocks first
  const int b = blockIdx.y / a.h;
  const int h = blockIdx.y % a.h;
  const int kvh = h / a.g;
  // under causal no key past the block's last row is seen
  const int kv_end = a.causal ? min(a.s, q0 + kTcRows) : a.s;
  const int n_tiles = (kv_end + kTcKeys - 1) / kTcKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    wg::mbar_init(qbar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer
    wg::setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      wg::mbar_expect_tx(qbar, Smem::kQ * 2);
      for (int hh = 0; hh < Smem::kHalves; ++hh) {
        wg::tma_load_4d(qs + hh * kTcRows * 64, &tm_q, qbar, hh * 64, h, q0, b);
      }
      wg::Ring<kTcStages> ring;
      for (int j = 0; j < n_tiles; ++j) {
        wg::mbar_wait(empty + ring.stage, ring.phase ^ 1u);
        uint64_t* bar = full + ring.stage;
        wg::mbar_expect_tx(bar, 2 * Smem::kKV * 2);
        for (int hh = 0; hh < Smem::kHalves; ++hh) {
          const int off = ring.stage * Smem::kKV + hh * kTcKeys * 64;
          wg::tma_load_4d(ks + off, &tm_k, bar, hh * 64, kvh, j * kTcKeys, b);
          wg::tma_load_4d(vs + off, &tm_v, bar, hh * 64, kvh, j * kTcKeys, b);
        }
        ring.advance();
      }
    }
  } else {
    // consumers: warpgroup g owns rows q0 + 64 g ... + 63; this thread rows
    // t0 and t0 + 8 of them (the accumulator layout, wgmma.cuh).  The two
    // roles' paths never join again, so that setmaxnreg holds.
    wg::setmaxnreg_inc<kConsumerRegs>();
    const int g = warp / 4;
    const int t0 = q0 + g * 64 + (warp % 4) * 16 + lane / 4;
    const int first_row = q0 + g * 64;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    wg::mbar_wait(qbar, 0);
    // the two warpgroups take turns to start Q K^T (named barrier 1 + g is
    // g's turn), so that one's softmax runs while the other's products do
    // (FlashAttention-3's ping-pong); warpgroup 0 goes first, and warpgroup
    // 1 skips its last hand-over, which nobody waits for
    if (g == 1) wg::named_arrive(1, 256);
    wg::Ring<kTcStages> ring;
    for (int j = 0; j < n_tiles; ++j) {
      const int s0 = j * kTcKeys;
      wg::mbar_wait(full + ring.stage, ring.phase);
      const __nv_bfloat16* kt = ks + ring.stage * Smem::kKV;
      const __nv_bfloat16* vt = vs + ring.stage * Smem::kKV;

      // S = Q K^T: 16 hd-values a step, 32 bytes further into each row
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      wg::named_sync(1 + g, 256);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * kTcRows * 64 + (kk % 4) * 16;  // kTcRows == kTcKeys
        wg::mma_ss_m64n128k16<0>(sc, wg::kmajor_desc(qs + off + g * 64 * 64),
                                 wg::kmajor_desc(kt + off), 1);
      }
      wg::commit_group();
      if (g == 0 || j + 1 < n_tiles) wg::named_arrive(2 - g, 256);
      wg::wait_group<0>();
      wg::fence_operands(sc);

      // scale, mask (only a tile that crosses S or the diagonal), row maxima
      const bool edge = s0 + kTcKeys > a.s || (a.causal && s0 + kTcKeys - 1 > first_row);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i / 2) % 2;
        float x = sc[i] * a.scale_log2;
        if (edge) {
          const int col = s0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (col >= a.s || (a.causal && col > t0 + 8 * r)) x = kNegInf;
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float corr[2];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], group_max<4>(mx[r]));
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i / 2) % 2;
        const float p = sc[i] == kNegInf ? 0.f : exp2f(sc[i] - m[r]);
        sc[i] = p;
        sum[r] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + group_sum<4>(sum[r]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i / 2) % 2];

      // P as A fragments, split into bf16 terms whose sum is p to 2^-27
      uint32_t pf[kPTerms][8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x0 = sc[8 * kk + 2 * i];
          float x1 = sc[8 * kk + 2 * i + 1];
#pragma unroll
          for (int term = 0; term < kPTerms; ++term) {
            const __nv_bfloat162 pair = __floats2bfloat162_rn(x0, x1);  // one cvt for two
            pf[term][kk][i] = *reinterpret_cast<const uint32_t*>(&pair);
            const float2 back = __bfloat1622float2(pair);
            x0 -= back.x;
            x1 -= back.y;
          }
        }
      }

      // O += P V: 16 keys a step, 16 rows further down each column block of V
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t dv = wg::mnmajor_desc(vt + kk * 16 * 64, kTcKeys * 64 * 2);
#pragma unroll
        for (int term = 0; term < kPTerms; ++term) pv_mma<HD>(o, pf[term][kk], dv);
      }
      wg::commit_group();
      wg::wait_group<0>();
      wg::fence_operands(o);
      if (lane == 0) wg::mbar_arrive(empty + ring.stage);
      ring.advance();
    }

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 8 * r;
      if (t >= a.t) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      const long long bth = (static_cast<long long>(b) * a.t + t) * a.h + h;
      // m and l in base 2: the natural log-sum-exp is (m + log2 l) ln 2
      if (a.lse != nullptr && lane % 4 == 0) {
        a.lse[bth] = (m[r] + log2f(denom)) * 0.6931471805599453f;
      }
      __nv_bfloat16* row = og + bth * HD;
#pragma unroll
      for (int i = 2 * r; i < HD / 2; i += 4) {  // the pairs of row t0 + 8 r
        const int col = 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(row + col) = wg::pack_bf16(o[i] / denom, o[i + 1] / denom);
      }
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const TcArgs& a, int batch, int kh,
                 long long qsb, long long qst, long long qsh, long long ksb, long long kss,
                 long long ksh, long long vsb, long long vss, long long vsh,
                 cudaStream_t stream) {
  // 4-D maps (hd, head, row, batch) with the tensors' own strides, in bytes
  CUtensorMap tm_q;
  CUtensorMap tm_k;
  CUtensorMap tm_v;
  const uint32_t box[4] = {64, 1, 128, 1};
  const uint64_t q_dims[4] = {HD, static_cast<uint64_t>(a.h), static_cast<uint64_t>(a.t),
                              static_cast<uint64_t>(batch)};
  const uint64_t kv_dims[4] = {HD, static_cast<uint64_t>(kh), static_cast<uint64_t>(a.s),
                               static_cast<uint64_t>(batch)};
  const uint64_t q_strides[3] = {static_cast<uint64_t>(qsh) * 2, static_cast<uint64_t>(qst) * 2,
                                 static_cast<uint64_t>(qsb) * 2};
  const uint64_t k_strides[3] = {static_cast<uint64_t>(ksh) * 2, static_cast<uint64_t>(kss) * 2,
                                 static_cast<uint64_t>(ksb) * 2};
  const uint64_t v_strides[3] = {static_cast<uint64_t>(vsh) * 2, static_cast<uint64_t>(vss) * 2,
                                 static_cast<uint64_t>(vsb) * 2};
  cudaError_t err = wg::make_tensor_map(&tm_q, q, 4, q_dims, q_strides, box);
  if (err == cudaSuccess) err = wg::make_tensor_map(&tm_k, k, 4, kv_dims, k_strides, box);
  if (err == cudaSuccess) err = wg::make_tensor_map(&tm_v, v, 4, kv_dims, v_strides, box);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TcSmem<HD>::kBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.t + kTcRows - 1) / kTcRows, batch * a.h);
  flash_attention_wgmma_kernel<HD><<<grid, kTcThreads, TcSmem<HD>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, a);
  return static_cast<int>(cudaGetLastError());
}

// TMA's rules: 16-byte aligned base, strides of whole 16-byte units
bool tma_ready(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 > 0 && s1 > 0 && s2 > 0 && s0 % 8 == 0
         && s1 % 8 == 0 && s2 % 8 == 0;
}

}  // namespace

// instance codes (kernels/flash_attention/ops.py ROUTE_CODES)
constexpr int kRouteFma = 0;
constexpr int kRouteWgmma = 1;

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      float* lse, int b, int t, int s, int h, int kh, int hd, int dtype,
                                      int causal, float scale, long long qsb, long long qst,
                                      long long qsh, long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh, int route,
                                      cudaStream_t stream) {
  if (b <= 0 || t <= 0 || h <= 0) return 0;
  if (s <= 0 || kh <= 0 || h % kh != 0 || static_cast<long long>(b) * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == kBF16;
  if (dtype != kF32 && !bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma) {
    if (!bf16 || (hd != 64 && hd != 128) || !tma_ready(q, qsb, qst, qsh)
        || !tma_ready(k, ksb, kss, ksh) || !tma_ready(v, vsb, vss, vsh)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const TcArgs a{out, lse, t, s, h, h / kh, causal, scale * 1.4426950408889634f};
    return hd == 128 ? launch_wgmma<128>(q, k, v, a, b, kh, qsb, qst, qsh, ksb, kss, ksh, vsb,
                                         vss, vsh, stream)
                     : launch_wgmma<64>(q, k, v, a, b, kh, qsb, qst, qsh, ksb, kss, ksh, vsb,
                                        vss, vsh, stream);
  }
  if (route != kRouteFma) return static_cast<int>(cudaErrorInvalidValue);
  const FaArgs a{q, k, v, out, lse, t, s, h, h / kh, causal, scale,
                 qsb, qst, qsh, ksb, kss, ksh, vsb, vss, vsh};
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

// flash_decode: one-token GQA attention over a KV cache, in model layout.
//
// Replaces the TPU kernel `flash_decode_call` of
// src/repro/kernels/flash_decode/kernel.py:84 (with the layout work of its
// op, src/repro/kernels/flash_decode/ops.py).  Contract:
//
//   q (B, 1, H, hd), k / v caches (B, S, K, hd), any strides whose last one
//   is 1; positions (B,) int32; row b sees the cache rows s < end =
//   min(positions[b] + 1, S) (a position at or past S sees the whole cache);
//   head h reads KV head h / G (G = H / K, at most kMaxGroup);
//   q and the caches are cast to f32 each on its own (an f32 model's q meets
//   a bf16 cache: q is never rounded to the cache's type), q is then scaled
//   (scale = 1/sqrt(hd)); softmax in f32 with m starting at kNegInf, masked
//   scores set to it and their p to 0; out (B, 1, H, hd) in q's dtype =
//   acc / max(l, 1e-30), rounded to nearest even when bf16.
//
// The partial mode (`flash_decode_partial_launch`) takes one rank's slice
// [start, start + S) of a cache split over T: row b sees the slice's rows s
// with start + s <= positions[b] (a position below start sees none), and the
// combine pass writes out in f32 (never rounded to q's dtype: the cross-rank
// combine rounds once, at the end) and lse (B, H) f32 = M + log L of the
// slice's live rows, kNegInf (and out 0) where the slice has none.  The same
// two launches; the whole call is the partial mode at start 0 with out in
// q's dtype and no lse.
//
// The Pallas kernel walks (batch*kv_head, cache block) in grid order with
// (m, l, acc) in VMEM across the cache axis.  A card runs its blocks in
// parallel and carries nothing from one to the next, so here the cache axis
// is split over blocks and a second pass combines them:
//
// * split pass, grid (B*K, n_splits).  Block (row, z) owns one (batch, KV
//   head) row and the cache rows [z*chunk, min((z+1)*chunk, end)); it
//   computes the partial (m, l, acc) of the row's G query heads in f32 and
//   writes it to a float32 scratch.  A chunk wholly past `end` writes the
//   empty partial (kNegInf, 0, 0) and exits.  The wrapper plans chunk and
//   n_splits from B, K, S and the SM count alone (kernels/flash_decode/ops.py
//   `flash_decode_plan`), never from the positions, so it waits for nothing:
//   about one wave of blocks, each streaming a few hundred rows (a block's
//   start-up and merge cost more than a second wave saves).
// * combine pass, grid (B*H): M = max_z m_z, out = sum_z e^(m_z - M) acc_z /
//   max(sum_z e^(m_z - M) l_z, 1e-30), written in q's dtype (no cast launch).
//   It is a programmatic dependent launch (`griddepcontrol`): its blocks are
//   made resident while the split pass drains and wait for it on the card.
//
// Bound on this card: bytes, the K and V rows up to each length (plus q and
// out) once each over 3.35 TB/s; 4 G hd FLOPs a cache row are far below the
// arithmetic rate.  So the split pass keeps bytes in flight: a block streams
// its chunk through a ring of kStages tiles (8 KB of k and 8 KB of v a stage,
// in the cache's own dtype) filled by 16-byte `cp.async` copies coalesced
// along hd, two tiles in flight while one is computed (route vec16: a
// 16-byte aligned base and batch / row / head strides in whole 16-byte
// units, which the wrapper checks).  Any other cache takes the same kernel
// with element loads into the ring (route scalar).  A group of hd / V lanes
// (V = 8 bf16 or 4 f32 values: 16 bytes) holds one cache row: each lane
// converts its V values to f32 in registers and multiplies them by the same
// columns of the heads' q, which it keeps in registers; the group adds the
// dot products by shuffles, and every lane keeps its V columns of acc for
// those heads.  Where the group has a lane for each of a step's kRows x
// heads scores (hd 128 in bf16, 64 or 128 in f32, at up to 4 heads), the
// reduction transposes as it adds (`transpose_sum`), leaving each lane one
// score, so a lane takes one exponential a step, not one per score, and the
// probabilities reach the other lanes by shuffles.  Each row group runs its
// own online softmax over its rows (kRows rows a step; acc is rescaled only
// when a maximum moved); the groups' states are merged through shared
// memory at the end of the chunk, with one weight per group and head.  A
// row group carries up to 4 heads (1 at G = 1 and 2); G of 5-8 or 9-16
// splits the heads over 2 or 4 sets of row groups that read the same
// tiles, so at G = 1 (moonshot) and G = 4 (qwen3-8b) no lane computes a
// head that is not there, and at G = 16 nothing spills.
//
// Numerics.  Every product and sum is f32 arithmetic, as in the plain version
// (kernels/flash_decode/ops.py `flash_decode_torch`, one softmax over all S
// rows).  What changes is the order of the f32 sums (a dot product in lane
// partials and a shuffle tree; l and acc per row group, per chunk, then over
// chunks), and each p = e^(s - M) becomes e^(s - m) for a row group's
// running m times the corrections e^(m - m') on the way to M: a few more
// f32 roundings, each within 2^-24 of the value.  An output moves by a few
// 2^-24 of sum(p |v|) / l plus the reordered sums' own error: the kind of
// error the one-block kernel of the first port had (its online softmax
// rescaled in the same way), far inside ATTENTION_TOL (chip_smoke.py): 1e-5
// absolute in f32, 2^-7 |want| + 1e-5 in bf16.
#include "attention.cuh"

namespace {

constexpr int kFdThreads = 128;   // 4 warps
constexpr int kStages = 3;        // tiles in the ring
constexpr int kTileBytes = 8192;  // of k, and of v, a stage
constexpr int kRows = 4;          // rows a row group takes per softmax step
constexpr int kMaxGroup = 16;     // query heads per KV head (ops.MAX_GROUP)
constexpr int kSmemBytes = 2 * kStages * kTileBytes;

struct FdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* positions;
  float* part_acc;  // (B*K, n_splits, G, hd)
  float* part_ml;   // (B*K, n_splits, G, 2): m, l
  int s, kh, g;
  int chunk, n_splits;
  int sets, per_set;  // head sets (1, 2 or 4) and heads a set (at most 4)
  int vec16;
  float scale;
  long long start;          // the slice's first row in the whole cache (0: the whole)
  long long qsb, qsh;       // element strides of q over batch, head
  long long ksb, kss, ksh;  // of the k cache over batch, row, head
  long long vsb, vss, vsh;
};

// 16 bytes of the cache's elements, to f32 (exact for bf16)
static __device__ __forceinline__ void unpack16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
static __device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

constexpr unsigned int kFull = 0xFFFFFFFFu;

// Sums each of kN values over an aligned group of lanes (kOff * 2 of them),
// halving the values at every step: the lanes with bit kOff set keep the
// upper half of the values and pass the lower half to their partner.  With
// kN <= the group's width, lane c ends with the full sum of value
// c / (width / kN) in v[0] (kN - 1 shuffles where a plain reduction of each
// value takes kN log2(width)).  Every lane of the warp must call it.
template <int kN, int kOff>
static __device__ __forceinline__ void transpose_sum(float* v, int lane) {
  if constexpr (kOff >= 1) {
    if constexpr (kN > 1) {
      constexpr int kHalf = kN / 2;
      const bool upper = (lane & kOff) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float give = upper ? v[i] : v[i + kHalf];
        const float keep = upper ? v[i + kHalf] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, give, kOff);
      }
      transpose_sum<kHalf, kOff / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], kOff);
      transpose_sum<1, kOff / 2>(v, lane);
    }
  }
}

template <typename QElem, typename KVElem, int HD, int GW>
__global__ void __launch_bounds__(kFdThreads, GW == 1 ? 4 : 3) flash_decode_split_kernel(FdArgs a) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(KVElem));  // values in 16 bytes
  constexpr int kLanes = HD / kVec;                               // lanes a cache row
  constexpr int kRowGroups = kFdThreads / kLanes;
  constexpr int kTileRows = kTileBytes / (HD * static_cast<int>(sizeof(KVElem)));
  constexpr int kTileElems = kTileRows * HD;
  constexpr int kPieces = kTileRows * kLanes / kFdThreads;  // 16-byte pieces a thread copies
  static_assert(kTileRows == kRows * kRowGroups, "a tile holds kRows rows a row group");
  static_assert(kPieces * kFdThreads == kTileRows * kLanes, "whole pieces a thread");
  static_assert(kRowGroups * GW * (HD + 2) * 4 <= kSmemBytes, "the merge fits the ring");
  // a step's kRows * GW scores spread one a lane over the row group (its
  // lanes in kRep replicas), or, where the group is narrower, every lane
  // keeps all of them
  constexpr bool kSpread = kRows * GW <= kLanes;
  constexpr int kRep = kSpread ? kLanes / (kRows * GW) : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KVElem* ks = reinterpret_cast<KVElem*>(smem_raw);  // [kStages][kTileRows][HD]
  KVElem* vs = ks + kStages * kTileElems;

  const int tid = threadIdx.x;
  const int col = (tid % kLanes) * kVec;  // this lane's first column of a row
  const int rg = tid / kLanes;
  const int gl = tid % kLanes;                      // lane within the row group
  const int gbase = (tid & 31) & ~(kLanes - 1);     // the group's first lane in the warp
  const int own = gl / kRep;  // spread: the (row, head) whose score this lane holds
  const int set = rg % a.sets;
  const int slice = rg / a.sets;
  const int slices = kRowGroups / a.sets;
  // the combine pass may launch now: it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;");
  const int row = blockIdx.x;  // b * K + kvh
  const int z = blockIdx.y;
  const int b = row / a.kh;
  const int kvh = row - b * a.kh;
  // this row group's heads: g0 + g for g < per_set (q of the others is 0),
  // loaded beside the position, so that the two latencies overlap
  const int g0 = set * a.per_set;
  const QElem* qg = static_cast<const QElem*>(a.q) + b * a.qsb + kvh * a.g * a.qsh;
  float qr[GW][kVec];
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    const bool live = g < a.per_set && g0 + g < a.g;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      qr[g][e] = live ? to_f32(qg[(g0 + g) * a.qsh + col + e]) * a.scale : 0.f;
    }
  }
  // live cache rows of the slice: s < end (none where the position lies
  // before the slice)
  const long long pos = static_cast<long long>(a.positions[b]) - a.start;
  const int end = pos >= a.s ? a.s : pos < 0 ? 0 : static_cast<int>(pos + 1);
  const int start = z * a.chunk;
  const int stop = min(start + a.chunk, end);
  const long long pbase = (static_cast<long long>(row) * a.n_splits + z) * a.g;
  if (start >= stop) {  // the empty partial
    for (int e = tid; e < a.g * HD; e += kFdThreads) a.part_acc[pbase * HD + e] = 0.f;
    for (int e = tid; e < a.g; e += kFdThreads) {
      a.part_ml[(pbase + e) * 2] = kNegInf;
      a.part_ml[(pbase + e) * 2 + 1] = 0.f;
    }
    return;
  }

  float m[GW], l[GW], acc[GW][kVec];
  float m_own = kNegInf;  // spread: the running m and l of head own_g
  float l_own = 0.f;
#pragma unroll
  for (int g = 0; g < GW; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  const KVElem* kg = static_cast<const KVElem*>(a.k) + b * a.ksb + kvh * a.ksh;
  const KVElem* vg = static_cast<const KVElem*>(a.v) + b * a.vsb + kvh * a.vsh;
  const int n_tiles = (stop - start + kTileRows - 1) / kTileRows;
  // tile t of the chunk into its stage; rows at or past `stop` become zeros
  auto load_tile = [&](int t) {
    KVElem* kd = ks + (t % kStages) * kTileElems;
    KVElem* vd = vs + (t % kStages) * kTileElems;
    const int r0 = start + t * kTileRows;
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int e = tid + u * kFdThreads;
      const int r = e / kLanes;
      const int c = (e % kLanes) * kVec;
      const bool live = r0 + r < stop;
      const long long ko = live ? (r0 + r) * a.kss + c : 0;
      const long long vo = live ? (r0 + r) * a.vss + c : 0;
      if (a.vec16) {
        cp_async16(kd + r * HD + c, kg + ko, live);
        cp_async16(vd + r * HD + c, vg + vo, live);
      } else {
        KVElem kx[kVec], vx[kVec];
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          kx[x] = live ? kg[ko + x] : from_f32<KVElem>(0.f);
          vx[x] = live ? vg[vo + x] : from_f32<KVElem>(0.f);
        }
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          kd[r * HD + c + x] = kx[x];
          vd[r * HD + c + x] = vx[x];
        }
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for all; tile t - 1's stage is free
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const KVElem* kt = ks + (t % kStages) * kTileElems;
    const KVElem* vt = vs + (t % kStages) * kTileElems;
    const int r0 = start + t * kTileRows;
    for (int step = 0; step < a.sets; ++step) {
      int rr[kRows];  // tile rows of this step
      float p[kRows * GW];  // scores, then probabilities, of (row r, head g) at r * GW + g
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        rr[r] = slice + slices * (step * kRows + r);
        float kf[kVec];
        unpack16(kt + rr[r] * HD + col, kf);
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) x = fmaf(qr[g][e], kf[e], x);
          p[r * GW + g] = x;
        }
      }
      // online softmax over the step's rows, the masked ones left out
      if constexpr (kSpread) {
        transpose_sum<kRows * GW, kLanes / 2>(p, gl);
        const bool live = r0 + slice + slices * (step * kRows + own / GW) < stop;
        const float x = live ? p[0] : kNegInf;
        float mx = x;  // over the rows of head own_g: lanes kRep GW apart
#pragma unroll
        for (int o = kRep * GW; o < kLanes; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m_own, mx);
        const float corr = expf(m_own - m_new);
        const float pq = live ? expf(x - m_new) : 0.f;
        float sum = pq;
#pragma unroll
        for (int o = kRep * GW; o < kLanes; o *= 2) sum += __shfl_xor_sync(kFull, sum, o);
        l_own = l_own * corr + sum;
        m_own = m_new;
        if (__any_sync(kFull, corr != 1.f)) {
#pragma unroll
          for (int g = 0; g < GW; ++g) {
            const float c = __shfl_sync(kFull, corr, gbase + g * kRep);
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[g][e] *= c;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows * GW; ++i) p[i] = __shfl_sync(kFull, pq, gbase + i * kRep);
      } else {
#pragma unroll
        for (int i = 0; i < kRows * GW; ++i) p[i] = group_sum<kLanes>(p[i]);
#pragma unroll
        for (int g = 0; g < GW; ++g) {
          float mx = m[g];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r0 + rr[r] < stop) mx = fmaxf(mx, p[r * GW + g]);
          }
          const float corr = expf(m[g] - mx);
          float sum = 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            p[r * GW + g] = r0 + rr[r] < stop ? expf(p[r * GW + g] - mx) : 0.f;
            sum += p[r * GW + g];
          }
          l[g] = l[g] * corr + sum;
          m[g] = mx;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][e] *= corr;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float vf[kVec];
        unpack16(vt + rr[r] * HD + col, vf);
#pragma unroll
        for (int g = 0; g < GW; ++g) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(p[r * GW + g], vf[e], acc[g][e]);
        }
      }
    }
  }
  if constexpr (kSpread) {  // every lane: m and l of each head
#pragma unroll
    for (int g = 0; g < GW; ++g) {
      m[g] = __shfl_sync(kFull, m_own, gbase + g * kRep);
      l[g] = __shfl_sync(kFull, l_own, gbase + g * kRep);
    }
  }

  // merge the row groups' states: per head, over the slices of its set
  cp_async_wait<0>();
  __syncthreads();  // every row group is done with the ring
  float* sacc = reinterpret_cast<float*>(smem_raw);  // [kRowGroups][GW][HD]
  float* sml = sacc + kRowGroups * GW * HD;          // [kRowGroups][GW][2]: m, l; then weights
#pragma unroll
  for (int g = 0; g < GW; ++g) {
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      *reinterpret_cast<float4*>(sacc + (rg * GW + g) * HD + col + e) =
          make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
    }
    if (gl == 0) {
      sml[(rg * GW + g) * 2] = m[g];
      sml[(rg * GW + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  // a thread per head: M = max m, L = sum e^(m - M) l, and each slice's
  // weight e^(m - M) in place of its m
  for (int head = tid; head < a.g; head += kFdThreads) {
    const int hs = head / a.per_set;  // its set
    const int gi = head - hs * a.per_set;
    float mx = kNegInf;
    for (int sl = 0; sl < slices; ++sl) mx = fmaxf(mx, sml[((sl * a.sets + hs) * GW + gi) * 2]);
    float lsum = 0.f;
    for (int sl = 0; sl < slices; ++sl) {
      float* ml = sml + ((sl * a.sets + hs) * GW + gi) * 2;
      ml[0] = expf(ml[0] - mx);
      lsum = fmaf(ml[0], ml[1], lsum);
    }
    a.part_ml[(pbase + head) * 2] = mx;
    a.part_ml[(pbase + head) * 2 + 1] = lsum;
  }
  __syncthreads();
  for (int e = tid; e < a.g * HD; e += kFdThreads) {
    const int head = e / HD;
    const int d = e % HD;
    const int hs = head / a.per_set;
    const int gi = head - hs * a.per_set;
    float asum = 0.f;
    for (int sl = 0; sl < slices; ++sl) {
      const int i = (sl * a.sets + hs) * GW + gi;
      asum = fmaf(sml[i * 2], sacc[i * HD + d], asum);
    }
    a.part_acc[(pbase + head) * HD + d] = asum;
  }
}

// one block per (batch, query head), a thread per column: the first
// kCombineBatch splits' acc values are loaded before the splits' m and l are
// staged in shared memory (then their weights e^(m_z - M)), so that the two
// latencies overlap
constexpr int kCombineThreads = 128;  // at least the largest head dim
constexpr int kCombineBatch = 16;
constexpr int kMaxSplits = 4096;  // shared memory of the combine: 2 floats a split

// lse (partial mode, else null): M + log L of each (batch, query head), kNegInf
// where no row was live
template <typename OutT>
__global__ void __launch_bounds__(kCombineThreads) flash_decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml, OutT* __restrict__ out,
    float* __restrict__ lse, int g, int n_splits, int hd) {
  extern __shared__ float cs[];  // [n_splits] m_z, then e^(m_z - M); [n_splits] l_z
  float* wz = cs;
  float* lz = cs + n_splits;
  const long long bh = blockIdx.x;  // b * H + h
  const long long row = bh / g;     // b * K + kvh
  const long long p0 = row * n_splits * g + (bh - row * g);  // split 0's partial; split z at + z g
  const int d = threadIdx.x;
  const bool live = d < hd;
  const float* src = part_acc + p0 * hd + d;  // split z's acc of column d at z g hd
  const long long zstride = static_cast<long long>(g) * hd;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the split pass is done
  float first[kCombineBatch];
#pragma unroll
  for (int z = 0; z < kCombineBatch; ++z) first[z] = live && z < n_splits ? src[z * zstride] : 0.f;
  for (int z = threadIdx.x; z < n_splits; z += kCombineThreads) {
    const long long i = p0 + static_cast<long long>(z) * g;
    wz[z] = part_ml[i * 2];
    lz[z] = part_ml[i * 2 + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int z = 0; z < n_splits; ++z) mx = fmaxf(mx, wz[z]);
  __syncthreads();
  for (int z = threadIdx.x; z < n_splits; z += kCombineThreads) wz[z] = expf(wz[z] - mx);
  __syncthreads();
  float lsum = 0.f;
  for (int z = 0; z < n_splits; ++z) lsum = fmaf(wz[z], lz[z], lsum);
  float asum = 0.f;
#pragma unroll
  for (int z = 0; z < kCombineBatch; ++z) {
    if (z < n_splits) asum = fmaf(wz[z], first[z], asum);
  }
#pragma unroll 8
  for (int z = kCombineBatch; z < n_splits; ++z) asum = fmaf(wz[z], src[z * zstride], asum);
  if (live) out[bh * hd + d] = from_f32<OutT>(asum / fmaxf(lsum, 1e-30f));
  if (lse != nullptr && d == 0) lse[bh] = lsum > 0.f ? mx + logf(lsum) : kNegInf;
}

template <typename QElem, typename KVElem, int HD, int GW>
int launch_split(const FdArgs& a, int rows, cudaStream_t stream) {
  auto kernel = flash_decode_split_kernel<QElem, KVElem, HD, GW>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(rows, a.n_splits), kFdThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename QElem, typename KVElem, int HD>
int launch_gw(const FdArgs& a, int rows, cudaStream_t stream) {
  return a.per_set == 1 ? launch_split<QElem, KVElem, HD, 1>(a, rows, stream)
                        : launch_split<QElem, KVElem, HD, 4>(a, rows, stream);
}

template <typename QElem, typename KVElem>
int launch_hd(const FdArgs& a, int hd, int rows, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_gw<QElem, KVElem, 16>(a, rows, stream);
    case 32: return launch_gw<QElem, KVElem, 32>(a, rows, stream);
    case 64: return launch_gw<QElem, KVElem, 64>(a, rows, stream);
    case 128: return launch_gw<QElem, KVElem, 128>(a, rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// launched as a programmatic dependent of the split pass: its blocks are
// resident as the split pass drains, so no launch gap sits between the two
template <typename OutT>
int launch_combine(const FdArgs& a, void* out, float* lse, int b, int h, int hd,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(b) * static_cast<unsigned int>(h));
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * static_cast<size_t>(a.n_splits);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<OutT>,
                                             static_cast<const float*>(a.part_acc),
                                             static_cast<const float*>(a.part_ml),
                                             static_cast<OutT*>(out), lse, a.g, a.n_splits,
                                             hd));
}

bool aligned16(const void* p, long long sb, long long ss, long long sh, int elem) {
  const long long unit = 16 / elem;
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && sb % unit == 0 && ss % unit == 0 &&
         sh % unit == 0;
}

// both modes: out in q's dtype and lse null (the whole cache, start 0), or
// out in f32 and lse written (a slice starting at `start`)
int launch_decode(const void* q, const void* k, const void* v, const int* positions,
                  long long start, float* part, void* out, float* lse, int b, int s, int h,
                  int kh, int hd, int q_dtype, int kv_dtype, float scale, int chunk,
                  int n_splits, int route, long long qsb, long long qsh, long long ksb,
                  long long kss, long long ksh, long long vsb, long long vss, long long vsh,
                  cudaStream_t stream) {
  if (b <= 0 || h <= 0) return 0;
  if (s <= 0 || kh <= 0 || h % kh != 0 || h / kh > kMaxGroup || chunk <= 0 || n_splits <= 0 ||
      static_cast<long long>(chunk) * n_splits < s ||
      static_cast<long long>(chunk) * (n_splits - 1) >= s || n_splits > kMaxSplits ||
      (route != 0 && route != 1) || start < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool q16 = q_dtype == kBF16;
  const bool kv16 = kv_dtype == kBF16;
  if ((q_dtype != kF32 && !q16) || (kv_dtype != kF32 && !kv16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = kv16 ? 2 : 4;
  if (route == 1 && !(aligned16(k, ksb, kss, ksh, elem) && aligned16(v, vsb, vss, vsh, elem))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int g = h / kh;
  // heads a row group carries: all of G <= 4 (one at G <= 2, in 1 or 2
  // sets), else G split over 2 or 4 sets
  const int sets = g == 2 ? 2 : g <= 4 ? 1 : g <= 8 ? 2 : 4;
  const int per_set = (g + sets - 1) / sets;
  const int rows = b * kh;
  const long long n_part = static_cast<long long>(rows) * n_splits * g;
  const FdArgs a{q, k, v, positions, part, part + n_part * hd, s, kh, g, chunk, n_splits,
                 sets, per_set, route, scale, start, qsb, qsh, ksb, kss, ksh, vsb, vss, vsh};
  int err;
  if (q16) {
    err = kv16 ? launch_hd<__nv_bfloat16, __nv_bfloat16>(a, hd, rows, stream)
               : launch_hd<__nv_bfloat16, float>(a, hd, rows, stream);
  } else {
    err = kv16 ? launch_hd<float, __nv_bfloat16>(a, hd, rows, stream)
               : launch_hd<float, float>(a, hd, rows, stream);
  }
  if (err != 0) return err;
  if (lse != nullptr || !q16) return launch_combine<float>(a, out, lse, b, h, hd, stream);
  return launch_combine<__nv_bfloat16>(a, out, nullptr, b, h, hd, stream);
}

}  // namespace

// (q, k, v, positions, part, out, B, S, H, K, hd, q dtype, kv dtype, scale,
//  chunk, n_splits, route, q strides b/h, k strides b/s/k, v strides b/s/k,
//  stream); part holds B*K*n_splits*G*(hd + 2) floats; route 1 (vec16) needs
// 16-byte aligned caches and strides, 0 (scalar) takes any
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const int* positions, float* part, void* out, int b, int s,
                                   int h, int kh, int hd, int q_dtype, int kv_dtype, float scale,
                                   int chunk, int n_splits, int route, long long qsb,
                                   long long qsh, long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   cudaStream_t stream) {
  return launch_decode(q, k, v, positions, 0, part, out, nullptr, b, s, h, kh, hd, q_dtype,
                       kv_dtype, scale, chunk, n_splits, route, qsb, qsh, ksb, kss, ksh, vsb,
                       vss, vsh, stream);
}

// the partial mode: (q, k, v, positions, start, part, out (f32), lse (f32),
// then as flash_decode_launch from B on); S is the slice's row count
extern "C" int flash_decode_partial_launch(const void* q, const void* k, const void* v,
                                           const int* positions, long long start, float* part,
                                           float* out, float* lse, int b, int s, int h, int kh,
                                           int hd, int q_dtype, int kv_dtype, float scale,
                                           int chunk, int n_splits, int route, long long qsb,
                                           long long qsh, long long ksb, long long kss,
                                           long long ksh, long long vsb, long long vss,
                                           long long vsh, cudaStream_t stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_decode(q, k, v, positions, start, part, out, lse, b, s, h, kh, hd, q_dtype,
                       kv_dtype, scale, chunk, n_splits, route, qsb, qsh, ksb, kss, ksh, vsb,
                       vss, vsh, stream);
}

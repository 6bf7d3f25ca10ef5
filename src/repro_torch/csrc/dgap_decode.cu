// dgap_decode: inclusive prefix sum of a d-gap stream, minus 1.
//
// Replaces the TPU kernel `_dgap_kernel` / `dgap_decode_2d` of
// src/repro/kernels/dgap_decode/kernel.py (with the `- 1` of its op).
// Contract (the only thing carried over):
//
//     out[i] = (gaps[0] + ... + gaps[i]) - 1     in wraparound 32-bit arithmetic
//
// The TPU form walks (128, 512) tiles in grid order and carries the running
// total from one grid step to the next in SMEM; it relies on the steps
// running in order.  A CUDA grid has no order, so the carry becomes a
// single-pass scan with decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA NVR-2016-002), one
// launch:
//
//   * a block takes its tile from an atomicAdd on a counter, not from
//     blockIdx, so every tile it waits for belongs to a block that is
//     already running (forward progress at any n, however many tiles);
//   * it loads its tile (16-byte loads where the stream is 16-byte aligned,
//     element loads otherwise), reduces it (per-thread runs in registers,
//     warp shuffles, the warps' totals in shared memory) and publishes the
//     tile's aggregate in its status word;
//   * its first warp looks back over the predecessors' status words, 32 at
//     a time, summing aggregates until it meets an inclusive prefix, then
//     publishes its own inclusive prefix;
//   * the block scans its tile in shared memory, adds the prefix, subtracts 1
//     and stores (16-byte stores on the aligned route).
//
// A status word is one 64-bit (flag, value) pair written with a single
// store, so a reader never sees a flag without its value.  The workspace
// (one counter word, then one status word per tile) has to read as empty at
// the start of every call: the launch function clears it with a one-block
// kernel on the call's stream, 8 B a tile (3 KB for 1.6 M values), and
// launches the scan as its programmatic dependent, so the scan's launch
// overlaps the clearing and its blocks wait (griddepcontrol.wait) only for
// the zeros (a cudaMemsetAsync in its place was measured to cost one more
// dependent launch on this card).  The clearing is the whole per-call cost
// besides the scan; the workspace is
// never cached across calls (two calls on two streams sharing one would wait
// on each other's tiles).
//
// The arithmetic is uint32_t, where wraparound is defined (signed overflow
// is undefined in C++); the int32 bits of the result are the reference's
// wrapped int32 values.  Real streams wrap: a positional index's
// concatenated d-gaps sum past 2^31.
//
// Bound on this card: bytes, 8 B per element (one 4 B read, one 4 B write;
// one add per element is far below the arithmetic rate).  This design reads
// and writes each element once; the status words add 16 B a tile.  Loads and
// stores are coalesced (consecutive threads on consecutive 16-byte words);
// the per-thread runs of kItems consecutive values go through shared memory,
// padded one word in 32 so that no bank is hit twice.
#include "common.cuh"

#include <cstdint>

constexpr unsigned kFull = 0xFFFFFFFFu;
// a status word: the flag in the high 32 bits, the tile's value in the low 32
// (0 = empty: the tile has published nothing yet)
constexpr unsigned long long kAggregate = 1ull << 32;  // value: the tile's own sum
constexpr unsigned long long kInclusive = 2ull << 32;  // value: the sum up to its end

static __device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// A status word is read and written whole by one relaxed 64-bit access at
// device scope: it carries its own value, so no other write has to be
// ordered before it (a release store or an acquire load would add a fence
// to every publication and every look-back read).
static __device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

static __device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Exclusive scan of one value per thread across a block of `kBlock` threads;
// `*total` receives the block's sum.  `warp_sums` is shared scratch of 32
// words.  Every thread of the block must call it (it synchronises).
template <int kBlock>
static __device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_sums,
                                                                uint32_t* total) {
  constexpr int kWarpsHere = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarpsHere ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarpsHere) warp_sums[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  const uint32_t before = warp > 0 ? warp_sums[warp - 1] : 0u;
  *total = warp_sums[kWarpsHere - 1];
  __syncthreads();  // warp_sums may be reused by the caller's next scan
  return before + x - v;
}

// Called by all 32 lanes of one warp: the sum of every tile before `tile`,
// read from the status words, 32 predecessors a step (lane l reads the one
// at distance 1 + l).  A step sums the aggregates up to the nearest
// inclusive prefix and stops there; it waits (re-reads the window) while a
// tile nearer than that has published nothing.  Before tile 0 reads as an
// inclusive prefix of 0.  Every lane returns the sum.  (Windows of 64 and
// 128 words a step were measured slower: a wider window waits more often
// for a tile that has not published yet.)
static __device__ uint32_t look_back(const unsigned long long* status, long long tile) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  for (long long end = tile;; end -= 32) {
    unsigned long long w;
    int first_inc;
    for (;;) {
      const long long p = end - 1 - lane;
      w = p >= 0 ? load_status(status + p) : kInclusive;
      const unsigned inc = __ballot_sync(kFull, (w >> 32) == 2u);
      const unsigned empty = __ballot_sync(kFull, (w >> 32) == 0u);
      first_inc = inc ? __ffs(inc) - 1 : 32;  // lanes past it do not count
      const int first_empty = empty ? __ffs(empty) - 1 : 32;
      if (first_empty >= first_inc) break;  // equal only when the window has neither
      __nanosleep(32);
    }
    prefix += __reduce_add_sync(kFull, lane <= first_inc ? static_cast<uint32_t>(w) : 0u);
    if (first_inc < 32) return prefix;
  }
}

// Values a thread scans, and a block's tile of kThreads * kItems = 4096
// values: the path's 1.6 M-value stream makes 392 tiles, about 3 an SM
// (8192-value tiles tied there and were slower on short lists).
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;

// One tile per block; kVec: 16-byte loads and stores (the stream and the
// output 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dgap_scan_kernel(const uint32_t* __restrict__ gaps, long long n, uint32_t* __restrict__ out,
                 unsigned long long* __restrict__ work) {
  static_assert(kItems % 4 == 0, "a thread's 16-byte words must not straddle tiles");
  __shared__ uint32_t tile[kTile + kTile / 32];
  __shared__ uint32_t warp_sums[32];
  __shared__ unsigned int s_ticket;
  __shared__ uint32_t s_prefix;
  const int tid = threadIdx.x;
  unsigned long long* status = work + 1;  // work[0] is the tile counter
  // launched while the clearing kernel runs: wait for it to finish (and for
  // its zeros to be visible) before touching the workspace
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0) s_ticket = atomicAdd(reinterpret_cast<unsigned int*>(work), 1u);
  __syncthreads();
  const long long t = s_ticket;
  const long long base = t * kTile;

  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const int k = 4 * (tid + j * kThreads);
      const long long i = base + k;
      uint4 v;
      if (i + 3 < n) {
        v = __ldg(reinterpret_cast<const uint4*>(gaps + i));
      } else {
        v.x = i < n ? __ldg(gaps + i) : 0u;
        v.y = i + 1 < n ? __ldg(gaps + i + 1) : 0u;
        v.z = i + 2 < n ? __ldg(gaps + i + 2) : 0u;
        v.w = 0u;
      }
      tile[padded(k)] = v.x;
      tile[padded(k + 1)] = v.y;
      tile[padded(k + 2)] = v.z;
      tile[padded(k + 3)] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int k = tid + j * kThreads;
      const long long i = base + k;
      tile[padded(k)] = i < n ? __ldg(gaps + i) : 0u;
    }
  }
  __syncthreads();

  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) acc += tile[padded(tid * kItems + j)];
  uint32_t total;
  const uint32_t before = block_exclusive_scan<kThreads>(acc, warp_sums, &total);

  if (tid < 32) {
    uint32_t prefix = 0;
    if (t == 0) {
      if (tid == 0) store_status(status, kInclusive | total);
    } else {
      if (tid == 0) store_status(status + t, kAggregate | total);
      prefix = look_back(status, t);
      if (tid == 0) store_status(status + t, kInclusive | static_cast<uint32_t>(prefix + total));
    }
    if (tid == 0) s_prefix = prefix;
  }
  __syncthreads();

  uint32_t run = s_prefix + before - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = padded(tid * kItems + j);
    run += tile[p];
    tile[p] = run;
  }
  __syncthreads();

  if constexpr (kVec) {
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const int k = 4 * (tid + j * kThreads);
      const long long i = base + k;
      const uint4 v = make_uint4(tile[padded(k)], tile[padded(k + 1)], tile[padded(k + 2)],
                                 tile[padded(k + 3)]);
      if (i + 3 < n) {
        *reinterpret_cast<uint4*>(out + i) = v;
      } else {
        if (i < n) out[i] = v.x;
        if (i + 1 < n) out[i + 1] = v.y;
        if (i + 2 < n) out[i + 2] = v.z;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int k = tid + j * kThreads;
      const long long i = base + k;
      if (i < n) out[i] = tile[padded(k)];
    }
  }
}

// Zeroes the workspace (the tile counter and every status word).  It lets
// the scan grid launch at once (programmatic dependent launch), so the scan's
// launch overlaps this kernel instead of waiting for it to end.
__global__ void __launch_bounds__(kThreads)
dgap_clear_kernel(unsigned long long* __restrict__ work, long long words) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (long long i = threadIdx.x; i < words; i += kThreads) work[i] = 0ull;
}

static cudaError_t launch_tiles(const uint32_t* g, uint32_t* o, unsigned long long* work,
                                long long n, long long n_tiles, bool vec, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(n_tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return vec ? cudaLaunchKernelEx(&cfg, dgap_scan_kernel<true>, g, n, o, work)
             : cudaLaunchKernelEx(&cfg, dgap_scan_kernel<false>, g, n, o, work);
}

// route: 0 element loads, 1 16-byte loads and stores (both pointers 16-byte
// aligned, else refused).  workspace: at least ceil(n / 4096) + 1 words of 8
// bytes, allocated by the caller; `workspace_len` is its length in those
// words.
extern "C" int dgap_decode_launch(const int* gaps, int* out, long long* workspace,
                                  long long workspace_len, long long n, int route,
                                  cudaStream_t stream) {
  if (n <= 0) return 0;
  if (route != 0 && route != 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0x7FFFFFFFLL || workspace_len < n_tiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = route == 1;
  if (vec && ((reinterpret_cast<uintptr_t>(gaps) | reinterpret_cast<uintptr_t>(out)) & 15u)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  auto* work = reinterpret_cast<unsigned long long*>(workspace);
  dgap_clear_kernel<<<1, kThreads, 0, stream>>>(work, n_tiles + 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* g = reinterpret_cast<const uint32_t*>(gaps);
  auto* o = reinterpret_cast<uint32_t*>(out);
  return static_cast<int>(launch_tiles(g, o, work, n, n_tiles, vec, stream));
}

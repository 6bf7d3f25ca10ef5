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
// device-wide scan in three launches on one stream (each launch sees the
// previous one's writes; no block waits for another):
//
//   1. tile_sums:  each block reduces one tile of kTile values to its sum;
//   2. scan_sums:  one block turns the tile sums into exclusive tile offsets,
//                  looping with a carry, so any number of tiles works;
//   3. scan_tiles: each block scans its tile again (per-thread runs in
//                  registers, warp shuffles, then the warps' totals in
//                  shared memory), adds its tile's offset, subtracts 1.
//
// The arithmetic is uint32_t, where wraparound is defined (signed overflow
// is undefined in C++); the int32 bits of the result are the reference's
// wrapped int32 values.  Real streams wrap: a positional index's
// concatenated d-gaps sum past 2^31.
//
// Bound on this card: bytes, 8 B per element (one 4 B read, one 4 B write;
// one add per element is far below the arithmetic rate).  This three-phase
// design reads the stream twice, 12 B per element, so it can reach at most
// 2/3 of that bound; a single-pass scan with decoupled look-back would reach
// it and is later work.  Loads and stores are coalesced (consecutive threads
// on consecutive words; the per-thread runs of kItems consecutive values go
// through shared memory, padded one word in 32 so that no bank is hit twice).
#include "common.cuh"

#include <cstdint>

constexpr int kItems = 16;                    // values one thread scans in registers
constexpr int kTile = kThreads * kItems;      // values per block (4096)
constexpr int kSumThreads = 1024;             // threads of the one tile-sum scan block
constexpr unsigned kFull = 0xFFFFFFFFu;

static __device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

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

__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const uint32_t* __restrict__ gaps, long long n, uint32_t* __restrict__ sums) {
  __shared__ uint32_t warp_sums[32];
  const long long base = blockIdx.x * static_cast<long long>(kTile);
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + threadIdx.x + j * kThreads;
    if (i < n) s += __ldg(gaps + i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sums[w];
    sums[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kSumThreads)
scan_sums_kernel(uint32_t* __restrict__ sums, long long n_tiles) {
  __shared__ uint32_t warp_sums[32];
  uint32_t carry = 0;
  for (long long c = 0; c < n_tiles; c += kSumThreads) {
    const long long i = c + threadIdx.x;
    const uint32_t v = i < n_tiles ? sums[i] : 0u;
    uint32_t total;
    const uint32_t excl = block_exclusive_scan<kSumThreads>(v, warp_sums, &total);
    if (i < n_tiles) sums[i] = carry + excl;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(const uint32_t* __restrict__ gaps, long long n,
                  const uint32_t* __restrict__ offsets, uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kTile + kTile / 32];
  __shared__ uint32_t warp_sums[32];
  const long long base = blockIdx.x * static_cast<long long>(kTile);
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = tid + j * kThreads;
    const long long i = base + k;
    tile[padded(k)] = i < n ? __ldg(gaps + i) : 0u;
  }
  __syncthreads();
  uint32_t run[kItems];
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    acc += tile[padded(tid * kItems + j)];
    run[j] = acc;
  }
  uint32_t total;
  const uint32_t before = block_exclusive_scan<kThreads>(acc, warp_sums, &total);
  const uint32_t shift = offsets[blockIdx.x] + before - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) tile[padded(tid * kItems + j)] = run[j] + shift;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = tid + j * kThreads;
    const long long i = base + k;
    if (i < n) out[i] = tile[padded(k)];
  }
}

// workspace: at least ceil(n / kTile) words (the tile sums, then their
// offsets), allocated by the caller; `workspace_len` is its length.
extern "C" int dgap_decode_launch(const int* gaps, int* out, int* workspace,
                                  long long workspace_len, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0x7FFFFFFFLL || workspace_len < n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* g = reinterpret_cast<const uint32_t*>(gaps);
  auto* sums = reinterpret_cast<uint32_t*>(workspace);
  const unsigned int blocks = static_cast<unsigned int>(n_tiles);
  tile_sums_kernel<<<blocks, kThreads, 0, stream>>>(g, n, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_sums_kernel<<<1, kSumThreads, 0, stream>>>(sums, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tiles_kernel<<<blocks, kThreads, 0, stream>>>(g, n, sums,
                                                     reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

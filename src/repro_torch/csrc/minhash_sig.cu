// minhash_rows: MinHash signatures of a (D, L) tile of hashed shingles.
//
// Replaces the TPU kernel `_sig_kernel` / `minhash_rows_2d` of
// src/repro/kernels/minhash_sig/kernel.py:61.  Contract (the only thing
// carried over):
//
//     out[d, p] = min over l < min(lens[d], L) of (a[p] * s[d, l] + b[p]) mod 2^32
//
// as an unsigned minimum; a row with no live lane gives 0xFFFFFFFF.  Lanes at
// or past lens[d] are never read, whatever they hold.
//
// The TPU form runs one grid step per (64-row block, permutation) and flips
// the sign bit so that the vector unit's signed min gives the unsigned order.
// Here the arithmetic is uint32_t, where wraparound is defined and the unsigned
// min is native, so there is no flip (and no signed overflow, which C++ leaves
// undefined).  The result is the uint32 signature itself; the wrapper hands
// its bits back as int32.
//
// Bound on this card: operations.  Per (live lane, hash) the function does one
// multiply-add and one min (2 integer operations) against 4 B read per live
// lane for all P hashes, so at P = 64 it needs 32 operations per byte, above
// the card's balance of 20 (67 TOP/s over 3.35 TB/s).  The design's own
// ceiling is the integer issue rate: an int32 multiply-add issues at half the
// float32 rate (64 lanes a clock on an SM), and ptxas folds two mins into one
// three-input min (VIMNMX3) on another pipe, so the inner loop is one IMAD
// per (lane, hash) plus half a min.  The earlier design (one block a row,
// 32 hashes a thread, a block-wide reduction per 32 hashes) spent its time
// in the reduction and its barriers.  This one:
//
//   * one warp takes one (row, chunk of kChunkLanes lanes): short rows cost
//     one warp, and a long row's chunks go to as many warps, so the skew of
//     posting lists (1 to thousands of lanes) leaves no warp far longer than
//     another.  No shared memory and no barrier: a warp reads its row's
//     length, hashes, and writes;
//   * a thread owns kHashes hashes (their a, b and running minima in
//     registers); kGroups threads (the fewest, a power of two, that hold all
//     P hashes; at most 32, more than 256 hashes take several passes) form
//     a slice, and the warp's 32 / kGroups slices split the chunk's lanes.  A slice reads kGroups consecutive lanes with one
//     coalesced load, kAhead loads ahead of the lanes it hashes, and hands
//     each lane to its threads by a shuffle; a lane index past the chunk's
//     end is clamped to its last lane, which repeats a live lane and cannot
//     change a minimum, so every slice takes the same number of steps and
//     the inner loop has no branch, no barrier and no exchange but the
//     shuffle;
//   * the slices' minima combine by xor shuffles; a row within one chunk
//     (every row when L <= kChunkLanes: route `one_pass`, one launch) is
//     stored by its one warp.  The chunks of a longer row (route `chunked`)
//     combine with atomicMin on unsigned int into an output that a clearing
//     kernel has set to 0xFFFFFFFF on those rows first.  The clearing kernel
//     lets the signature grid launch at once (programmatic dependent
//     launch): its warps hash, and wait for the clearing only before they
//     write.  Min is associative and commutative, so any order of the
//     combine gives the same bits.
#include "common.cuh"

#include <climits>
#include <cstdint>

namespace {

constexpr int kHashes = 8;                   // hashes a thread keeps in registers
constexpr int kChunkLanes = 512;             // lanes of one row that one warp takes
constexpr int kWarps = kThreads / 32;        // warps a block
constexpr int kAhead = 2;                    // a slice's loads in flight
constexpr int kMaxPerm = 4096;               // hash parameters one launch takes

__device__ __forceinline__ uint32_t min_u32(uint32_t x, uint32_t y) { return x < y ? x : y; }

__device__ __forceinline__ long long live_lanes(const int* lens, long long d, long long L) {
  const long long n = lens[d];
  return n < 0 ? 0 : (n > L ? L : n);
}

// One warp a (row, chunk).  kGroups threads (a power of two) hold kHashes
// hashes each, so that a slice of kGroups threads holds a block of kGroups
// x kHashes hashes; the warp's 32 / kGroups slices split the chunk's lanes,
// then combine by shuffles.  `hash_blocks` blocks of hashes cover P (more
// than one only for P > 256).  A slice reads kGroups consecutive lanes with
// one load of its threads, kAhead such loads ahead of the lanes it hashes,
// and hands each lane to its threads by a shuffle.
template <int kGroups>
__global__ void __launch_bounds__(kThreads)
minhash_rows_kernel(const uint32_t* __restrict__ shingles, const int* __restrict__ lens,
                    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, long long D, long long L, int P,
                    int hash_blocks, int n_chunks, bool chunked) {
  constexpr int kSlices = 32 / kGroups;
  const int lane = threadIdx.x & 31;
  const long long u = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long d = u / n_chunks;
  if (d >= D) return;
  const int c = static_cast<int>(u - d * n_chunks);
  const long long n = live_lanes(lens, d, L);
  const long long lo = static_cast<long long>(c) * kChunkLanes;
  const int cnt = n - lo <= 0 ? 0 : (n - lo > kChunkLanes ? kChunkLanes : static_cast<int>(n - lo));
  if (cnt == 0 && c > 0) return;  // a chunk past the row's end: nothing to add
  const bool split = n > kChunkLanes;  // the row's chunks combine by atomicMin

  const int slice = lane / kGroups;
  const int hg = lane % kGroups;
  // every slice makes the same number of steps of kGroups lanes (so the
  // warp's shuffles stay converged); a lane index past the chunk's end is
  // clamped to its last lane: a repeated live lane cannot change a minimum
  const int per = ((cnt + kSlices - 1) / kSlices + kGroups - 1) / kGroups * kGroups;
  const int steps = per / kGroups;
  const int first = slice * per + hg;
  const int last = cnt - 1;
  const uint32_t* row = shingles + d * L + lo;

  for (int hb = 0; hb < hash_blocks; ++hb) {
    const int h0 = (hb * kGroups + hg) * kHashes;
    uint32_t ra[kHashes], rb[kHashes], m[kHashes];
#pragma unroll
    for (int j = 0; j < kHashes; ++j) {
      // a padding hash (p >= P) is computed like the others and never written
      ra[j] = h0 + j < P ? __ldg(a + h0 + j) : 0u;
      rb[j] = h0 + j < P ? __ldg(b + h0 + j) : 0xFFFFFFFFu;
      m[j] = 0xFFFFFFFFu;
    }
    if (cnt > 0) {
      uint32_t next[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) next[k] = __ldg(row + min(first + k * kGroups, last));
      for (int t = 0; t < steps; t += kAhead) {
        uint32_t cur[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          cur[k] = next[k];
          next[k] = __ldg(row + min(first + (t + kAhead + k) * kGroups, last));
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          if (t + k < steps) {
#pragma unroll
            for (int e = 0; e < kGroups; ++e) {
              const uint32_t s = __shfl_sync(0xFFFFFFFFu, cur[k], e, kGroups);
#pragma unroll
              for (int j = 0; j < kHashes; ++j) m[j] = min_u32(m[j], ra[j] * s + rb[j]);
            }
          }
        }
      }
    }
    // the slices' minima of each hash, by shuffles across the warp
#pragma unroll
    for (int j = 0; j < kHashes; ++j) {
#pragma unroll
      for (int off = kGroups; off < 32; off <<= 1) {
        m[j] = min_u32(m[j], __shfl_xor_sync(0xFFFFFFFFu, m[j], off));
      }
    }
    if (chunked) asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the clearing is done
    if (slice == 0) {
#pragma unroll
      for (int j = 0; j < kHashes; ++j) {
        if (h0 + j < P) {
          uint32_t* o = out + d * P + h0 + j;
          if (split) {
            atomicMin(o, m[j]);
          } else {
            *o = m[j];  // the row's one warp (c == 0)
          }
        }
      }
    }
  }
}

// Sets the signatures of the rows longer than one chunk to 0xFFFFFFFF, the
// identity of the chunks' atomicMin combine.  It lets the signature grid
// launch at once (programmatic dependent launch).
__global__ void __launch_bounds__(kThreads)
minhash_clear_kernel(const int* __restrict__ lens, uint32_t* __restrict__ out, long long D,
                     long long L, int P) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long n = D * P;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    if (live_lanes(lens, i / P, L) > kChunkLanes) out[i] = 0xFFFFFFFFu;
  }
}

}  // namespace

// (shingles, lens, a, b, out, D, L, P, route, stream)
// route: 0 `one_pass` (every row within one chunk: L <= kChunkLanes, else
// refused), 1 `chunked` (any L: a clearing kernel, then the signature grid
// as its programmatic dependent).
extern "C" int minhash_rows_launch(const int* shingles, const int* lens, const int* a,
                                   const int* b, int* out, long long D, long long L, int P,
                                   int route, cudaStream_t stream) {
  if (D <= 0 || P <= 0) return 0;
  if (D > INT_MAX || P > kMaxPerm || L < 0 || route < 0 || route > 1 ||
      (route == 0 && L > kChunkLanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int groups = 1;  // threads a slice: a power of two, at most 32
  while (groups < 32 && groups * kHashes < P) groups <<= 1;
  const int hash_blocks = (P + groups * kHashes - 1) / (groups * kHashes);
  const long long n_chunks = L > kChunkLanes ? (L + kChunkLanes - 1) / kChunkLanes : 1;
  const long long blocks = (D * n_chunks + kWarps - 1) / kWarps;
  if (blocks > INT_MAX || n_chunks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto* s = reinterpret_cast<const uint32_t*>(shingles);
  const auto* pa = reinterpret_cast<const uint32_t*>(a);
  const auto* pb = reinterpret_cast<const uint32_t*>(b);
  auto* o = reinterpret_cast<uint32_t*>(out);
  const int nc = static_cast<int>(n_chunks);
  using Kernel = void (*)(const uint32_t*, const int*, const uint32_t*, const uint32_t*,
                         uint32_t*, long long, long long, int, int, int, bool);
  const Kernel kernels[] = {minhash_rows_kernel<1>, minhash_rows_kernel<2>,
                            minhash_rows_kernel<4>, minhash_rows_kernel<8>,
                            minhash_rows_kernel<16>, minhash_rows_kernel<32>};
  const Kernel kernel = kernels[__builtin_ctz(static_cast<unsigned>(groups))];
  if (route == 0) {
    kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        s, lens, pa, pb, o, D, L, P, hash_blocks, nc, false);
    return static_cast<int>(cudaGetLastError());
  }
  const long long n = D * P;
  const long long clear_blocks = (n + kThreads - 1) / kThreads;
  minhash_clear_kernel<<<static_cast<unsigned int>(clear_blocks < 1024 ? clear_blocks : 1024),
                         kThreads, 0, stream>>>(lens, o, D, L, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, s, lens, pa, pb, o, D, L, P,
                                             hash_blocks, nc, true));
}

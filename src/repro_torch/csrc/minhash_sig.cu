// minhash_rows: MinHash signatures of a (D, L) tile of hashed shingles.
//
// Replaces the TPU kernel `_sig_kernel` / `minhash_rows_2d` of
// src/repro/kernels/minhash_sig/kernel.py.  Contract (the only thing carried
// over):
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
// the card's balance of 20 (67 TOP/s over 3.35 TB/s; the int32 multiply-add
// rate is half the float32 one, which only widens the gap).  The design
// spends the registers on that: one block per row, its threads striding over the row's
// live lanes (consecutive threads on consecutive lanes, so the reads
// coalesce), each thread keeping the running minima of a chunk of kChunk
// hashes in registers beside that chunk's a and b.  A lane is read once per
// chunk (P / kChunk times in all; the second read hits L1 or L2).  The chunk
// is reduced across the warp with __reduce_min_sync (unsigned on sm_80+) and
// across the block's warps in shared memory.  The hash parameters are staged
// in shared memory once per block, padded to a whole chunk with (a, b) =
// (0, 0xFFFFFFFF): a padding hash gives the empty signature on every lane, so
// it never lowers a minimum and the inner loop needs no bound check.
#include "common.cuh"

#include <cstdint>

constexpr int kChunk = 32;              // hashes whose minima a thread keeps in registers
constexpr int kWarps = kThreads / 32;   // warps per block
constexpr int kMaxPerm = 4096;          // hash parameters one launch stages (32 KiB)

static __device__ __forceinline__ uint32_t min_u32(uint32_t x, uint32_t y) {
  return x < y ? x : y;
}

__global__ void __launch_bounds__(kThreads)
minhash_rows_kernel(const uint32_t* __restrict__ shingles, const int* __restrict__ lens,
                    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, long long L, int P, int p_pad) {
  extern __shared__ uint32_t params[];  // a in [0, p_pad), b in [p_pad, 2 p_pad)
  __shared__ uint32_t partial[kWarps][kChunk];
  const int tid = threadIdx.x;
  for (int i = tid; i < p_pad; i += kThreads) {
    params[i] = i < P ? a[i] : 0u;
    params[p_pad + i] = i < P ? b[i] : 0xFFFFFFFFu;
  }
  __syncthreads();

  const long long d = blockIdx.x;
  long long n = lens[d];
  n = n < 0 ? 0 : (n > L ? L : n);
  const uint32_t* row = shingles + d * L;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int p0 = 0; p0 < P; p0 += kChunk) {
    uint32_t ra[kChunk], rb[kChunk], m[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      ra[c] = params[p0 + c];
      rb[c] = params[p_pad + p0 + c];
      m[c] = 0xFFFFFFFFu;
    }
    for (long long i = tid; i < n; i += kThreads) {
      const uint32_t s = __ldg(row + i);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) m[c] = min_u32(m[c], ra[c] * s + rb[c]);
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const uint32_t w = __reduce_min_sync(0xFFFFFFFFu, m[c]);
      if (lane == 0) partial[warp][c] = w;
    }
    __syncthreads();
    if (tid < kChunk && p0 + tid < P) {
      uint32_t v = partial[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v = min_u32(v, partial[w][tid]);
      out[d * P + p0 + tid] = v;
    }
    __syncthreads();  // `partial` is rewritten by the next chunk
  }
}

extern "C" int minhash_rows_launch(const int* shingles, const int* lens, const int* a,
                                   const int* b, int* out, long long D, long long L, int P,
                                   cudaStream_t stream) {
  if (D <= 0 || P <= 0) return 0;
  if (D > 0x7FFFFFFFLL || P > kMaxPerm) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p_pad = (P + kChunk - 1) / kChunk * kChunk;
  const size_t smem = 2 * static_cast<size_t>(p_pad) * sizeof(uint32_t);
  minhash_rows_kernel<<<static_cast<unsigned int>(D), kThreads, smem, stream>>>(
      reinterpret_cast<const uint32_t*>(shingles), lens,
      reinterpret_cast<const uint32_t*>(a), reinterpret_cast<const uint32_t*>(b),
      reinterpret_cast<uint32_t*>(out), L, P, p_pad);
  return static_cast<int>(cudaGetLastError());
}

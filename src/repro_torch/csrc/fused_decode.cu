// decode_rows / probe_rows: bounded rule expansion for the fused layout.
//
// Replace the TPU kernels `_decode_kernel` / `decode_rows_2d` and
// `_probe_kernel` / `probe_rows_2d` of
// src/repro/kernels/fused_decode/kernel.py.  A row is one Re-Pair C entry:
// `ptr[r]` points at its prefix-summed leaf d-gaps in the shared pool,
// `lens[r]` says how many there are, `base[r]` is its anchor.
//
//     decode_rows:  values[r, l] = base[r] + pool[ptr[r] + l]   for all l < L
//                   valid[r, l]  = l < lens[r]
//     probe_rows:   hit[r] = any_{l < lens[r]} (base[r] + pool[ptr[r] + l] == target[r])
//
// The TPU forms take an (R, L) tile that was gathered from the pool outside
// the kernel, because the ragged gather does not fit the block model there.
// Here the gather is the kernel: each thread reads pool[ptr[r] + l] itself,
// so the (R, L) staging tensor — L*L*B*64 words per probed term on the
// serving path — never exists.  Reads are clamped to the pool (pool_n - 1)
// so a lane past a short row's end stays inside the allocation; the pool's
// tail padding of max_phrase zeros makes the clamp a no-op on the serving
// path, and the plain PyTorch versions clamp the same way.
//
// decode_rows — bound: bytes.  It must write 5 B per output lane (int32
// value + bool) and read 12 B per row; the pool reads hit L2.  One thread
// per (r, l), consecutive threads on consecutive l: both stores coalesce.
//
// probe_rows — bound: bytes (16 B in, 1 B out per row) once the search is
// cheap.  Design choice: ONE THREAD PER ROW WITH A BINARY SEARCH INSIDE THE
// ROW, not a warp scanning lens[r] lanes.  A pool row is a prefix sum of
// gaps >= 1, hence strictly increasing, so membership of target - base is a
// lower bound plus one compare: ceil(log2(lens)) + 1 L2 loads instead of
// lens.  Precondition (holds for every pool built by
// CompressedAnchoredIndex): pool[ptr[r] .. ptr[r] + lens[r]) is strictly
// increasing as signed int32.  Both kernels add in int32 with wraparound, as
// the plain versions' int32 add does: probe_rows searches the row for the
// wrapped difference target - base, and base + x == target (mod 2^32) holds
// exactly when x == target - base (mod 2^32), so hit[r] is "some live lane of
// decode_rows equals target" at the top of the int32 range too.
#include "common.cuh"

__global__ void decode_rows_kernel(const int* __restrict__ pool, long long pool_n,
                                   const int* __restrict__ ptr,
                                   const int* __restrict__ base,
                                   const int* __restrict__ lens, int* __restrict__ values,
                                   unsigned char* __restrict__ valid, long long total,
                                   int L) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long r = i / L;
  const int l = static_cast<int>(i - r * L);
  long long at = static_cast<long long>(ptr[r]) + l;
  at = at < 0 ? 0 : (at >= pool_n ? pool_n - 1 : at);
  // wraparound add, as the plain version's int32 add
  values[i] = static_cast<int>(static_cast<unsigned int>(base[r]) +
                               static_cast<unsigned int>(__ldg(pool + at)));
  valid[i] = l < lens[r] ? 1 : 0;
}

extern "C" int decode_rows_launch(const int* pool, long long pool_n, const int* ptr,
                                  const int* base, const int* lens, int* values,
                                  unsigned char* valid, long long rows, int L,
                                  cudaStream_t stream) {
  const long long total = rows * L;
  if (total <= 0) return 0;
  decode_rows_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
      pool, pool_n, ptr, base, lens, values, valid, total, L);
  return static_cast<int>(cudaGetLastError());
}

__global__ void probe_rows_kernel(const int* __restrict__ pool, long long pool_n,
                                  const int* __restrict__ ptr,
                                  const int* __restrict__ base,
                                  const int* __restrict__ lens,
                                  const int* __restrict__ targets,
                                  unsigned char* __restrict__ hit, long long rows) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= rows) return;
  const int n = lens[r];
  const long long p = ptr[r];
  // wraparound difference: pool[.] == tt  <=>  base + pool[.] == target in int32
  const int tt = static_cast<int>(static_cast<unsigned int>(targets[r]) -
                                  static_cast<unsigned int>(base[r]));
  int l = 0;
  int h = n;
  while (l < h) {
    const int mid = l + ((h - l) >> 1);
    long long at = p + mid;
    at = at < 0 ? 0 : (at >= pool_n ? pool_n - 1 : at);
    if (__ldg(pool + at) < tt) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  unsigned char found = 0;
  if (l < n) {
    long long at = p + l;
    at = at < 0 ? 0 : (at >= pool_n ? pool_n - 1 : at);
    found = __ldg(pool + at) == tt ? 1 : 0;
  }
  hit[r] = found;
}

extern "C" int probe_rows_launch(const int* pool, long long pool_n, const int* ptr,
                                 const int* base, const int* lens, const int* targets,
                                 unsigned char* hit, long long rows, cudaStream_t stream) {
  if (rows <= 0) return 0;
  probe_rows_kernel<<<blocks_for(rows), kThreads, 0, stream>>>(pool, pool_n, ptr, base,
                                                               lens, targets, hit, rows);
  return static_cast<int>(cudaGetLastError());
}

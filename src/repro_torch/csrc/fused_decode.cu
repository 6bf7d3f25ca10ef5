// Bounded rule expansion for the fused layout: decode and probe of pool rows.
//
// Replace the TPU kernels `_decode_kernel` / `decode_rows_2d` and
// `_probe_kernel` / `probe_rows_2d` of
// src/repro/kernels/fused_decode/kernel.py, and on the fused serving path
// also the sliced anchor search `anchor_probe_sliced_2d` of
// src/repro/kernels/anchor_intersect/kernel.py.  A row is one Re-Pair C
// entry: `ptr` points at its prefix-summed leaf d-gaps in the shared pool,
// `len` says how many there are, `base` is its anchor.
//
//     decode:  values[r, l] = base[r] + pool[ptr[r] + l]   for all l < L
//              valid[r, l]  = l < len[r]
//     probe:   hit = any_{l < len} (base + pool[ptr + l] == target)
//
// Each body is a template on where its rows come from:
//
//   * GivenRows / GivenProbes — the public ops decode_rows / probe_rows: the
//     caller gathered ptr, base, len (and the target) of every row;
//   * WindowRows — decode_window: the rows are derived in the kernel from a
//     candidate window, as serving/engine.py `fused_candidates_for` derives
//     them: row k of query b is `c_offsets[id] + row_start + k` for the
//     query's driving list id, live while below `c_offsets[id + 1]`, clamped
//     into the entry table, with len 0 where it is not live;
//   * WindowProbes — probe_window: one thread per (query, candidate) loops
//     over the query's terms t = 1 .. min(len, W) - 1 and stops at the first
//     miss, as serving/engine.py `_probe_terms` with the fused member: the
//     target is the candidate (AND) or candidate + t (phrase; a candidate
//     above 2^31 - 2 - t misses, so the target never wraps), the covering
//     entry j = max(l - 1, lo) comes from a bisection of the term's anchor
//     slice [lo, hi) for the first anchor >= target, and the probe is then
//     the row search below on entry j.  An empty slice misses.  A block
//     covers kThreads candidates of one query and stages that query's
//     slices in shared memory first, so each (query, term) slice is read
//     from memory once a block, not once a candidate.
//
// A serving window is thus two launches — decode_window, probe_window —
// where the row-given route made 1 + 2 (W - 1) plus the torch ops between
// them.  At the serving shapes a launch costs within a few microseconds of
// an empty one, so the launches, not the bodies, were the time.
//
// The TPU forms take an (R, L) tile gathered from the pool outside the
// kernel, because the ragged gather does not fit the block model there.
// Here the gather is the kernel: each thread reads pool[ptr + l] itself, so
// the (R, L) staging tensor never exists.  Every read is guarded as the
// plain PyTorch versions guard it: pool reads clamp to [0, pool_n), entry
// reads to [0, n_entries), list ids to the offsets table, so nothing is
// read out of range even on the padded rows of a query with an unknown term
// (its term ids are 0, its length 1).  The pool's tail padding of
// max_phrase zeros makes the pool clamp a no-op on the serving path.
//
// Decode — bound: bytes.  It must write 5 B per output lane (int32 value +
// bool) and read the rows; the pool reads hit L2.  A block covers a run of
// consecutive rows (kThreads lanes' worth, at least one row): its threads
// first derive each row once into shared memory (one thread a row:
// on the window route that is the id -> offsets -> entry chain), then walk
// the block's lanes with consecutive threads on consecutive lanes, so both
// stores coalesce and a lane costs one shared load and one pool load: the
// row's chain of dependent loads runs once a row, not once a lane (at L
// 4,000 that chain in every lane was most of the time).  A thread carries
// its (row, lane) from step to step instead of dividing.
//
// Probe — one thread per probe with a binary search inside the row, not a
// warp scanning its lanes.  A pool row is a prefix sum of gaps >= 1, hence
// strictly increasing, so membership of target - base is a lower bound plus
// one compare: ceil(log2(len)) + 1 L2 loads instead of len.  Precondition
// (holds for every pool built by CompressedAnchoredIndex):
// pool[ptr .. ptr + len) is strictly increasing as signed int32, and so is
// every list's anchor slice.  Both bodies add in int32 with wraparound, as
// the plain versions' int32 add does: the probe searches the row for the
// wrapped difference target - base, and base + x == target (mod 2^32) holds
// exactly when x == target - base (mod 2^32), so a hit is "some live lane of
// the decode equals target" at the top of the int32 range too.
#include "common.cuh"

#include <climits>

struct PoolRow {
  long long ptr;
  int base;
  int len;
};

// x clamped into [0, n) (n >= 1)
static __device__ __forceinline__ long long clamp_index(long long x, long long n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

// int32 add / subtract with wraparound (in uint32_t, where it is defined)
static __device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) + static_cast<unsigned int>(b));
}
static __device__ __forceinline__ int sub_wrap(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) - static_cast<unsigned int>(b));
}

// ---------------------------------------------------------------- row sources
struct GivenRows {
  const int* ptr;
  const int* base;
  const int* lens;
  __device__ PoolRow operator()(long long r) const { return {ptr[r], base[r], lens[r]}; }
};

struct WindowRows {
  const int* c_offsets;
  long long n_offsets;  // n_lists + 1
  const int* anchors;
  const int* c_ptr;
  const int* c_len;
  long long n_entries;  // >= 1 (the wrapper launches nothing for an empty table)
  const int* list_ids;
  long long ids_stride;
  long long row_start;
  int window_rows;
  __device__ PoolRow operator()(long long r) const {
    const long long b = r / window_rows;
    const long long id = __ldg(list_ids + b * ids_stride);
    const long long lo = __ldg(c_offsets + clamp_index(id, n_offsets));
    const long long hi = __ldg(c_offsets + clamp_index(id + 1, n_offsets));
    const long long row = lo + row_start + (r - b * window_rows);
    const long long at = clamp_index(row, n_entries);
    return {__ldg(c_ptr + at), __ldg(anchors + at), row < hi ? __ldg(c_len + at) : 0};
  }
};

// rows a decode block covers: a lane a thread where a row fits the block (so
// a short window still spreads over many blocks), one row a block past that
static inline int decode_rows_per_block(int L) { return L >= kThreads ? 1 : kThreads / L; }

template <class Rows>
__global__ void decode_kernel(const int* __restrict__ pool, long long pool_n, Rows rows,
                              int* __restrict__ values, unsigned char* __restrict__ valid,
                              long long n_rows, int L, int rows_per_block) {
  extern __shared__ PoolRow block_rows[];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int n = static_cast<int>(min(static_cast<long long>(rows_per_block), n_rows - row0));
  for (int r = threadIdx.x; r < n; r += blockDim.x) block_rows[r] = rows(row0 + r);
  __syncthreads();
  int* const out = values + row0 * L;
  unsigned char* const out_valid = valid + row0 * L;
  const int lanes = n * L;  // <= max(kThreads, L)
  const int step_r = blockDim.x / L;
  const int step_l = blockDim.x - step_r * L;
  int r = threadIdx.x / L;
  int l = threadIdx.x - r * L;
#pragma unroll 4
  for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
    const PoolRow row = block_rows[r];
    out[i] = add_wrap(row.base, __ldg(pool + clamp_index(row.ptr + l, pool_n)));
    out_valid[i] = l < row.len ? 1 : 0;
    r += step_r;
    l += step_l;
    if (l >= L) {
      l -= L;
      ++r;
    }
  }
}

// ---------------------------------------------------------------- probe sources
// The row search shared by both probes: is target among row's first len
// decoded lanes?
static __device__ __forceinline__ bool row_holds(const int* __restrict__ pool, long long pool_n,
                                                 const PoolRow& row, int target) {
  const int tt = sub_wrap(target, row.base);
  int l = 0;
  int h = row.len;
  while (l < h) {
    const int mid = l + ((h - l) >> 1);
    if (__ldg(pool + clamp_index(row.ptr + mid, pool_n)) < tt) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  return l < row.len && __ldg(pool + clamp_index(row.ptr + l, pool_n)) == tt;
}

// A probe source tells the probe body, for the thread it runs in: which
// output it owns (item, -1 for none), whether that output can hit at all
// (live), how many probes decide it (count), and each probe's row and target
// (probe, false for a probe that misses without a search).  stage() runs
// first, in every thread of the block.
struct GivenProbes {
  GivenRows rows;
  const int* targets;
  long long n;
  __device__ void stage(int*) const {}
  __device__ long long item() const {
    const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
    return i < n ? i : -1;
  }
  __device__ bool live(long long) const { return true; }
  __device__ int count(long long) const { return 1; }
  __device__ bool probe(long long i, int, const int*, PoolRow& row, int& target) const {
    row = rows(i);
    target = targets[i];
    return true;
  }
};

struct WindowProbes {
  const int* cand_vals;
  const unsigned char* cand_valid;
  long long n_cand;  // candidates a query (C)
  unsigned int blocks_per_query;
  const int* query_terms;
  long long qt_stride;
  int width;  // W
  const int* query_lens;
  const int* c_offsets;
  long long n_offsets;
  const int* anchors;
  const int* c_ptr;
  const int* c_len;
  long long n_entries;
  bool phrase;

  __device__ long long query() const { return blockIdx.x / blocks_per_query; }  // 32-bit
  // the query's term slices [lo, hi) into slices[2 t], slices[2 t + 1]
  __device__ void stage(int* slices) const {
    const long long b = query();
    for (int t = threadIdx.x; t < width; t += blockDim.x) {
      const long long id = __ldg(query_terms + b * qt_stride + t);
      slices[2 * t] = __ldg(c_offsets + clamp_index(id, n_offsets));
      slices[2 * t + 1] = __ldg(c_offsets + clamp_index(id + 1, n_offsets));
    }
    __syncthreads();
  }
  __device__ long long item() const {
    const long long c =
        (blockIdx.x - query() * blocks_per_query) * static_cast<long long>(blockDim.x) +
        threadIdx.x;
    return c < n_cand ? query() * n_cand + c : -1;
  }
  __device__ bool live(long long i) const { return cand_valid[i] != 0; }
  __device__ int count(long long) const { return min(__ldg(query_lens + query()), width) - 1; }
  __device__ bool probe(long long i, int k, const int* slices, PoolRow& row, int& target) const {
    const int t = k + 1;
    const int cand = cand_vals[i];
    if (phrase) {
      if (cand > INT_MAX - 1 - t) return false;  // the shifted target would wrap
      target = cand + t;
    } else {
      target = cand;
    }
    const int lo = slices[2 * t];
    const int hi = slices[2 * t + 1];
    if (lo >= hi || n_entries <= 0) return false;
    int l = lo;
    int h = hi;
    while (l < h) {
      const int mid = l + ((h - l) >> 1);
      if (__ldg(anchors + clamp_index(mid, n_entries)) < target) {
        l = mid + 1;
      } else {
        h = mid;
      }
    }
    const long long j = clamp_index(max(l - 1, lo), n_entries);
    row = {__ldg(c_ptr + j), __ldg(anchors + j), __ldg(c_len + j)};
    return true;
  }
};

template <class Probes>
__global__ void probe_kernel(const int* __restrict__ pool, long long pool_n, Probes probes,
                             unsigned char* __restrict__ hit) {
  extern __shared__ int staged[];
  probes.stage(staged);
  const long long i = probes.item();
  if (i < 0) return;
  bool all = probes.live(i);
  const int n = probes.count(i);
  for (int k = 0; all && k < n; ++k) {
    PoolRow row;
    int target;
    all = probes.probe(i, k, staged, row, target) && row_holds(pool, pool_n, row, target);
  }
  hit[i] = all ? 1 : 0;
}

// ---------------------------------------------------------------- launches
template <class Rows>
static int launch_decode(const int* pool, long long pool_n, Rows rows, int* values,
                         unsigned char* valid, long long n_rows, int L, cudaStream_t stream) {
  const int per_block = decode_rows_per_block(L);
  const long long blocks = (n_rows + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidConfiguration);
  decode_kernel<<<static_cast<unsigned int>(blocks), kThreads, per_block * sizeof(PoolRow),
                  stream>>>(pool, pool_n, rows, values, valid, n_rows, L, per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_rows_launch(const int* pool, long long pool_n, const int* ptr,
                                  const int* base, const int* lens, int* values,
                                  unsigned char* valid, long long rows, int L,
                                  cudaStream_t stream) {
  if (rows <= 0 || L <= 0) return 0;
  return launch_decode(pool, pool_n, GivenRows{ptr, base, lens}, values, valid, rows, L,
                       stream);
}

extern "C" int probe_rows_launch(const int* pool, long long pool_n, const int* ptr,
                                 const int* base, const int* lens, const int* targets,
                                 unsigned char* hit, long long rows, cudaStream_t stream) {
  if (rows <= 0) return 0;
  probe_kernel<<<blocks_for(rows), kThreads, 0, stream>>>(
      pool, pool_n, GivenProbes{GivenRows{ptr, base, lens}, targets, rows}, hit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_window_launch(const int* pool, long long pool_n, const int* c_offsets,
                                    long long n_offsets, const int* anchors, const int* c_ptr,
                                    const int* c_len, long long n_entries, const int* list_ids,
                                    long long ids_stride, long long row_start, int window_rows,
                                    int* values, unsigned char* valid, long long queries, int L,
                                    cudaStream_t stream) {
  if (queries <= 0 || window_rows <= 0 || L <= 0 || n_entries <= 0 || n_offsets <= 0) return 0;
  const WindowRows rows{c_offsets, n_offsets, anchors, c_ptr, c_len, n_entries,
                        list_ids, ids_stride, row_start, window_rows};
  return launch_decode(pool, pool_n, rows, values, valid, queries * window_rows, L, stream);
}

extern "C" int probe_window_launch(const int* cand_vals, const unsigned char* cand_valid,
                                   long long n_cand, const int* query_terms, long long qt_stride,
                                   int width, const int* query_lens, const int* c_offsets,
                                   long long n_offsets, const int* anchors, const int* c_ptr,
                                   const int* c_len, long long n_entries, const int* pool,
                                   long long pool_n, int phrase, unsigned char* hit,
                                   long long queries, cudaStream_t stream) {
  if (queries <= 0 || n_cand <= 0) return 0;
  const long long per_query = (n_cand + kThreads - 1) / kThreads;
  if (queries * per_query > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidConfiguration);
  const WindowProbes probes{cand_vals, cand_valid, n_cand,
                            static_cast<unsigned int>(per_query), query_terms, qt_stride,
                            width, query_lens, c_offsets, n_offsets, anchors, c_ptr, c_len,
                            n_entries, phrase != 0};
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(width);
  probe_kernel<<<static_cast<unsigned int>(queries * per_query), kThreads, smem, stream>>>(
      pool, pool_n, probes, hit);
  return static_cast<int>(cudaGetLastError());
}

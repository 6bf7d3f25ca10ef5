// Anchor probes: anchor_probe_sliced (per-query lower bound inside a list's
// anchor slice), dense_probe_window (the dense serving step's whole probe
// loop of a window in one launch) and anchor_probe (searchsorted-right over
// the whole sorted array, the public op of repro_torch.kernels).
//
// anchor_probe_sliced replaces the TPU kernel `_probe_slice_kernel` /
// `anchor_probe_sliced_2d` of src/repro/kernels/anchor_intersect/kernel.py.
// Contract (the only thing carried over):
//
//     out[i] = lo[i] + #{ j in [lo[i], hi[i]) : anchors[j] < q[i] }
//
// i.e. the first position of the slice whose anchor is >= q[i], hi[i] when
// there is none, lo[i] for an empty slice.
//
// The TPU form compares every query with every anchor block of the whole
// index, O(NQ * NA), because a vector unit has no cheap per-lane gather.
// A GPU thread gathers for free, and anchors inside one list's slice are
// strictly increasing (prefix sums of phrase sums >= 1), so one thread per
// query runs a bounded binary search over the slice: O(NQ * log slice),
// at most 31 steps.  No sentinel padding of `anchors` is needed and the
// anchor array is read in place, never copied per call.
//
// Bound on this card: bytes.  Per query the kernel must move 12 B in and
// 4 B out; the anchor array (a few hundred KB to a few MB on the serving
// path) is read once from device memory and then lives in the 50 MB L2,
// where the ~log2(slice) dependent loads of each thread hit.  The design
// keeps the streamed traffic at the 16 B/query minimum and coalesced
// (thread i owns query i); the dependent L2 loads are latency, hidden by
// having every query in flight at once (NQ threads, 256 per block).
// A (G + 1)-ary search (G pivots loaded at once a round, by one thread or by
// a group of G lanes) shortens that chain but was no faster on the serving
// path's recorded windows on an H100, so the bisection is the one route.
//
// No serving step launches it any more: the fused step runs the same search
// inside fused_decode.cu's probe_window, the dense step inside
// dense_probe_window below.  It stays the public counterpart of the
// reference's op.
#include "common.cuh"

#include <climits>

__global__ void anchor_probe_sliced_kernel(const int* __restrict__ q,
                                           const int* __restrict__ lo,
                                           const int* __restrict__ hi,
                                           const int* __restrict__ anchors,
                                           int* __restrict__ out, long long nq) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= nq) return;
  const int t = q[i];
  int l = lo[i];
  int h = hi[i];
  while (l < h) {
    const int mid = l + ((h - l) >> 1);
    if (__ldg(anchors + mid) < t) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  out[i] = l;
}

extern "C" int anchor_probe_sliced_launch(const int* q, const int* lo, const int* hi,
                                          const int* anchors, int* out, long long nq,
                                          cudaStream_t stream) {
  if (nq <= 0) return 0;
  anchor_probe_sliced_kernel<<<blocks_for(nq), kThreads, 0, stream>>>(q, lo, hi, anchors,
                                                                     out, nq);
  return static_cast<int>(cudaGetLastError());
}

// dense_probe_window: the dense layout's probe loop of one serving window.
//
// Replaces, on the dense serving path, `anchor_probe_sliced_2d` of
// src/repro/kernels/anchor_intersect/kernel.py with the row compare around
// it (`member_batch_tpu` of src/repro/kernels/anchor_intersect/ops.py,
// called once per probed term by src/repro/serving/engine.py
// `_probe_terms`).  Contract: for each (query b, candidate c) whose
// cand_valid is set, walk the terms t = 1 .. min(len_b, W) - 1 and stop at
// the first miss, where
//
//     target  = cand (AND) or cand + t (phrase; a candidate above
//               2^31 - 2 - t misses, so the target never wraps)
//     [lo,hi) = the term's anchor slice; an empty slice misses
//     j       = max(l - 1, lo), l the lower bound of target in anchors[lo:hi]
//     hit     = some valid lane of expand[j] equals target
//
// and hit[b, c] is 1 when every probe hit.  Every read is clamped as the
// plain version clamps it: list ids to the offsets table, entries to
// [0, n_entries), the bisection's midpoint likewise.
//
// The per-term route made one launch per probed term plus ~25 torch ops
// around each (the (probes, expand_len) row gather among them); at the
// serving shapes those launches and ops, not the searches, were the time.
// Here the whole loop is one launch a window, shaped like fused_decode.cu's
// probe_window: one thread a (query, candidate), a block kThreads
// candidates of one query, whose term slices it stages in shared memory
// first (each (query, term) slice read once a block); an invalid candidate
// exits at once.
//
// The row compare no longer reads the whole row.  Precondition (holds for
// every dense table the port builds: AnchoredIndex.from_store writes each
// row's valid lanes as a prefix, and their values are the entry's anchor
// plus a prefix sum of d-gaps >= 1, so strictly increasing; padding rows
// and lanes are invalid): the valid lanes of a row are a prefix and their
// values strictly increase as signed int32.  Then "valid and < target" is
// true on a prefix of the row's lanes, and one bisection over that
// predicate (two independent loads a step: the flag and the value) finds
// the only lane that can equal the target: ceil(log2(expand_len)) + 1
// steps instead of expand_len lanes (2,048 on the serving path).
//
// Bound on this card: bytes.  It must read each candidate's value and flag
// and write its hit (6 B a candidate), plus the anchor and row words the
// probes reach; the anchors and rows live in L2 after their first read.
static __device__ __forceinline__ long long clamp_entry(long long x, long long n) {
  return x < 0 ? 0 : (x >= n ? n - 1 : x);
}

static __device__ __forceinline__ bool dense_row_holds(const int* __restrict__ row,
                                                       const unsigned char* __restrict__ live,
                                                       int lanes, int target) {
  int l = 0;
  int h = lanes;
  while (l < h) {
    const int mid = l + ((h - l) >> 1);
    const bool below = (__ldg(live + mid) != 0) & (__ldg(row + mid) < target);
    if (below) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  return l < lanes && __ldg(live + l) != 0 && __ldg(row + l) == target;
}

__global__ void dense_probe_window_kernel(
    const int* __restrict__ cand_vals, const unsigned char* __restrict__ cand_valid,
    long long n_cand, unsigned int blocks_per_query, const int* __restrict__ query_terms,
    long long qt_stride, int width, const int* __restrict__ query_lens,
    const int* __restrict__ c_offsets, long long n_offsets, const int* __restrict__ anchors,
    long long n_entries, const int* __restrict__ expand,
    const unsigned char* __restrict__ expand_valid, int expand_len, bool phrase,
    unsigned char* __restrict__ hit) {
  extern __shared__ int slices[];  // [lo, hi) of term t at slices[2 t], slices[2 t + 1]
  const long long b = blockIdx.x / blocks_per_query;
  for (int t = threadIdx.x; t < width; t += blockDim.x) {
    const long long id = __ldg(query_terms + b * qt_stride + t);
    slices[2 * t] = __ldg(c_offsets + clamp_entry(id, n_offsets));
    slices[2 * t + 1] = __ldg(c_offsets + clamp_entry(id + 1, n_offsets));
  }
  __syncthreads();
  const long long c =
      (blockIdx.x - b * blocks_per_query) * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (c >= n_cand) return;
  const long long i = b * n_cand + c;
  bool all = cand_valid[i] != 0;
  const int cand = cand_vals[i];
  const int n = min(__ldg(query_lens + b), width) - 1;
  for (int t = 1; all && t <= n; ++t) {
    if (phrase && cand > INT_MAX - 1 - t) {  // the shifted target would wrap
      all = false;
      break;
    }
    const int target = phrase ? cand + t : cand;
    const int lo = slices[2 * t];
    const int hi = slices[2 * t + 1];
    if (lo >= hi || n_entries <= 0) {
      all = false;
      break;
    }
    int l = lo;
    int h = hi;
    while (l < h) {
      const int mid = l + ((h - l) >> 1);
      if (__ldg(anchors + clamp_entry(mid, n_entries)) < target) {
        l = mid + 1;
      } else {
        h = mid;
      }
    }
    const long long j = clamp_entry(max(l - 1, lo), n_entries);
    all = dense_row_holds(expand + j * expand_len, expand_valid + j * expand_len, expand_len,
                          target);
  }
  hit[i] = all ? 1 : 0;
}

extern "C" int dense_probe_window_launch(
    const int* cand_vals, const unsigned char* cand_valid, long long n_cand,
    const int* query_terms, long long qt_stride, int width, const int* query_lens,
    const int* c_offsets, long long n_offsets, const int* anchors, long long n_entries,
    const int* expand, const unsigned char* expand_valid, int expand_len, int phrase,
    unsigned char* hit, long long queries, cudaStream_t stream) {
  if (queries <= 0 || n_cand <= 0) return 0;
  if (n_offsets <= 0 || width < 0 || expand_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_query = (n_cand + kThreads - 1) / kThreads;
  if (queries * per_query > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(width);
  dense_probe_window_kernel<<<static_cast<unsigned int>(queries * per_query), kThreads, smem,
                              stream>>>(
      cand_vals, cand_valid, n_cand, static_cast<unsigned int>(per_query), query_terms,
      qt_stride, width, query_lens, c_offsets, n_offsets, anchors, n_entries, expand,
      expand_valid, expand_len, phrase != 0, hit);
  return static_cast<int>(cudaGetLastError());
}

// anchor_probe: searchsorted-right over the whole sorted anchor array.
//
// Replaces the TPU kernel `_probe_kernel` / `anchor_probe_2d` of
// src/repro/kernels/anchor_intersect/kernel.py.  Contract (the only thing
// carried over):
//
//     idx[i]   = #{ j : anchors[j] <= q[i] }
//     found[i] = 1 if some anchors[j] == q[i], else 0
//
// for anchors sorted non-decreasingly (duplicates allowed: idx counts each);
// queries in any order.  The TPU form pads the anchors to its 2048-wide
// tiles with 2^31-1 and compares every query with every tile, O(NQ * NA),
// summing the `<=` lanes.  Both routes here search, so they need the
// anchors sorted (the Pallas sum happens to count unsorted ones too); the
// wrapper states that contract and the kernels do not check it.
//
// Bound on this card: bytes (4 B in and 8 B out a query, the anchors read
// once), but what holds a search back is its chain of dependent loads:
// about log2(NA) of them a query (18 at the path's NA), the top levels L1
// hits shared by every thread, the lower ones L2 round trips.  The card
// holds 2,048 threads an SM, so at the path's 339,712 queries one query a
// thread makes two waves of chains, the second a third full.  Two routes,
// picked by the wrapper from NA:
//
//   * lift — two queries a thread, interleaved: K = #{ j : anchors[j] <= q }
//     by binary lifting (K grows by s = top, top / 2, ..., 1 where
//     anchors[K + s - 1] <= q; top the largest power of two <= NA), a fixed
//     number of steps with no branch on the data, so the two chains' loads
//     issue together and the path's queries fit in one wave.  found comes
//     from the last anchor the lifting read, which is anchors[K - 1].
//     Taken for NA up to LIFT_MAX_ANCHORS (ops.py), where the array sits
//     in L2.
//   * bisect — one query a thread bisects [0, NA) for the first anchor > q;
//     found is `idx > 0 && anchors[idx - 1] == q`.  Taken past that, where
//     L2 misses, not the waves, set the time.
//
// A first version of the other route staged every 16th anchor in shared
// memory and read a 16-anchor segment in one round trip; it took 1.9x the
// bisection's time at the path (the strided staging, one 32-byte sector an
// anchor, repeated in every block) and was replaced by lift.
constexpr int kLiftQueries = 2;  // queries a thread of the lift route

__global__ void anchor_probe_kernel(const int* __restrict__ q,
                                    const int* __restrict__ anchors,
                                    int* __restrict__ idx, int* __restrict__ found,
                                    long long nq, long long na) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= nq) return;
  const int t = q[i];
  long long l = 0;
  long long h = na;
  while (l < h) {
    const long long mid = l + ((h - l) >> 1);
    if (__ldg(anchors + mid) <= t) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  idx[i] = static_cast<int>(l);
  found[i] = (l > 0 && __ldg(anchors + l - 1) == t) ? 1 : 0;
}

__global__ void anchor_probe_lift_kernel(const int* __restrict__ q,
                                         const int* __restrict__ anchors,
                                         int* __restrict__ idx, int* __restrict__ found,
                                         long long nq, long long na, long long top) {
  const long long base =
      blockIdx.x * static_cast<long long>(blockDim.x) * kLiftQueries + threadIdx.x;
  int t[kLiftQueries];
  long long K[kLiftQueries];
  int last[kLiftQueries];  // the anchor at K - 1, once K > 0
#pragma unroll
  for (int r = 0; r < kLiftQueries; ++r) {
    const long long i = base + static_cast<long long>(r) * blockDim.x;
    t[r] = i < nq ? q[i] : INT_MIN;
    K[r] = 0;
    last[r] = 0;
  }
  for (long long s = top; s > 0; s >>= 1) {
#pragma unroll
    for (int r = 0; r < kLiftQueries; ++r) {
      const long long k = K[r] + s;
      if (k <= na) {
        const int v = __ldg(anchors + k - 1);
        if (v <= t[r]) {
          K[r] = k;
          last[r] = v;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kLiftQueries; ++r) {
    const long long i = base + static_cast<long long>(r) * blockDim.x;
    if (i < nq) {
      idx[i] = static_cast<int>(K[r]);
      found[i] = (K[r] > 0 && last[r] == t[r]) ? 1 : 0;
    }
  }
}

// route: 0 bisect, 1 lift (ROUTE_CODES in ops.py)
extern "C" int anchor_probe_launch(const int* q, const int* anchors, int* idx, int* found,
                                   long long nq, long long na, int route,
                                   cudaStream_t stream) {
  if (nq <= 0) return 0;
  if (na < 0 || na > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {
    anchor_probe_kernel<<<blocks_for(nq), kThreads, 0, stream>>>(q, anchors, idx, found, nq,
                                                                na);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  long long top = na > 0 ? 1 : 0;
  while (top > 0 && 2 * top <= na) top *= 2;
  const long long per_block = static_cast<long long>(kThreads) * kLiftQueries;
  const long long blocks = (nq + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidConfiguration);
  anchor_probe_lift_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      q, anchors, idx, found, nq, na, top);
  return static_cast<int>(cudaGetLastError());
}

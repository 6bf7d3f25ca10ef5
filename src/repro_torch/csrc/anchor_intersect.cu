// Two anchor probes: anchor_probe_sliced (per-query lower bound inside a
// list's anchor slice, the serving path's) and anchor_probe (searchsorted-right
// over the whole sorted array, the public op of repro_torch.kernels).
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
#include "common.cuh"

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

// anchor_probe: searchsorted-right over the whole sorted anchor array.
//
// Replaces the TPU kernel `_probe_kernel` / `anchor_probe_2d` of
// src/repro/kernels/anchor_intersect/kernel.py.  Contract (the only thing
// carried over):
//
//     idx[i]   = #{ j : anchors[j] <= q[i] }
//     found[i] = 1 if some anchors[j] == q[i], else 0
//
// for anchors sorted non-decreasingly (duplicates allowed: idx counts each).
// The TPU form pads the anchors to its 2048-wide tiles with 2^31-1 and
// compares every query with every tile, O(NQ * NA), summing the `<=` lanes;
// here one thread per query bisects [0, NA) for the first anchor > q, which
// is idx, and found is `idx > 0 && anchors[idx - 1] == q`: O(NQ * log NA),
// no padding.  A bisection needs the anchors sorted (the Pallas sum happens
// to count unsorted ones too); the wrapper states that contract and the
// kernel does not check it.
//
// Bound on this card: bytes.  Per query 4 B in and 8 B out; the anchors are
// read once from device memory and the ~log2(NA) dependent loads of every
// later search hit the 50 MB L2.  Thread i owns query i, so the streamed
// traffic is coalesced, and all NQ searches are in flight at once to hide the
// dependent loads' latency.
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

extern "C" int anchor_probe_launch(const int* q, const int* anchors, int* idx, int* found,
                                   long long nq, long long na, cudaStream_t stream) {
  if (nq <= 0) return 0;
  if (na < 0 || na > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  anchor_probe_kernel<<<blocks_for(nq), kThreads, 0, stream>>>(q, anchors, idx, found, nq,
                                                              na);
  return static_cast<int>(cudaGetLastError());
}

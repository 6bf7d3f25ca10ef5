// anchor_probe_sliced: per-query lower bound inside a list's anchor slice.
//
// Replaces the TPU kernel `_probe_slice_kernel` / `anchor_probe_sliced_2d`
// of src/repro/kernels/anchor_intersect/kernel.py.  Contract (the only
// thing carried over):
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

// embedding_bag: sums of table rows over bags of consecutive indices.
//
// Replaces the TPU kernel `embedding_bag_call` of
// src/repro/kernels/embedding_bag/kernel.py:52 (with its op,
// src/repro/kernels/embedding_bag/ops.py:11).  Contract:
//
//   idx (n_bags * bag,) int32; table (V, D) float32 or bf16 whose rows lie
//   `row_stride` elements apart (the columns contiguous); out (n_bags, D)
//   float32, out[b, c] = sum over s < bag of table[idx[b * bag + s], c],
//   summed in float32 from 0 in the order s = 0, 1, ... (the plain version's
//   order, so the two agree bit for bit).  A row outside [0, V) is never
//   read: it makes its bag's sums NaN (jnp.take fills such rows with NaN).
//
// The Pallas kernel walks one lookup per grid step, fetching the addressed
// row by scalar prefetch into VMEM and accumulating into the bag's output
// row in place, with D padded to 128 lanes.  Here one thread owns one output
// element (bag, column) and loops over its bag: no padding (xDeepFM's D is
// 10, where padding to 128 would move 12.8x the bytes) and no cross-thread
// reduction.  Consecutive threads take consecutive columns of a row, so a
// row is read by neighbouring lanes; the bag's indices are read by the D
// threads of the bag and served from L1.
//
// Bound on this card: bytes — the indices once, the addressed rows once per
// lookup, the output once, over 3.35 TB/s; one add per element read.
#include "floats.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int* __restrict__ idx, const T* __restrict__ table,
                     float* __restrict__ out, long long n_out, int bag, int d, long long v,
                     long long row_stride) {
  const long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (e >= n_out) return;
  const long long b = e / d;
  const int c = static_cast<int>(e - b * d);
  const int* ib = idx + b * bag;
  float acc = 0.f;
  for (int s = 0; s < bag; ++s) {
    const long long r = ib[s];
    acc += (r >= 0 && r < v) ? to_f32(table[r * row_stride + c]) : __int_as_float(0x7fc00000);
  }
  out[e] = acc;
}

}  // namespace

// (idx, table, out, n_bags, bag, d, v, row_stride, dtype, stream)
extern "C" int embedding_bag_launch(const int* idx, const void* table, float* out,
                                    long long n_bags, int bag, int d, long long v,
                                    long long row_stride, int dtype, cudaStream_t stream) {
  const long long n_out = n_bags * d;
  if (n_out <= 0) return 0;
  if (bag < 0 || v < 0 || row_stride < 0 || (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks = blocks_for(n_out);
  if (dtype == kF32) {
    embedding_bag_kernel<float><<<blocks, kThreads, 0, stream>>>(
        idx, static_cast<const float*>(table), out, n_out, bag, d, v, row_stride);
  } else {
    embedding_bag_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        idx, static_cast<const __nv_bfloat16*>(table), out, n_out, bag, d, v, row_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

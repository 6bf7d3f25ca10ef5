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
// row in place, with D padded to 128 lanes.  No padding here (xDeepFM's D is
// 10, where padding to 128 would move 12.8x the bytes).
//
// Bound on this card: bytes — the indices once, the addressed rows once per
// lookup, the output once, over 3.35 TB/s; one add per element read.  A
// lookup is a random gather: a 40-byte row at a 40-byte-aligned offset spans
// two 32-byte sectors, so from device memory it moves 64 bytes (the design's
// ceiling counts sectors).  What the design does about it:
//
//   * a thread owns kItems (bag, vector) items of a block's tile of whole
//     bags, and issues every item's row load before it adds any, several
//     bag positions at a time where bags are longer than one (kUnroll), so
//     that many independent loads are in flight: memory-level parallelism
//     is what a random gather is made of.  Bags of one (every lookup of
//     the recsys models but the linear term and FM's field sum) have an
//     instance of their own, 8 items a thread and no position loop, with
//     fewer registers, so that more threads an SM keep rows in flight than
//     one instance for every bag length allowed;
//   * rows are read 16 bytes a load (`vec16`), 8 (`vec8`) or one element
//     (`scalar`), the route the wrapper picks from D, the element size, the
//     row stride and the table's alignment; the float32 output is stored
//     the same number of elements at a time, streaming (evict-first), so
//     that it does not push table rows out of L2;
//   * the tile's indices are copied once into shared memory, consecutive
//     threads on consecutive indices (for bags longer than kChunk, kChunk
//     positions of every bag a pass), then read from there by every item of
//     their bag; a bag's staged run is an odd number of words long, so the
//     threads of a warp, each on its own bag, hit distinct banks;
//   * item -> (bag, vector) is a 32-bit multiply-high by a precomputed
//     reciprocal, not a division.
//
// The sum's order is the contract: one thread adds a bag's rows, in index
// order, from a float32 zero.  No tree and no atomics.
#include "floats.cuh"

#include <climits>
#include <cstdint>

namespace {

constexpr int kChunk = 8;   // bag positions staged per pass when bags are longer

// n / d for 0 <= n < 2^31 by a multiply-high: PyTorch's IntDivider (Granlund
// and Montgomery, "Division by invariant integers using multiplication").
struct FastDiv {
  unsigned int mul;
  unsigned int shift;
};

FastDiv make_div(unsigned int d) {
  unsigned int s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long one = 1;
  return {static_cast<unsigned int>(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ int div_by(int n, FastDiv f) {
  return static_cast<int>((__umulhi(static_cast<unsigned int>(n), f.mul) + n) >> f.shift);
}

__device__ __forceinline__ float bf16_lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int w) { return __uint_as_float(w & 0xFFFF0000u); }

// V consecutive elements of a row, widened to float32 (exactly).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[V]) {
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(p);
    if constexpr (V == 1) {
      x[0] = __ldg(f);
    } else if constexpr (V == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(f));
      x[0] = v.x, x[1] = v.y;
    } else {
      static_assert(V == 4, "float32 rows are read 1, 2 or 4 elements a load");
      const float4 v = __ldg(reinterpret_cast<const float4*>(f));
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    }
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    if constexpr (V == 1) {
      x[0] = __uint_as_float(static_cast<unsigned int>(__ldg(h)) << 16);
    } else if constexpr (V == 4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(h));
      x[0] = bf16_lo(v.x), x[1] = bf16_hi(v.x), x[2] = bf16_lo(v.y), x[3] = bf16_hi(v.y);
    } else {
      static_assert(V == 8, "bf16 rows are read 1, 4 or 8 elements a load");
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(h));
      x[0] = bf16_lo(v.x), x[1] = bf16_hi(v.x), x[2] = bf16_lo(v.y), x[3] = bf16_hi(v.y);
      x[4] = bf16_lo(v.z), x[5] = bf16_hi(v.z), x[6] = bf16_lo(v.w), x[7] = bf16_hi(v.w);
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 1) {
    __stcs(p, x[0]);
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      __stcs(reinterpret_cast<float4*>(p + i), make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
    }
  }
}

// One block: `tile_bags` whole bags.  `units` = D / V vectors a row;
// `stride` = the staged words a bag: bag | 1 (bags of at most kChunk,
// staged whole) or kChunk + 1 (longer bags, kChunk positions a pass).  A
// thread holds kItems items and loads kUnroll bag positions of each before
// it adds (launch() picks the instance).
template <typename T, int V, int kItems, int kUnroll>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const int* __restrict__ idx, const T* __restrict__ table,
                     float* __restrict__ out, long long n_bags, int bag, int d, long long v,
                     long long row_stride, int units, int tile_bags, int stride,
                     FastDiv by_units, FastDiv by_bag) {
  extern __shared__ int staged[];
  const int tid = threadIdx.x;
  const long long bag0 = static_cast<long long>(blockIdx.x) * tile_bags;
  const int nb = static_cast<int>(n_bags - bag0 < tile_bags ? n_bags - bag0 : tile_bags);
  const int items = nb * units;
  const float nan = __int_as_float(0x7fc00000);

  for (int base = 0; base < items; base += kThreads * kItems) {
    float acc[kItems][V];
    int bl[kItems], col[kItems];
    bool on[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int li = base + tid + k * kThreads;
      on[k] = li < items;
      bl[k] = div_by(li, by_units);
      col[k] = (li - bl[k] * units) * V;
#pragma unroll
      for (int t = 0; t < V; ++t) acc[k][t] = 0.f;
    }
    for (int s0 = 0; s0 < bag; s0 += kChunk) {
      const int n_s = bag - s0 < kChunk ? bag - s0 : kChunk;
      __syncthreads();  // every thread is done with the previous pass's indices
      if (bag <= kChunk) {  // whole bags: one contiguous run of the index array
        const int* src = idx + bag0 * bag;
        for (int j = tid; j < nb * bag; j += kThreads) {
          const int b = div_by(j, by_bag);
          staged[b * stride + j - b * bag] = __ldg(src + j);
        }
      } else {
        for (int j = tid; j < nb * kChunk; j += kThreads) {
          const int b = j / kChunk, e = j % kChunk;
          if (e < n_s) staged[b * stride + e] = __ldg(idx + (bag0 + b) * bag + s0 + e);
        }
      }
      __syncthreads();
      for (int e0 = 0; e0 < n_s; e0 += kUnroll) {
        float x[kUnroll][kItems][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int k = 0; k < kItems; ++k) {
            if (e0 + u < n_s) {
              // an item past the tile reads nothing and adds NaN to a sum never stored
              const long long r = on[k] ? staged[bl[k] * stride + e0 + u] : -1;
              if (r >= 0 && r < v) {
                load_vec<T, V>(table + r * row_stride + col[k], x[u][k]);
              } else {
#pragma unroll
                for (int t = 0; t < V; ++t) x[u][k][t] = nan;
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (e0 + u < n_s) {
#pragma unroll
            for (int k = 0; k < kItems; ++k) {
#pragma unroll
              for (int t = 0; t < V; ++t) acc[k][t] += x[u][k][t];
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (on[k]) store_vec<V>(out + (bag0 + bl[k]) * d + col[k], acc[k]);
    }
  }
}

template <typename T, int V, int kItems, int kUnroll>
cudaError_t launch_items(const int* idx, const void* table, float* out, long long n_bags,
                         int bag, int d, long long v, long long row_stride, cudaStream_t stream) {
  const int units = d / V;
  const int tile_bags = units >= kThreads * kItems ? 1 : kThreads * kItems / units;
  const long long blocks = (n_bags + tile_bags - 1) / tile_bags;
  if (blocks > INT_MAX || static_cast<long long>(tile_bags) * units > INT_MAX) {
    return cudaErrorInvalidConfiguration;
  }
  const int stride = bag <= kChunk ? (bag | 1) : kChunk + 1;
  const size_t smem = static_cast<size_t>(tile_bags) * stride * sizeof(int);
  embedding_bag_kernel<T, V, kItems, kUnroll>
      <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      idx, static_cast<const T*>(table), out, n_bags, bag, d, v, row_stride, units, tile_bags,
      stride, make_div(static_cast<unsigned int>(units)),
      make_div(static_cast<unsigned int>(bag > 0 ? bag : 1)));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch(const int* idx, const void* table, float* out, long long n_bags, int bag,
                   int d, long long v, long long row_stride, cudaStream_t stream) {
  // bags of one: 8 rows in flight a thread, at most 16 floats of them; longer
  // bags: kUnroll positions of 4 items (2 for wide vectors), 32 floats or 16
  constexpr int kOne = V <= 2 ? 8 : 16 / V;
  constexpr int kLong = V <= 2 ? 4 : 2;
  constexpr int kUnroll = V >= kChunk ? 1 : kChunk / V;
  return bag <= 1 ? launch_items<T, V, kOne, 1>(idx, table, out, n_bags, bag, d, v, row_stride,
                                                stream)
                  : launch_items<T, V, kLong, kUnroll>(idx, table, out, n_bags, bag, d, v,
                                                       row_stride, stream);
}

}  // namespace

// (idx, table, out, n_bags, bag, d, v, row_stride, dtype, route, stream)
// route: 0 element loads, 1 8-byte loads, 2 16-byte loads; a vector route
// needs D, the row stride and the table's address to be whole vectors
// (else refused: the wrapper picks the route).
extern "C" int embedding_bag_launch(const int* idx, const void* table, float* out,
                                    long long n_bags, int bag, int d, long long v,
                                    long long row_stride, int dtype, int route,
                                    cudaStream_t stream) {
  if (n_bags <= 0 || d <= 0) return 0;
  if (bag < 0 || v < 0 || row_stride < 0 || (dtype != kF32 && dtype != kBF16) || route < 0 ||
      route > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int size = dtype == kF32 ? 4 : 2;
  const int width = route == 0 ? size : (route == 1 ? 8 : 16);
  if ((static_cast<long long>(d) * size) % width || (row_stride * size) % width ||
      reinterpret_cast<uintptr_t>(table) % width) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err;
  if (dtype == kF32) {
    err = route == 0 ? launch<float, 1>(idx, table, out, n_bags, bag, d, v, row_stride, stream)
        : route == 1 ? launch<float, 2>(idx, table, out, n_bags, bag, d, v, row_stride, stream)
                     : launch<float, 4>(idx, table, out, n_bags, bag, d, v, row_stride, stream);
  } else {
    using B = __nv_bfloat16;
    err = route == 0 ? launch<B, 1>(idx, table, out, n_bags, bag, d, v, row_stride, stream)
        : route == 1 ? launch<B, 4>(idx, table, out, n_bags, bag, d, v, row_stride, stream)
                     : launch<B, 8>(idx, table, out, n_bags, bag, d, v, row_stride, stream);
  }
  return static_cast<int>(err);
}

// Hopper tensor-core machinery shared by the bf16 routes of moe_gemm.cu and
// flash_attention.cu: shared-memory matrix descriptors, the warpgroup product
// wgmma.mma_async (bf16 x bf16 -> f32, m64nNk16, A from shared memory or from
// registers), an mbarrier ring that the Tensor Memory Accelerator (TMA)
// fills, and a host-side tensor-map encoder.
//
// Tiles.  Every tile here is a stack of 128-byte rows (64 bf16) as TMA writes
// it with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8), so eight rows (1,024 bytes, one swizzle atom) read by
// column hit all 32 banks.  A tile starts on a 1,024-byte boundary.  A
// K-major operand (K contiguous: buf's D, q's and k's hd) is 64 K-values a
// row, one row per M (or N) index; a slice of 16 K-values starts 32 bytes
// further into the atom.  An MN-major operand (N contiguous: w's F, v's hd)
// is 64 N-values a row, one row per K index; 64 more N-values are a second
// such block, `lbo` bytes further on.
//
// A warpgroup is four consecutive warps whose first is a multiple of four.
// Its m64nN accumulator gives thread (warp w, lane l) the elements
// d[j] = D[16 w + l / 4 + 8 ((j / 2) % 2)][8 (j / 4) + 2 (l % 4) + j % 2],
// and the A operand from registers is the same layout over 16 columns, as
// bf16 pairs: a[i] = (D-layout elements 2 i, 2 i + 1) of the 8-column chunks.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int kAtomBytes = 1024;  // eight 128-byte rows: one swizzle atom

// the descriptor's layout field (bits 62-63)
enum Swizzle : uint64_t { kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3 };

template <Swizzle S>
__host__ __device__ constexpr uint32_t swizzle_bytes() {
  return S == kSwizzle128 ? 128u : S == kSwizzle64 ? 64u : 32u;
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a shared-memory matrix descriptor: start address, leading and stride byte
// offsets (each in 16-byte units), swizzle mode; base offset 0, so a tile
// starts on a swizzle atom
static __device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                                     uint32_t sbo, Swizzle swizzle) {
  uint64_t d = (smem_u32(smem) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(swizzle) << 62;
  return d;
}

// K-major operand: rows of swizzle_bytes (one per M / N index), eight-row
// groups 8 * swizzle_bytes apart; the leading offset is unused
template <Swizzle S = kSwizzle128>
static __device__ __forceinline__ uint64_t kmajor_desc(const void* smem) {
  return make_desc(smem, 16, 8 * swizzle_bytes<S>(), S);
}

// MN-major operand: rows of swizzle_bytes (one per K index), eight-row K
// groups 8 * swizzle_bytes apart, blocks of swizzle_bytes / 2 MN-values
// `lbo` bytes apart (read with the transpose bit)
template <Swizzle S = kSwizzle128>
static __device__ __forceinline__ uint64_t mnmajor_desc(const void* smem, uint32_t lbo) {
  return make_desc(smem, lbo, 8 * swizzle_bytes<S>(), S);
}

// ---- warpgroup synchronisation ----
// before the first wgmma that reads registers or shared memory written since
static __device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void commit_group() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
static __device__ __forceinline__ void wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait that brackets it
template <int N>
static __device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// named barriers (ids 1-15; 0 is __syncthreads) over `n` threads: sync
// waits for all n, arrive counts in without waiting
static __device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
static __device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// move registers between warpgroups: a producer warpgroup gives some up
// (dec), the consumers take them (inc); every thread of a warpgroup runs it
// once, before the roles' paths part for good
template <int N>
static __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
static __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- the bf16 x bf16 -> f32 products ----
#define WG_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D (+)= A . B, m64n128k16, A and B in shared memory (descriptors); TRANS_B 1
// reads an MN-major B.  ``accumulate`` 0 overwrites D.
template <int TRANS_B>
static __device__ __forceinline__ void mma_ss_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D (+)= A . B, m64n128k16, A from registers (four bf16 pairs a thread, the
// layout of the accumulator's 16 columns), B in shared memory.
template <int TRANS_B>
static __device__ __forceinline__ void mma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

// D (+)= A . B, m64n64k16, A from registers (four bf16 pairs a thread, the
// layout of the accumulator's 16 columns), B in shared memory.
template <int TRANS_B>
static __device__ __forceinline__ void mma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

#undef WG_D8

// two floats as a bf16 pair, the first in the low half (round to nearest even)
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mbarriers and TMA ----
static __device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// after the inits, before any other thread uses the barriers
static __device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and expect `bytes` more of TMA traffic in this phase
static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// spin until the phase of the given parity has completed (no timeout: a
// clock64 check here made ptxas spill the attention kernel's registers and
// serialise its wgmmas)
static __device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a ring of STAGES buffers, each with a "full" barrier (TMA bytes landed)
// and an "empty" one (its readers are done).  The producer waits on empty
// with parity phase ^ 1, so its first round passes at once; the consumers
// wait on full with parity phase.
template <int STAGES>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

static __device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
static __device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1, int c2,
                                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// the first 1,024-byte boundary at or after p (dynamic shared memory is
// only 16-byte aligned; launches ask for kAtomBytes more)
static __device__ __forceinline__ unsigned char* align_atom(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAtomBytes - (a % kAtomBytes)) % kAtomBytes);
}

// ---- host: tensor maps ----
// cuTensorMapEncodeTiled looked up through the CUDA runtime, so the
// library links without -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline cudaError_t encode_tiled_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A bf16 tensor map of `rank` dimensions (innermost first, `dims[0]` with
// stride 1; `strides` in bytes for dims 1..rank-1, each a multiple of 16)
// whose box is `box`, 128-byte swizzled (box[0] * 2 <= 128), zeros outside
// the tensor.  The base must be 16-byte aligned.
static inline cudaError_t make_tensor_map(CUtensorMap* map, const void* base, int rank,
                                          const uint64_t* dims, const uint64_t* strides,
                                          const uint32_t* box) {
  EncodeTiledFn fn;
  const cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  cuuint64_t gdim[5];
  cuuint64_t gstride[4];
  cuuint32_t bdim[5];
  cuuint32_t estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), gdim, gstride, bdim, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg

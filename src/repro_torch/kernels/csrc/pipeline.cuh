// Shared-memory ring helpers for Hopper (sm_90a): TMA tile copies from
// global memory into shared memory that complete on an mbarrier.
//
// A tensor copy (cp.async.bulk.tensor) is executed by the SM's Tensor
// Memory Accelerator: one thread names a box of a 2-D tensor described by
// a CUtensorMap, and the box lands in shared memory without passing
// through registers; elements outside the tensor are written as zeros.
// On the H100 an SM streams faster this way, with one request per box,
// than with per-thread loads or one bulk copy per row (PERF.md).
// Completion is counted in bytes on an
// mbarrier: the producer arms it with the stage's byte count
// (arrive.expect_tx), the copies count it down, and consumers wait on the
// barrier's phase parity.  An issuing thread stalls while the TMA unit's
// queue is full, so the kernels issue from a producer warp of their own
// and consumers hand each slot back on a second ("empty") barrier: a
// stalled issue then never holds the consumers up.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcom {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// `p` rounded up to the next 1024-byte boundary of the shared window
// (what a 128-byte swizzled TMA box needs; allocate 1024 bytes more).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// mbarrier expecting `count` arrivals per phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// Make initialised barriers visible to the async proxy (the TMA unit);
// a __syncthreads() must follow before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` of bulk copies in the current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Named barrier 1 over the first `n` threads (the consumers), leaving
// the producer warp out.
__device__ __forceinline__ void sync_consumers(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Arrive once (no bytes expected).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Block until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` whose first element is (column x, row y) into shared
// `dst` (aligned as the map's swizzle needs), counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// The box of a 3-D / 4-D `map` at coordinates (c0 innermost, ...).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// Offset in elements of (row r, column c) in a run of [rows][128-byte]
// boxes written with CU_TENSOR_MAP_SWIZZLE_128B: box c / E holds columns
// [E * box, E * box + E), and in each row its 16-byte chunks are permuted
// by the row's low three bits, so eight consecutive rows of one chunk lie
// in eight different bank groups.
template <typename T>
__device__ __forceinline__ int swz(int r, int c, int rows) {
  constexpr int E = 128 / sizeof(T), V = 16 / sizeof(T);
  const int cc = c % E;
  return (c / E) * rows * E + r * E + (((cc / V) ^ (r & 7)) * V) + cc % V;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// Host: cuTensorMapEncodeTiled, looked up once (nullptr if it is missing).
inline EncodeTiled encode_tiled() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
    encode = (EncodeTiled)fn;
  }
  return encode;
}

// Host: a tiled map of the row-major [rows, cols] tensor at `base`
// (element size `elem`; cols * elem and base 16-byte aligned) with boxes
// of [box_rows, box_cols]; out-of-range elements read as zero.  Returns
// a CUresult (0 = success).
inline int make_map_2d(CUtensorMap* map, const void* base, int elem,
                       long rows, long cols, int box_rows, int box_cols,
                       bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return (int)encode(
      map,
      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Host: a tiled, unswizzled float32 map of `rank` (2..5) dimensions,
// innermost first: dims[i] elements, strides[i] bytes between
// consecutive indices of dimension i + 1 (multiples of 16), boxes of
// box[i] elements; out-of-range elements read as zero.  Returns a
// CUresult (0 = success).
inline int make_map_f32(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
                     const_cast<void*>(base), dims, strides, box, step,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace dcom

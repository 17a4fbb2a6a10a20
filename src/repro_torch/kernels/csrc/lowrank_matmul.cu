// Preserved-compute GEMM out[M, N] = Vt[M, H] @ W[H, N] (paper Eq. 6) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/lowrank_matmul.py:
//   lowrank_matmul (:59, body _lr_matmul_kernel :36)
//     Vt [k, H] @ W [H, N] -> float32 [k, N], the H reduction split f ways
// here with the batch of Vt flattened into M = B*k rows of one launch.
// Inputs are both bfloat16 (the main path) or both float32; accumulation
// is float32 and the output is written once, rounded to the inputs' type
// (what the einsum at src/repro/core/preserved.py:143 returns).
//
// What bounds it on the H100: bytes.  The left operand is skinny (M = 20
// on the main path), so every byte of W read from device memory meets
// only ~M multiply-adds: W is read once and the arithmetic intensity is
// about M FLOP/byte, far below the bf16 ridge (~295 FLOP/byte).  The floor
// is |W| / 3.35 TB/s (10 us for a 4096 x 4096 bf16 W).
//
// Design.  CTAs of 4 consumer warps and 1 producer warp over (N tile of
// 128 columns, H split, M chunk of up to 64 rows).  Each CTA streams its
// [H/f x 128] slice of W, with the matching [M chunk x 64] slices of Vt,
// through a ring of four shared-memory stages of 64 rows (three stages,
// ~57 KB in bf16, in flight while one is multiplied).  The producer warp
// fills each free slot with TMA box copies (tensor maps of W and Vt,
// 128-byte boxes) counted on the slot's "full" mbarrier, and the
// consumers release the slot on its "empty" mbarrier.  The boxes land
// 128-byte swizzled, so the fragment loads are free of bank conflicts,
// and the TMA writes zeros for rows past H or M and columns past N.
// * bf16: the products run on the tensor cores as the swapped product
//   out^T[N, M] = W^T Vt^T with mma.sync.m16n8k16 (bf16 in, float32
//   accumulate): W^T's fragments come from the stage by ldmatrix.trans,
//   Vt's by ldmatrix, so N fills the 16-row side and M pads only to a
//   multiple of 8 (20 -> 24).  Each warp owns 32 columns of the tile.
// * float32 stays exact (TF32 is off in the port): the products run on
//   the CUDA cores, one column of the tile per thread, all M rows in
//   registers.
// The H split f (at most 8) is chosen so the grid fills about one wave
// of SMs.  The f CTAs of a split form a thread-block cluster; each
// leaves its float32 partial tile in its own shared memory, and after a
// cluster barrier CTA r adds the r-th slice of the tile from the f
// partials through distributed shared memory in rank order 0 .. f-1,
// rounds once to the output type and writes it.  One launch, no global
// scratch, no atomics: reruns are bit-identical.  When a row of W or Vt
// is not a multiple of 16 bytes (or a pointer not 16-byte aligned) no
// tensor map can describe it, and every thread copies elements into the
// same swizzled layout instead.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;               // 4 consumer warps
constexpr int kTileN = 128;                 // columns of W per CTA
constexpr int kTileH = 64;                  // rows of W per ring stage
constexpr int kStages = 4;
constexpr int kMaxSplit = 8;                // portable cluster size
constexpr int kPitchP = kTileN + 4;         // partial tile row (floats)

__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);              // as torch's .to(bfloat16)
}

// Shared-memory layout of one ring stage, in elements of T: W's
// [kTileH][kTileN] tile as kTileN / E boxes of [kTileH][E], then Vt's
// [MT][kTileH] tile as kTileH / E boxes of [MT][E], E = 128 bytes of T,
// each box 128-byte swizzled (dcom::swz) and 1024-byte aligned.
template <typename T, int NB>
struct Layout {
  static constexpr int MT = 8 * NB;         // M rows per CTA
  static constexpr int E = 128 / sizeof(T);
  static constexpr int SW = kTileH * kTileN, SV = MT * kTileH;
  static constexpr int STAGE = SW + SV;
  static constexpr size_t RING = (size_t)kStages * STAGE * sizeof(T);
  static constexpr size_t PART = (size_t)MT * kPitchP * sizeof(float);
  static constexpr size_t SMEM = (RING > PART ? RING : PART) + 1024;
  static constexpr unsigned BYTES = STAGE * sizeof(T);  // one stage's copies
};

// -- bf16: tensor-core products --------------------------------------------

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1,
                                        const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float* c, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[(i * NB + jb) * 4 + c]: the warp's 32 columns as two 16-row tiles i
// of out^T, times NB 8-column tiles jb of M (the m16n8 accumulator).
template <int NB>
__device__ __forceinline__ void consume(const __nv_bfloat16* ws,
                                        const __nv_bfloat16* vs,
                                        float (&acc)[8 * NB]) {
  using L = Layout<__nv_bfloat16, NB>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < kTileH; kk += 16) {
    unsigned a[2][4], b[NB][2];
    const int ha = kk + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4_trans(a[i], ws + dcom::swz<__nv_bfloat16>(
                                   ha, warp * 32 + i * 16 +
                                           ((lane >> 3) & 1) * 8,
                                   kTileH));
    const int hb = kk + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int jb = 0; jb + 1 < NB; jb += 2) {
      unsigned r[4];
      ldsm_x4(r, vs + dcom::swz<__nv_bfloat16>(
                          jb * 8 + (lane & 7) + ((lane >> 4) << 3), hb,
                          L::MT));
      b[jb][0] = r[0], b[jb][1] = r[1], b[jb + 1][0] = r[2],
      b[jb + 1][1] = r[3];
    }
    if constexpr (NB % 2 == 1)
      ldsm_x2(b[NB - 1][0], b[NB - 1][1],
              vs + dcom::swz<__nv_bfloat16>((NB - 1) * 8 + (lane & 7), hb,
                                            L::MT));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jb = 0; jb < NB; ++jb)
        mma_bf16(&acc[(i * NB + jb) * 4], a[i], b[jb][0], b[jb][1]);
  }
}

// The accumulator into the partial tile part[m][n] (float32).
template <int NB>
__device__ __forceinline__ void stash(float* part, const float (&acc)[8 * NB],
                                      const __nv_bfloat16*) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const float* c = &acc[(i * NB + jb) * 4];
      const int n = warp * 32 + i * 16 + g, m = jb * 8 + 2 * t;
      part[m * kPitchP + n] = c[0];
      part[(m + 1) * kPitchP + n] = c[1];
      part[m * kPitchP + n + 8] = c[2];
      part[(m + 1) * kPitchP + n + 8] = c[3];
    }
}

// -- float32: CUDA-core products (exact float32, as the port pins TF32 off) -

// acc[m]: column threadIdx.x of the tile, output row m.
template <int NB>
__device__ __forceinline__ void consume(const float* ws, const float* vs,
                                        float (&acc)[8 * NB]) {
  using L = Layout<float, NB>;
  const int n = threadIdx.x;
#pragma unroll 2
  for (int h = 0; h < kTileH; h += 4) {
    const float w0 = ws[dcom::swz<float>(h, n, kTileH)];
    const float w1 = ws[dcom::swz<float>(h + 1, n, kTileH)];
    const float w2 = ws[dcom::swz<float>(h + 2, n, kTileH)];
    const float w3 = ws[dcom::swz<float>(h + 3, n, kTileH)];
#pragma unroll
    for (int m = 0; m < 8 * NB; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(
          vs + dcom::swz<float>(m, h, L::MT));
      acc[m] = fmaf(v.x, w0, acc[m]);
      acc[m] = fmaf(v.y, w1, acc[m]);
      acc[m] = fmaf(v.z, w2, acc[m]);
      acc[m] = fmaf(v.w, w3, acc[m]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void stash(float* part, const float (&acc)[8 * NB],
                                      const float*) {
#pragma unroll
  for (int m = 0; m < 8 * NB; ++m) part[m * kPitchP + threadIdx.x] = acc[m];
}

// -- the kernel -------------------------------------------------------------

// out[m0 : m0 + MT, n0 : n0 + kTileN] for M chunk blockIdx.z and N tile
// blockIdx.x; blockIdx.y is the H split [y * hs, y * hs + hs) and the
// CTA's rank in its cluster of gridDim.y CTAs.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads + 32)
    lrmm_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap vmap,
                const T* __restrict__ vt, const T* __restrict__ w,
                T* __restrict__ out, int M, int H, int N, int hs, int tma) {
  using L = Layout<T, NB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  T* ring = reinterpret_cast<T*>(dcom::align1024(smem_raw));
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.z * L::MT;
  const int h0 = blockIdx.y * hs, h1 = min(H, h0 + hs);
  const int nst = (h1 - h0 + kTileH - 1) / kTileH;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      dcom::mbar_init(&full[s], tma ? 1 : 32);
      dcom::mbar_init(&empty[s], kThreads / 32);
    }
    dcom::mbar_fence_init();
  }
  __syncthreads();

  float acc[8 * NB];
#pragma unroll
  for (int i = 0; i < 8 * NB; ++i) acc[i] = 0.f;
  if (threadIdx.x >= kThreads) {            // the producer warp
    // stage s into slot s % kStages: W rows [hb, hb + kTileH) x columns
    // [n0, n0 + kTileN) and Vt rows [m0, m0 + MT) x columns [hb, ...); a
    // stage never passes h1 except at H (hs is a multiple of kTileH)
    const int lane = threadIdx.x - kThreads;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % kStages;
      if (s >= kStages) dcom::mbar_wait(&empty[slot], (s / kStages - 1) & 1);
      T* ws = ring + slot * L::STAGE;
      T* vs = ws + L::SW;
      const int hb = h0 + s * kTileH;
      if (tma) {
        if (lane == 0) {
          dcom::mbar_expect(&full[slot], L::BYTES);
          for (int k = 0; k < kTileN / L::E; ++k)
            dcom::tma_load_2d(ws + k * kTileH * L::E, &wmap, n0 + k * L::E,
                              hb, &full[slot]);
          for (int k = 0; k < kTileH / L::E; ++k)
            dcom::tma_load_2d(vs + k * L::MT * L::E, &vmap, hb + k * L::E,
                              m0, &full[slot]);
        }
      } else {
        for (int i = lane; i < kTileH * kTileN; i += 32) {
          const int r = i / kTileN, q = i % kTileN;
          ws[dcom::swz<T>(r, q, kTileH)] =
              hb + r < h1 && n0 + q < N ? w[(size_t)(hb + r) * N + n0 + q]
                                        : T(0.f);
        }
        for (int i = lane; i < L::MT * kTileH; i += 32) {
          const int m = i / kTileH, q = i % kTileH;
          vs[dcom::swz<T>(m, q, L::MT)] =
              m0 + m < M && hb + q < h1 ? vt[(size_t)(m0 + m) * H + hb + q]
                                        : T(0.f);
        }
        dcom::mbar_arrive(&full[slot]);
      }
    }
  } else {                                  // the consumer warps
    for (int s = 0; s < nst; ++s) {
      const int slot = s % kStages;
      dcom::mbar_wait(&full[slot], (s / kStages) & 1);
      const T* ws = ring + slot * L::STAGE;
      consume<NB>(ws, ws + L::SW, acc);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) dcom::mbar_arrive(&empty[slot]);
    }
  }
  __syncthreads();                          // the ring is free
  float* part = reinterpret_cast<float*>(ring);
  if (threadIdx.x < kThreads) stash<NB>(part, acc, ring);

  // cluster combine: CTA r sums slice r of the tile over ranks 0 .. f-1
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                           // every partial is in place
  const int f = gridDim.y, rank = blockIdx.y;
  constexpr int Q = L::MT * kTileN / 4;     // float4s of the tile
  const int lo = rank * ((Q + f - 1) / f);
  const int hi = min(Q, lo + (Q + f - 1) / f);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int m = i / (kTileN / 4), n = (i % (kTileN / 4)) * 4;
    float4 p[kMaxSplit];                    // all ranks' loads in flight
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < f)
        p[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + m * kPitchP + n);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < f)
        sum.x += p[q].x, sum.y += p[q].y, sum.z += p[q].z, sum.w += p[q].w;
    if (m0 + m < M) {
      T* o = out + (size_t)(m0 + m) * N + n0 + n;
      const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + n + e < N) store(o + e, s4[e]);
    }
  }
  cluster.sync();                           // partials read before exit
}

struct Plan {
  int nb, mt, chunks, tiles, f, hs;
};

Plan plan(int M, int H, int N, int sms) {
  Plan p;
  const int nb = (M + 7) / 8;
  p.nb = nb > 4 ? 8 : nb;                   // instantiated: 1, 2, 3, 4, 8
  p.mt = 8 * p.nb;
  p.chunks = (M + p.mt - 1) / p.mt;
  p.tiles = (N + kTileN - 1) / kTileN;
  const long ctas = (long)p.chunks * p.tiles;
  const int stages = (H + kTileH - 1) / kTileH;
  int f = 1;                                // about one wave of CTAs
  while (f < kMaxSplit && ctas * f * 2 <= sms && f * 2 <= stages) f *= 2;
  const int per = (H + f - 1) / f;
  p.hs = (per + kTileH - 1) / kTileH * kTileH;
  p.f = (H + p.hs - 1) / p.hs;              // no empty split
  return p;
}

template <typename T, int NB>
int launch_nb(const Plan& p, const T* vt, const T* w, T* out, int M, int H,
              int N, int tma, cudaStream_t st) {
  using L = Layout<T, NB>;
  CUtensorMap wmap = {}, vmap = {};
  if (tma) {
    int e = dcom::make_map_2d(&wmap, w, sizeof(T), H, N, kTileH, L::E, true);
    if (e == 0)
      e = dcom::make_map_2d(&vmap, vt, sizeof(T), M, H, L::MT, L::E, true);
    if (e != 0) return e;
  }
  const cudaError_t e = cudaFuncSetAttribute(   // on the current device
      lrmm_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, p.f, p.chunks);
  cfg.blockDim = dim3(kThreads + 32);         // 4 consumer warps, 1 producer
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.f;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, lrmm_kernel<T, NB>, wmap, vmap, vt, w,
                                 out, M, H, N, p.hs, tma);
}

// out has the inputs' type T.
template <typename T>
int launch(const T* vt, const T* w, T* out, int M, int H, int N, int sms,
           void* stream) {
  const Plan p = plan(M, H, N, sms);
  constexpr int VEC = 16 / sizeof(T);
  const int tma = N % VEC == 0 && H % VEC == 0 &&
                  (uintptr_t)vt % 16 == 0 && (uintptr_t)w % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (p.nb) {
    case 1: err = launch_nb<T, 1>(p, vt, w, out, M, H, N, tma, st); break;
    case 2: err = launch_nb<T, 2>(p, vt, w, out, M, H, N, tma, st); break;
    case 3: err = launch_nb<T, 3>(p, vt, w, out, M, H, N, tma, st); break;
    case 4: err = launch_nb<T, 4>(p, vt, w, out, M, H, N, tma, st); break;
    default: err = launch_nb<T, 8>(p, vt, w, out, M, H, N, tma, st);
  }
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Return value: the cudaError_t of the launch, or the CUresult of a
// tensor map that could not be made (0 = success).  `out` has the
// inputs' type; sms: the card's SM count (sizes the H split).
int dcom_lrmm_f32(const float* vt, const float* w, float* out, int M, int H,
                  int N, int sms, void* stream) {
  return launch(vt, w, out, M, H, N, sms, stream);
}

int dcom_lrmm_bf16(const void* vt, const void* w, void* out, int M, int H,
                   int N, int sms, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(vt),
                static_cast<const __nv_bfloat16*>(w),
                static_cast<__nv_bfloat16*>(out), M, H, N, sms, stream);
}

}  // extern "C"

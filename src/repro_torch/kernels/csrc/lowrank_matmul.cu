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
// Design.  CTAs of 4 consumer warps and 1 producer warp over (block of
// N columns, H split, M chunk of up to 64 rows).  A block is nt tiles of
// 128 columns, walked one after another (nt = 1 unless the caller's
// n_block asks for more).  For each tile a CTA streams its [split x 128]
// slice of W, with the matching [M chunk x 64] slices of Vt,
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
// The H split.  With no operating point the plan picks f (at most 8) so
// the grid fills about one wave of SMs, over splits of whole 64-row
// stages.  A caller's expansion f cuts H into f splits in order, as the
// TPU kernel's grid (N / n_block, f) does: ceil(H / f) rows rounded up to
// 8 (a split's first column of Vt must start a 16-byte vector for its
// tensor map; the last splits may be short or empty).  The last stage of
// a split that is not a multiple of 64 rows also holds the next split's
// first rows, and the consumers zero those columns of Vt in the stage
// before they multiply it (the wrapper refuses splits shorter than one
// stage).  Combining the f float32 partials, in split order
// 0 .. f-1 from a zero sum, rounded once to the output type:
// * f <= 8: the f CTAs of a split form a thread-block cluster; each
//   leaves its partial tile in its own shared memory, and after a
//   cluster barrier CTA r adds the r-th slice of the tile from the f
//   partials through distributed shared memory.  No global scratch.
// * f > 8 (past the portable cluster): each CTA writes its partial tile
//   to float32 scratch and takes a ticket; the last CTA of the (tile, M
//   chunk) to arrive adds the f partials and resets the ticket.
// One launch, no atomics on the data: reruns are bit-identical.  When a
// row of W or Vt is not a multiple of 16 bytes (or a pointer not 16-byte
// aligned) no tensor map can describe it, and every thread copies
// elements into the same swizzled layout instead (masked to the split).
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
constexpr int kSplitAlign = 8;              // a caller's split: rows granule

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

// Order this thread's generic-proxy writes to shared memory before later
// TMA (async-proxy) writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// out[m0 : m0 + MT, n0 : n0 + kTileN] for M chunk blockIdx.z and the nt
// tiles of N block blockIdx.x; blockIdx.y is the H split [y * hs, y * hs +
// hs) (and, unless TICKET, the CTA's rank in its cluster of gridDim.y
// CTAs).  TICKET: part holds float32 [tiles][chunks][f][MT * kTileN]
// partials and tickets [tiles][chunks] zeroed counters.
template <typename T, int NB, bool TICKET>
__global__ void __launch_bounds__(kThreads + 32)
    lrmm_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap vmap,
                const T* __restrict__ vt, const T* __restrict__ w,
                T* __restrict__ out, int M, int H, int N, int hs, int nt,
                int tma, float* __restrict__ gpart,
                unsigned* __restrict__ tickets) {
  using L = Layout<T, NB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ bool last;
  T* ring = reinterpret_cast<T*>(dcom::align1024(smem_raw));
  const int m0 = blockIdx.z * L::MT;
  const int h0 = blockIdx.y * hs, h1 = min(H, h0 + hs);
  const int nst = max(0, (h1 - h0 + kTileH - 1) / kTileH);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      dcom::mbar_init(&full[s], tma ? 1 : 32);
      dcom::mbar_init(&empty[s], kThreads / 32);
    }
    dcom::mbar_fence_init();
  }
  __syncthreads();

  for (int t = 0; t < nt; ++t) {
    const int tile = blockIdx.x * nt + t, n0 = tile * kTileN;
    if (n0 >= N) break;                     // uniform over the cluster
    const int g0 = t * nst;                 // ring stages of earlier tiles
    float acc[8 * NB];
#pragma unroll
    for (int i = 0; i < 8 * NB; ++i) acc[i] = 0.f;
    if (threadIdx.x >= kThreads) {          // the producer warp
      // stage s into slot (g0 + s) % kStages: W rows [hb, hb + kTileH) x
      // columns [n0, n0 + kTileN) and Vt rows [m0, m0 + MT) x columns
      // [hb, ...); the last stage may pass h1 (the consumers mask it)
      const int lane = threadIdx.x - kThreads;
      for (int s = 0; s < nst; ++s) {
        const int g = g0 + s, slot = g % kStages;
        if (g >= kStages) dcom::mbar_wait(&empty[slot], (g / kStages - 1) & 1);
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
    } else {                                // the consumer warps
      for (int s = 0; s < nst; ++s) {
        const int g = g0 + s, slot = g % kStages;
        dcom::mbar_wait(&full[slot], (g / kStages) & 1);
        T* ws = ring + slot * L::STAGE;
        const int lim = h1 - (h0 + s * kTileH);   // columns of this split
        if (tma && lim < kTileH && h1 < H) {
          // the stage's columns past h1 are the next split's: zero them in
          // Vt (the TMA only zero-fills past H), then wait for each other
          T* vs = ws + L::SW;
          for (int i = threadIdx.x; i < L::MT * kTileH; i += kThreads) {
            const int m = i / kTileH, q = i % kTileH;
            if (q >= lim) vs[dcom::swz<T>(m, q, L::MT)] = T(0.f);
          }
          fence_proxy_async();
          dcom::sync_consumers(kThreads);
        }
        consume<NB>(ws, ws + L::SW, acc);
        __syncwarp();
        if ((threadIdx.x & 31) == 0) dcom::mbar_arrive(&empty[slot]);
      }
    }
    __syncthreads();                        // the ring is free
    float* part = reinterpret_cast<float*>(ring);
    if (threadIdx.x < kThreads) stash<NB>(part, acc, ring);
    const int f = gridDim.y, rank = blockIdx.y;
    constexpr int Q = L::MT * kTileN / 4;   // float4s of the tile
    if constexpr (!TICKET) {
      // cluster combine: CTA r sums slice r of the tile over ranks 0 .. f-1
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();                       // every partial is in place
      const int lo = rank * ((Q + f - 1) / f);
      const int hi = min(Q, lo + (Q + f - 1) / f);
      for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const int m = i / (kTileN / 4), n = (i % (kTileN / 4)) * 4;
        float4 p[kMaxSplit];                // all ranks' loads in flight
#pragma unroll
        for (int q = 0; q < kMaxSplit; ++q)
          if (q < f)
            p[q] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(part, q) + m * kPitchP + n);
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < kMaxSplit; ++q)
          if (q < f)
            sum.x += p[q].x, sum.y += p[q].y, sum.z += p[q].z,
                sum.w += p[q].w;
        if (m0 + m < M) {
          T* o = out + (size_t)(m0 + m) * N + n0 + n;
          const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n0 + n + e < N) store(o + e, s4[e]);
        }
      }
      if (t + 1 < nt) fence_proxy_async();  // the next tile's TMA
      cluster.sync();                       // partials read before reuse
    } else {
      // ticket combine: the partial tile to scratch; the last CTA of the
      // (tile, chunk) adds the f partials in split order
      const size_t tk_i = (size_t)tile * gridDim.z + blockIdx.z;
      float* base = gpart + tk_i * f * (L::MT * kTileN);
      __syncthreads();                      // the partial tile is stashed
      float4* mine = reinterpret_cast<float4*>(base +
                                               (size_t)rank * L::MT * kTileN);
      for (int i = threadIdx.x; i < Q; i += blockDim.x) {
        const int m = i / (kTileN / 4), n = (i % (kTileN / 4)) * 4;
        mine[i] = *reinterpret_cast<const float4*>(part + m * kPitchP + n);
      }
      __threadfence();                      // the partial visible device-wide
      __syncthreads();                      // before the ticket is taken
      if (threadIdx.x == 0) {
        unsigned* tk = tickets + tk_i;
        last = atomicAdd(tk, 1u) == (unsigned)(f - 1);
        if (last) *tk = 0u;                 // every split has arrived
      }
      __syncthreads();
      if (last) {
        const float4* all = reinterpret_cast<const float4*>(base);
        for (int i = threadIdx.x; i < Q; i += blockDim.x) {
          const int m = i / (kTileN / 4), n = (i % (kTileN / 4)) * 4;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int q0 = 0; q0 < f; q0 += kMaxSplit) {
            float4 p[kMaxSplit];            // eight splits' loads in flight
#pragma unroll
            for (int q = 0; q < kMaxSplit; ++q)
              if (q0 + q < f) p[q] = __ldcg(all + (size_t)(q0 + q) * Q + i);
#pragma unroll
            for (int q = 0; q < kMaxSplit; ++q)
              if (q0 + q < f)
                sum.x += p[q].x, sum.y += p[q].y, sum.z += p[q].z,
                    sum.w += p[q].w;
          }
          if (m0 + m < M) {
            T* o = out + (size_t)(m0 + m) * N + n0 + n;
            const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n0 + n + e < N) store(o + e, s4[e]);
          }
        }
      }
      if (t + 1 < nt) {
        fence_proxy_async();                // the next tile's TMA
        __syncthreads();
      }
    }
  }
}

struct Plan {
  int nb, mt, chunks, blocks, nt, f, hs;
};

// f = 0: the card's own split (about one wave of CTAs, splits of whole
// stages); else f splits of ceil(H / f) rows rounded up to kSplitAlign.  n_block = 0: one tile of
// kTileN columns per CTA; else n_block / kTileN tiles.
Plan plan(int M, int H, int N, int sms, int fk, int n_block) {
  Plan p;
  const int nb = (M + 7) / 8;
  p.nb = nb > 4 ? 8 : nb;                   // instantiated: 1, 2, 3, 4, 8
  p.mt = 8 * p.nb;
  p.chunks = (M + p.mt - 1) / p.mt;
  p.nt = n_block > 0 ? n_block / kTileN : 1;
  p.blocks = (N + kTileN * p.nt - 1) / (kTileN * p.nt);
  if (fk > 0) {
    p.f = fk;
    p.hs = ((H + fk - 1) / fk + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
    return p;
  }
  const long ctas = (long)p.chunks * p.blocks;
  const int stages = (H + kTileH - 1) / kTileH;
  int f = 1;                                // about one wave of CTAs
  while (f < kMaxSplit && ctas * f * 2 <= sms && f * 2 <= stages) f *= 2;
  const int per = (H + f - 1) / f;
  p.hs = (per + kTileH - 1) / kTileH * kTileH;
  p.f = (H + p.hs - 1) / p.hs;              // no empty split
  return p;
}

template <typename T, int NB, bool TICKET>
int launch_nb(const Plan& p, const T* vt, const T* w, T* out, int M, int H,
              int N, int tma, float* part, unsigned* tickets,
              cudaStream_t st) {
  using L = Layout<T, NB>;
  CUtensorMap wmap = {}, vmap = {};
  if (tma) {
    int e = dcom::make_map_2d(&wmap, w, sizeof(T), H, N, kTileH, L::E, true);
    if (e == 0)
      e = dcom::make_map_2d(&vmap, vt, sizeof(T), M, H, L::MT, L::E, true);
    if (e != 0) return e;
  }
  const cudaError_t e = cudaFuncSetAttribute(   // on the current device
      lrmm_kernel<T, NB, TICKET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks, p.f, p.chunks);
  cfg.blockDim = dim3(kThreads + 32);         // 4 consumer warps, 1 producer
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.f;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = TICKET ? 0 : 1;
  return (int)cudaLaunchKernelEx(&cfg, lrmm_kernel<T, NB, TICKET>, wmap, vmap,
                                 vt, w, out, M, H, N, p.hs, p.nt, tma, part,
                                 tickets);
}

template <typename T, bool TICKET>
int launch_t(const Plan& p, const T* vt, const T* w, T* out, int M, int H,
             int N, int tma, float* part, unsigned* tickets,
             cudaStream_t st) {
#define LRMM_ARGS p, vt, w, out, M, H, N, tma, part, tickets, st
  switch (p.nb) {
    case 1: return launch_nb<T, 1, TICKET>(LRMM_ARGS);
    case 2: return launch_nb<T, 2, TICKET>(LRMM_ARGS);
    case 3: return launch_nb<T, 3, TICKET>(LRMM_ARGS);
    case 4: return launch_nb<T, 4, TICKET>(LRMM_ARGS);
    default: return launch_nb<T, 8, TICKET>(LRMM_ARGS);
  }
#undef LRMM_ARGS
}

// out has the inputs' type T.  f, n_block: the operating point (0 = the
// card's plan); part and tickets: the scratch of f > kMaxSplit.
template <typename T>
int launch(const T* vt, const T* w, T* out, int M, int H, int N, int sms,
           int f, int n_block, float* part, unsigned* tickets,
           void* stream) {
  if (f < 0 || f > 65535 || n_block < 0 || n_block % kTileN != 0 ||
      (f > kMaxSplit && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, H, N, sms, f, n_block);
  constexpr int VEC = 16 / sizeof(T);
  const int tma = N % VEC == 0 && H % VEC == 0 &&
                  (uintptr_t)vt % 16 == 0 && (uintptr_t)w % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      p.f > kMaxSplit
          ? launch_t<T, true>(p, vt, w, out, M, H, N, tma, part, tickets, st)
          : launch_t<T, false>(p, vt, w, out, M, H, N, tma, part, tickets,
                               st);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch and ticket counters a launch at f splits takes (none
// unless f > 8: the cluster combines up to 8 splits).
size_t dcom_lrmm_scratch_floats(int M, int N, int f) {
  if (f <= kMaxSplit) return 0;
  const Plan p = plan(M, 1, N, 1, f, 0);
  return (size_t)p.blocks * p.chunks * f * p.mt * kTileN;
}
int dcom_lrmm_tickets(int M, int N) {
  const Plan p = plan(M, 1, N, 1, 1, 0);
  return p.blocks * p.chunks;
}

// Return value: the cudaError_t of the launch, or the CUresult of a
// tensor map that could not be made (0 = success).  `out` has the
// inputs' type; sms: the card's SM count (sizes the card's own H split);
// f, n_block: the operating point, 0 for the card's plan; part, tickets:
// dcom_lrmm_scratch_floats(M, N, f) floats and dcom_lrmm_tickets(M, N)
// zeroed counters when f > 8, else unused (null).
int dcom_lrmm_f32(const float* vt, const float* w, float* out, int M, int H,
                  int N, int sms, int f, int n_block, float* part,
                  unsigned* tickets, void* stream) {
  return launch(vt, w, out, M, H, N, sms, f, n_block, part, tickets, stream);
}

int dcom_lrmm_bf16(const void* vt, const void* w, void* out, int M, int H,
                   int N, int sms, int f, int n_block, float* part,
                   unsigned* tickets, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(vt),
                static_cast<const __nv_bfloat16*>(w),
                static_cast<__nv_bfloat16*>(out), M, H, N, sms, f, n_block,
                part, tickets, stream);
}

}  // extern "C"

// Fused Lanczos re-orthogonalization steps for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/lanczos_reorth.py:
//   reorth_right_batched (:218, body _reorth_right_batched_kernel :131)
//     z_b = CGS2(A_b^T u_b, V_b)   A [B,S,H], u [B,S], V [B,H,k] -> z [B,H]
//   reorth_left_batched  (:262, body _reorth_left_batched_kernel :175)
//     w_b = CGS2(A_b v_b, U_b)     A [B,S,H], v [B,H], U [B,S,k] -> w [B,S]
// both also returning the squared norm of the result [B].  float32 in and
// out, float32 accumulation.
//
// What bounds it on the H100: bytes.  Per batch element the step reads A
// once (S*H*4 bytes) and the basis Q once (N*k*4, N = H or S); it does ~2
// flops per byte, far below the ~20 flop/byte float32 ridge, so the floor
// is (A + Q + vectors) / 3.35 TB/s.
//
// Design.  As in the TPU kernel, the expansion factor f is the number of
// blocks along the output axis N: block j holds rows [j*blk, j*blk + blk)
// of N, blk = ceil(N / f) (the last block ragged, blocks past N empty).
// The TPU walks them in order and carries z and the Q^T z partials in
// VMEM scratch; here one batch element is a thread-block cluster of
// C = min(f, 16) CTAs on neighbouring SMs, CTA c owning blocks c, c + C,
// ..., and the grid is B clusters.  Each CTA
//   pass 0  streams its blocks of A once through a shared-memory ring of
//           32 KB stages that a producer warp fills with TMA box copies
//           (right: boxes of rows x the block's columns over all S rows,
//           in panels of at most kPanel columns; left: 128-byte swizzled
//           boxes of the block's rows along H), while 8 consumer warps sum
//           the landed stages against the input vector held in shared
//           memory, into its z rows (shared memory);
//   sweeps  A: p1 = Q^T z,  B: z -= Q p1 ; p2 = Q^T z,  C: z -= Q p2 ;
//           out = z, |z|^2, over its own rows, with its Q rows copied into
//           shared memory (cp.async, overlapping pass 0) when they fit
//           beside a ring of kMinQStages stages, so Q is read from device
//           memory once; else staged in chunks through the ring, free
//           after pass 0, once a sweep.
//           z -= Q p takes a row per thread (no shuffles), Q^T z a warp's
//           lanes along k; both are loops of a few instructions a row,
//           since at B = 32 every microsecond of them leaves the device
//           memory idle between waves of clusters.
// The k-float partials of p1 and p2 and the block's |z|^2 are combined
// across the cluster through distributed shared memory: every CTA writes
// each of its blocks' partials into every CTA's table (its norm into
// CTA 0's), one cluster barrier (arrive.release / wait.acquire) later
// each CTA adds the f entries in block order 0 .. f-1 itself (arrivals
// that publish nothing are relaxed, which is cheaper).  So reruns
// are bit-identical, and there is one launch, no global scratch and no
// ticket.  No CTA waits on one outside its cluster, so any B runs.
// When H is not a multiple of 4 floats or A is not 16-byte aligned no
// tensor map can describe A, and the producer warp copies its elements
// into the same ring layout instead (one device code path of two, not a
// fallback to the plain version).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // consumers: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int KPL = 8;                     // Q columns per lane: k <= 256
constexpr int kStageBytes = 32 * 1024;     // bytes of A per ring stage
constexpr int kMaxStages = 8;
constexpr int kMinStages = 2;              // the ring's least depth
constexpr int kMinQStages = 3;             // ... when Q also stays in smem
constexpr int kMaxCluster = 16;            // non-portable above 8
constexpr int kMaxF = 32;
constexpr int kPanel = 1024;               // right: block columns at a time
constexpr size_t kSmemLimit = 232448;      // dynamic + static, one H100 CTA
constexpr size_t kStatic = 1024;           // room kept for static shared

// Measurement build only (reorth_timeline.py at the repository's root
// compiles this file with -DDCOM_REORTH_TIMELINE): thread 0 of every CTA
// stamps %globaltimer at the launch's phase boundaries.  The library that
// kernels/build.py builds has no stamps.
#ifdef DCOM_REORTH_TIMELINE
constexpr int kStamps = 11, kStampCtas = 4096;
__device__ unsigned long long dcom_reorth_stamps[kStampCtas][kStamps];
__device__ __forceinline__ void stamp(int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  if (threadIdx.x == 0 && blockIdx.x < kStampCtas)
    dcom_reorth_stamps[blockIdx.x][i] = t;
}
#define DCOM_STAMP(i) stamp(i)
#else
#define DCOM_STAMP(i)
#endif

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int rup(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The launch's geometry, the same on the host and in the kernel.
struct Geo {
  int S, H, k, n, f, C, blk, mine;  // n: output length; mine: blocks a CTA
  int stages, stage, qsm, qp, tma;  // ring depth, elements a stage; Q
                                    // in smem, its row pitch
  int W, nbox, boxc, box, R, tpr, rg;  // right: panel, boxes [R][boxc]
  int br, ncg, cols, ncs;           // left: boxes [br][32], ncs per group
  int o_z, o_all1, o_all2, o_nall, o_red, o_p, o_q;  // floats after vec
  size_t smem;                      // dynamic bytes (0: does not fit)
};

Geo plan(bool right, int S, int H, int k, int f, int tma) {
  Geo g = {};
  g.S = S, g.H = H, g.k = k, g.f = f, g.tma = tma;
  g.n = right ? H : S;
  g.C = f < kMaxCluster ? f : kMaxCluster;
  g.blk = cdiv(g.n, f);
  g.mine = cdiv(f, g.C);
  g.qp = 4 * (cdiv(k, 4) | 1);              // 16-byte rows, an odd number
  int vec;
  if (right) {
    const int span = g.blk % 4 ? g.blk + 3 : g.blk;  // from x0, see below
    g.W = rup(span, 4) < kPanel ? rup(span, 4) : kPanel;
    g.nbox = cdiv(g.W, 256);
    g.boxc = rup(cdiv(g.W, g.nbox), 4);
    g.R = clampi(kStageBytes / (g.nbox * g.boxc * 4), 1, 256);
    g.box = rup(g.R * g.boxc, 32);         // 128-byte aligned boxes
    g.stage = rup(g.nbox * g.box, 256);    // 1024-byte aligned stages
    g.tpr = g.W / 4;                       // a float4 column each
    g.rg = kThreads / g.tpr;
    vec = S;
  } else {
    g.br = 8;
    while (g.br < 256 && g.br < g.blk) g.br <<= 1;
    g.ncg = kThreads / g.br;
    g.cols = g.ncg * 32;
    g.ncs = cdiv(H, g.cols);
    g.stage = kThreads * 32;               // 32 KB
    vec = g.ncs * g.cols;                  // v, zero-padded
  }
  g.o_z = rup(vec, 4);
  g.o_all1 = g.o_z + rup(g.mine * g.blk, 4);
  g.o_all2 = g.o_all1 + rup(f * k, 4);
  g.o_nall = g.o_all2 + rup(f * k, 4);
  g.o_red = g.o_nall + kMaxF;
  g.o_p = g.o_red + (kWarps * k > kThreads * 4 ? kWarps * k : kThreads * 4);
  g.o_q = g.o_p + rup(k, 4);
  const size_t fixed = 1024 + sizeof(float) * (size_t)g.o_q;
  const size_t qbytes = sizeof(float) * (size_t)g.mine * g.blk * g.qp;
  const size_t sb = sizeof(float) * (size_t)g.stage;
  const size_t room = kSmemLimit - kStatic;
  if (fixed + qbytes + kMinQStages * sb <= room) {
    g.qsm = 1;
    g.stages = (int)((room - fixed - qbytes) / sb);
  } else if (fixed + kMinStages * sb <= room) {
    g.qsm = 0;
    g.stages = (int)((room - fixed) / sb);
  } else {
    return g;                              // smem 0: does not fit
  }
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.smem = fixed + g.stages * sb + (g.qsm ? qbytes : 0);
  return g;
}

// Cluster barrier, split: arrive (release: this thread's writes before it,
// the remote ones included, are seen after the wait; relaxed: nothing to
// publish) then wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   dcom::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   dcom::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Output rows of block j (0 past N, and for j >= f).
__device__ __forceinline__ int block_rows(const Geo& g, int j) {
  return j < g.f ? clampi(g.n - j * g.blk, 0, g.blk) : 0;
}

// The consumers copy `rows` rows of Q (k floats each, from global `src`)
// into shared `dst` as rows of qp floats, zero from column k to the next
// multiple of 4, and commit the copies without waiting for them.
__device__ __forceinline__ void copy_q(const Geo& g,
                                       const float* __restrict__ src,
                                       float* dst, int rows) {
  const int k = g.k, k4 = k / 4, pad = (4 - k % 4) % 4;
  if (pad == 0 && ((uintptr_t)src & 15) == 0) {
    for (int e = threadIdx.x; e < rows * k4; e += kThreads) {
      const int r = e / k4, c = 4 * (e - r * k4);
      cp_async16(dst + r * g.qp + c, src + r * k + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * k; e += kThreads) {
      const int r = e / k;
      cp_async4(dst + r * g.qp + (e - r * k), src + e);
    }
    for (int e = threadIdx.x; e < rows * pad; e += kThreads) {
      const int r = e / pad;
      dst[r * g.qp + k + (e - r * pad)] = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Global Q rows of block j of element b.
__device__ __forceinline__ const float* q_rows(const Geo& g,
                                               const float* __restrict__ q,
                                               size_t b, int j) {
  return q + (b * g.n + (size_t)j * g.blk) * g.k;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One CGS2 sweep (0: A, 1: B, 2: C) over this CTA's blocks, by the
// consumers.  Returns, in thread c < k, block i's k-float partial of
// Q^T z (sweeps A and B) in part[i], or in thread 0 block i's |z|^2
// (sweep C).  Q rows are read from shared memory, rows of qp = 4 * odd
// floats: the CTA's own copy when it fits (qs), else chunks of `crow`
// rows staged through the ring, free after pass 0 (Q then comes from
// L2 or device memory once a sweep).  z_r -= Q_r . p (sweeps B and C)
// takes one row per thread, its k products in 16-byte loads of Q and p
// (eight rows' loads fill the 32 banks once): no shuffles.  Q^T z takes
// a warp's lanes along k and warp w's rows w, w + 8, ...; the warps'
// partials are added in warp order.
__device__ __forceinline__ void sweep(const Geo& g, int s, float* sm,
                                      float* ring,
                                      const float* __restrict__ q,
                                      float* __restrict__ out, size_t b,
                                      int rank, float (&part)[2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* zs = sm + g.o_z;
  float* red = sm + g.o_red;
  const float* p = sm + g.o_p;
  const int k = g.k, qp = g.qp;
  const int crow = g.qsm ? g.blk : g.stages * g.stage / qp;
  int col[KPL];                             // lanes past k read column
#pragma unroll                              // k - 1, and their sums are
  for (int e = 0; e < KPL; ++e)             // never stored: no branch or
    col[e] = min(lane + 32 * e, k - 1);     // select in the row loops
  const int ne = (k + 31) / 32, step = kWarps * qp;
  for (int i = 0; i < g.mine; ++i) {
    const int j = rank + i * g.C, rows = block_rows(g, j);
    float* zb = zs + i * g.blk;
    float sq = 0.f;
    float acc[KPL];
#pragma unroll
    for (int e = 0; e < KPL; ++e) acc[e] = 0.f;
    for (int r0 = 0; r0 < rows; r0 += crow) {
      const int nr = min(crow, rows - r0);
      const float* qb;
      if (g.qsm) {
        qb = sm + g.o_q + i * g.blk * qp;
      } else {                              // stage this chunk
        copy_q(g, q_rows(g, q, b, j) + (size_t)r0 * k, ring, nr);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        dcom::sync_consumers(kThreads);
        qb = ring - r0 * qp;                // row r of the block at r * qp
      }
      if (s > 0) {                          // z_r -= Q_r . p
        for (int r = r0 + tid; r < r0 + nr; r += kThreads) {
          const float4* q4 = reinterpret_cast<const float4*>(qb + r * qp);
          const float4* p4 = reinterpret_cast<const float4*>(p);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int c = 0; c < (k + 3) / 4; ++c) {
            const float4 x = q4[c], w = p4[c];
            d[0] = fmaf(x.x, w.x, d[0]);
            d[1] = fmaf(x.y, w.y, d[1]);
            d[2] = fmaf(x.z, w.z, d[2]);
            d[3] = fmaf(x.w, w.w, d[3]);
          }
          const float zr = zb[r] - ((d[0] + d[1]) + (d[2] + d[3]));
          if (s == 1) {
            zb[r] = zr;
          } else {
            out[b * g.n + (size_t)j * g.blk + r] = zr;
            sq = fmaf(zr, zr, sq);
          }
        }
      }
      if (s < 2) {                          // Q^T z over the chunk
        if (s == 1) dcom::sync_consumers(kThreads);
        const float* qr = qb + (r0 + warp) * qp;
        int r = r0 + warp;
        for (; r + 3 * kWarps < r0 + nr; r += 4 * kWarps, qr += 4 * step) {
          float z[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) z[x] = zb[r + x * kWarps];
#pragma unroll
          for (int e = 0; e < KPL; ++e) {
            if (e >= ne) break;
#pragma unroll
            for (int x = 0; x < 4; ++x)
              acc[e] = fmaf(qr[x * step + col[e]], z[x], acc[e]);
          }
        }
        for (; r < r0 + nr; r += kWarps, qr += step) {
          const float zr = zb[r];
#pragma unroll
          for (int e = 0; e < KPL; ++e) {
            if (e >= ne) break;
            acc[e] = fmaf(qr[col[e]], zr, acc[e]);
          }
        }
      }
      if (!g.qsm) dcom::sync_consumers(kThreads);  // the ring is reused
    }
    if (s < 2) {
#pragma unroll
      for (int e = 0; e < KPL; ++e) {
        const int c = lane + 32 * e;
        if (c < k) red[warp * k + c] = acc[e];
      }
    } else {
      sq = warp_sum(sq);
      if (lane == 0) red[warp] = sq;
    }
    dcom::sync_consumers(kThreads);
    if (s < 2 && tid < k) {
      float x = 0.f;
      for (int w = 0; w < kWarps; ++w) x += red[w * k + tid];
      part[i] = x;
    } else if (s == 2 && tid == 0) {
      float x = 0.f;
      for (int w = 0; w < kWarps; ++w) x += red[w];
      part[i] = x;
    }
    dcom::sync_consumers(kThreads);
  }
}

// Sweeps A, B and C with the cluster combines, by every thread of the CTA
// (the producer warp joins the cluster barriers only).  Barrier phase 0
// was arrived at the kernel's start: every CTA of the cluster has then
// started, so its shared memory may be written.
__device__ __forceinline__ void cgs2_cluster(const Geo& g, float* sm,
                                             float* ring,
                                             const float* __restrict__ q,
                                             float* __restrict__ out,
                                             float* __restrict__ nrm,
                                             size_t b, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const bool consumer = tid < kThreads;
  float* p = sm + g.o_p;
  float part[2] = {0.f, 0.f};
  DCOM_STAMP(1);                            // pass 0 done
  if (consumer) {                          // z rows (and Q rows) landed
    if (g.qsm) asm volatile("cp.async.wait_all;\n" ::: "memory");
    dcom::sync_consumers(kThreads);
  }
  DCOM_STAMP(2);                            // Q rows landed
  for (int s = 0; s < 3; ++s) {
    if (consumer) sweep(g, s, sm, ring, q, out, b, rank, part);
    DCOM_STAMP(3 + 3 * s);
    cluster_wait();                   // the previous phase's tables
    if (consumer && s < 2 && tid < g.k) {     // push p partials
      float* all = sm + (s == 0 ? g.o_all1 : g.o_all2);
      for (int i = 0; i < g.mine; ++i) {
        const int j = rank + i * g.C;
        if (j >= g.f) continue;
        for (int d = 0; d < g.C; ++d)
          *cluster.map_shared_rank(all + j * g.k + tid, d) = part[i];
      }
    } else if (consumer && s == 2 && tid == 0) {  // norms into CTA 0
      for (int i = 0; i < g.mine; ++i) {
        const int j = rank + i * g.C;
        if (j < g.f) *cluster.map_shared_rank(sm + g.o_nall + j, 0) = part[i];
      }
    }
    cluster_arrive();
    if (s < 2) {
      cluster_wait();                 // every CTA's partials have landed
      DCOM_STAMP(4 + 3 * s);
      cluster_arrive_relaxed();       // the next phase, waited on before
                                      // the next push (arrive and wait
                                      // alternate)
      if (consumer && tid < g.k) {    // p in block order 0 .. f-1
        const float* all = sm + (s == 0 ? g.o_all1 : g.o_all2);
        float x = 0.f;
#pragma unroll 8
        for (int j = 0; j < g.f; ++j) x += all[j * g.k + tid];
        p[tid] = x;
      } else if (consumer && tid < rup(g.k, 4)) {
        p[tid] = 0.f;                 // p's padding, read by 16-byte loads
      }
      if (consumer) dcom::sync_consumers(kThreads);
      DCOM_STAMP(5 + 3 * s);
    }
  }
  cluster_wait();
  DCOM_STAMP(10);
  if (rank == 0 && tid == 0) {
    const float* nall = sm + g.o_nall;
    float x = 0.f;
    for (int j = 0; j < g.f; ++j) x += nall[j];
    nrm[b] = x;
  }
}

// z_b = CGS2(A_b^T u_b, V_b).  Block j is columns [c0, c0 + blk) of A,
// c0 = j*blk, walked from x0 = c0 rounded down to 4 columns (a TMA box
// starts on 16 bytes) in panels of at most W columns; a ring stage is R
// rows of a panel as nbox boxes of [R][boxc] side by side.  Consumer
// (grp, tc) holds the float4 of columns 4tc .. 4tc+3 of the panel and
// sums rows grp, grp + rg, ... of each stage; the rg row groups' sums
// are added in order at the panel's end.
__global__ void __launch_bounds__(kThreads + 32, 1)
    reorth_right_kernel(const __grid_constant__ CUtensorMap map,
                        const float* __restrict__ a,
                        const float* __restrict__ u,
                        const float* __restrict__ q, float* __restrict__ out,
                        float* __restrict__ nrm, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(dcom::align1024(smem_raw));
  float* sm = ring + (size_t)g.stages * g.stage;
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = (int)cg::this_cluster().block_rank();
  const size_t b = blockIdx.x / g.C;
  cluster_arrive_relaxed();                 // phase 0: this CTA started
  DCOM_STAMP(0);
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      dcom::mbar_init(&full[s], g.tma ? 1 : 32);
      dcom::mbar_init(&empty[s], kWarps);
    }
    dcom::mbar_fence_init();
  }
  float* us = sm;
  float* zs = sm + g.o_z;
  if (tid < kThreads) {
    for (int i = 0; g.qsm && i < g.mine; ++i) {  // lands during pass 0
      const int j = rank + i * g.C;
      copy_q(g, q_rows(g, q, b, j), sm + g.o_q + i * g.blk * g.qp,
             block_rows(g, j));
    }
    for (int s = tid; s < g.S; s += kThreads) us[s] = u[b * g.S + s];
  }
  __syncthreads();

  if (tid >= kThreads) {                    // the producer warp
    int t = 0;
    for (int i = 0; i < g.mine; ++i) {
      const int j = rank + i * g.C, c0 = j * g.blk, x0 = c0 & ~3;
      const int cols = block_rows(g, j);
      const int span = cols > 0 ? c0 + cols - x0 : 0;
      for (int p0 = 0; p0 < span; p0 += g.W) {
        const int pw = min(g.W, span - p0);
        for (int s0 = 0; s0 < g.S; s0 += g.R, ++t) {
          const int slot = t % g.stages;
          if (t >= g.stages)
            dcom::mbar_wait(&empty[slot], (t / g.stages - 1) & 1);
          float* dst = ring + (size_t)slot * g.stage;
          if (g.tma) {
            if (lane == 0) {                // the boxes that hold the panel
              const int nb = cdiv(pw, g.boxc);
              dcom::mbar_expect(&full[slot], nb * g.R * g.boxc * 4);
              for (int kb = 0; kb < nb; ++kb)
                dcom::tma_load_2d(dst + kb * g.box, &map,
                                  x0 + p0 + kb * g.boxc, (int)(b * g.S) + s0,
                                  &full[slot]);
            }
          } else {
            const int nr = min(g.R, g.S - s0), wc = g.nbox * g.boxc;
            const float* at = a + (b * g.S + s0) * g.H + x0 + p0;
            for (int e = lane; e < nr * wc; e += 32) {
              const int r = e / wc, c = e - r * wc;
              dst[c / g.boxc * g.box + r * g.boxc + c % g.boxc] =
                  c < pw ? at[(size_t)r * g.H + c] : 0.f;
            }
            dcom::mbar_arrive(&full[slot]);
          }
        }
      }
    }
  } else {                                  // the consumers: pass 0
    const int tc = tid % g.tpr, grp = tid / g.tpr;
    const int cofs = 4 * tc / g.boxc * g.box + 4 * tc % g.boxc;
    float4* red4 = reinterpret_cast<float4*>(sm + g.o_red);
    int t = 0;
    for (int i = 0; i < g.mine; ++i) {
      const int j = rank + i * g.C, c0 = j * g.blk, x0 = c0 & ~3;
      const int cols = block_rows(g, j);
      const int span = cols > 0 ? c0 + cols - x0 : 0;
      for (int p0 = 0; p0 < span; p0 += g.W) {
        const int pw = min(g.W, span - p0);
        const bool on = grp < g.rg && 4 * tc < pw;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s0 = 0; s0 < g.S; s0 += g.R, ++t) {
          const int slot = t % g.stages;
          dcom::mbar_wait(&full[slot], (t / g.stages) & 1);
          const float* st = ring + (size_t)slot * g.stage + cofs;
          const float* ur = us + s0;
          const int nr = min(g.R, g.S - s0);
          if (on) {
#pragma unroll 4
            for (int r = grp; r < nr; r += g.rg) {
              const float4 x =
                  *reinterpret_cast<const float4*>(st + r * g.boxc);
              const float w = ur[r];
              acc.x = fmaf(x.x, w, acc.x);
              acc.y = fmaf(x.y, w, acc.y);
              acc.z = fmaf(x.z, w, acc.z);
              acc.w = fmaf(x.w, w, acc.w);
            }
          }
          __syncwarp();
          if (lane == 0) dcom::mbar_arrive(&empty[slot]);
        }
        if (grp < g.rg) red4[grp * g.tpr + tc] = acc;
        dcom::sync_consumers(kThreads);
        if (grp == 0 && on) {               // the row groups in order
          float4 sum = red4[tc];
          for (int q2 = 1; q2 < g.rg; ++q2) {
            const float4 x = red4[q2 * g.tpr + tc];
            sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
          }
          const float v4[4] = {sum.x, sum.y, sum.z, sum.w};
          for (int e = 0; e < 4; ++e) {     // column x0 + p0 + 4tc + e
            const int zi = x0 - c0 + p0 + 4 * tc + e;
            if (zi >= 0 && zi < cols) zs[i * g.blk + zi] = v4[e];
          }
        }
        dcom::sync_consumers(kThreads);
      }
    }
  }
  cgs2_cluster(g, sm, ring, q, out, nrm, b, rank);
}

// w_b = CGS2(A_b v_b, U_b).  Block j is rows [j*blk, j*blk + blk) of A,
// in groups of br rows; a ring stage is a group's next `cols` columns as
// ncg boxes of [br][32] (128-byte swizzled).  Consumer (cgp, r) owns row
// r of the group and column group cgp of every stage: it reads its row's
// 32 floats and the matching v (the same address across the warp); the
// column groups' sums are added in order at the group's end.
__global__ void __launch_bounds__(kThreads + 32, 1)
    reorth_left_kernel(const __grid_constant__ CUtensorMap map,
                       const float* __restrict__ a,
                       const float* __restrict__ v,
                       const float* __restrict__ q, float* __restrict__ out,
                       float* __restrict__ nrm, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(dcom::align1024(smem_raw));
  float* sm = ring + (size_t)g.stages * g.stage;
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = (int)cg::this_cluster().block_rank();
  const size_t b = blockIdx.x / g.C;
  cluster_arrive_relaxed();                 // phase 0: this CTA started
  DCOM_STAMP(0);
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      dcom::mbar_init(&full[s], g.tma ? 1 : 32);
      dcom::mbar_init(&empty[s], kWarps);
    }
    dcom::mbar_fence_init();
  }
  float* vs = sm;
  float* zs = sm + g.o_z;
  if (tid < kThreads) {
    for (int i = 0; g.qsm && i < g.mine; ++i) {  // lands during pass 0
      const int j = rank + i * g.C;
      copy_q(g, q_rows(g, q, b, j), sm + g.o_q + i * g.blk * g.qp,
             block_rows(g, j));
    }
    for (int c = tid; c < g.ncs * g.cols; c += kThreads)
      vs[c] = c < g.H ? v[b * g.H + c] : 0.f;
  }
  __syncthreads();

  if (tid >= kThreads) {                    // the producer warp
    int t = 0;
    for (int i = 0; i < g.mine; ++i) {
      const int j = rank + i * g.C, rows = block_rows(g, j);
      for (int g0 = 0; g0 < rows; g0 += g.br) {
        const int r0 = j * g.blk + g0;      // the group's first row
        for (int cs = 0; cs < g.ncs; ++cs, ++t) {
          const int slot = t % g.stages;
          if (t >= g.stages)
            dcom::mbar_wait(&empty[slot], (t / g.stages - 1) & 1);
          float* dst = ring + (size_t)slot * g.stage;
          if (g.tma) {
            if (lane == 0) {                // the boxes that start before H
              const int nb = min(g.ncg, cdiv(g.H - cs * g.cols, 32));
              dcom::mbar_expect(&full[slot], nb * g.br * 32 * 4);
              for (int kb = 0; kb < nb; ++kb)
                dcom::tma_load_2d(dst + kb * g.br * 32, &map,
                                  cs * g.cols + kb * 32, (int)(b * g.S) + r0,
                                  &full[slot]);
            }
          } else {
            const int nr = min(g.br, g.S - r0);
            const float* at = a + (b * g.S + r0) * g.H;
            for (int e = lane; e < g.br * g.cols; e += 32) {
              const int r = e / g.cols, cc = e - r * g.cols;
              const int c = cs * g.cols + cc;
              dst[cc / 32 * g.br * 32 + dcom::swz<float>(r, cc % 32, g.br)] =
                  r < nr && c < g.H ? at[(size_t)r * g.H + c] : 0.f;
            }
            dcom::mbar_arrive(&full[slot]);
          }
        }
      }
    }
  } else {                                  // the consumers: pass 0
    const int cgp = tid / g.br, r = tid - cgp * g.br;
    float* red = sm + g.o_red;
    int t = 0;
    for (int i = 0; i < g.mine; ++i) {
      const int j = rank + i * g.C, rows = block_rows(g, j);
      for (int g0 = 0; g0 < rows; g0 += g.br) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int cs = 0; cs < g.ncs; ++cs, ++t) {
          const int slot = t % g.stages;
          dcom::mbar_wait(&full[slot], (t / g.stages) & 1);
          const float* row =
              ring + (size_t)slot * g.stage + cgp * g.br * 32 + r * 32;
          const float* vb = vs + cs * g.cols + cgp * 32;
          const int nk = cs * g.cols + cgp * 32 < g.H ? 8 : 0;  // loaded?
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk >= nk) break;
            const float4 x =
                *reinterpret_cast<const float4*>(row + ((kk ^ (r & 7)) * 4));
            const float4 w = *reinterpret_cast<const float4*>(vb + kk * 4);
            float s = acc[kk & 3];
            s = fmaf(x.x, w.x, s);
            s = fmaf(x.y, w.y, s);
            s = fmaf(x.z, w.z, s);
            s = fmaf(x.w, w.w, s);
            acc[kk & 3] = s;
          }
          __syncwarp();
          if (lane == 0) dcom::mbar_arrive(&empty[slot]);
        }
        const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        const bool own = r < rows - g0;
        if (g.ncg == 1) {
          if (own) zs[i * g.blk + g0 + r] = sum;
        } else {
          red[tid] = sum;
          dcom::sync_consumers(kThreads);
          if (cgp == 0 && own) {            // the column groups in order
            float x = 0.f;
            for (int c2 = 0; c2 < g.ncg; ++c2) x += red[c2 * g.br + r];
            zs[i * g.blk + g0 + r] = x;
          }
          dcom::sync_consumers(kThreads);
        }
      }
    }
  }
  cgs2_cluster(g, sm, ring, q, out, nrm, b, rank);
}

using Kernel = void (*)(CUtensorMap, const float*, const float*,
                        const float*, float*, float*, Geo);

// Clusters of `C` CTAs of `smem` bytes the card can place at once, cached
// per (device, kernel, C, smem).
int max_clusters(Kernel kern, const cudaLaunchConfig_t& cfg, int C,
                 size_t smem, int* out) {
  struct Entry { int dev; Kernel kern; int C; size_t smem; int n; };
  static Entry cache[32];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].kern == kern && cache[i].C == C &&
        cache[i].smem == smem) {
      *out = cache[i].n;
      return 0;
    }
  e = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (used < 32) cache[used++] = {dev, kern, C, smem, *out};
  return 0;
}

// The launch configuration of `kern` for B elements of geometry g, after
// setting the function's shared-memory and cluster-size attributes.
int configure(Kernel kern, const Geo& g, int B, void* stream,
              cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(     // on the current device
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (e == cudaSuccess && g.C > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * g.C);
  cfg->blockDim = dim3(kThreads + 32);      // 8 consumer warps, 1 producer
  cfg->dynamicSmemBytes = g.smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

int launch(bool right, const float* a, const float* x, const float* q,
           float* out, float* nrm, int B, int S, int H, int k, int f,
           void* stream) {
  const int tma = (H & 3) == 0 && ((uintptr_t)a & 15) == 0;
  const Geo g = plan(right, S, H, k, f, tma);
  if (g.smem == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (tma) {
    const int e = right ? dcom::make_map_2d(&map, a, 4, (long)B * S, H, g.R,
                                            g.boxc, false)
                        : dcom::make_map_2d(&map, a, 4, (long)B * S, H, g.br,
                                            32, true);
    if (e != 0) return e;
  }
  const Kernel kern = right ? reorth_right_kernel : reorth_left_kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = configure(kern, g, B, stream, &cfg, attr);
  int clusters = 0;
  if (err == 0) err = max_clusters(kern, cfg, g.C, g.smem, &clusters);
  if (err != 0) return err;
  if (clusters == 0) return -1;             // no cluster of C CTAs fits
  return (int)cudaLaunchKernelEx(&cfg, kern, map, a, x, q, out, nrm, g);
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes one CTA needs (0: the shape does not fit
// in one H100 CTA); side 0 right, 1 left.
size_t dcom_reorth_smem_bytes(int side, int S, int H, int k, int f) {
  return plan(side == 0, S, H, k, f, 1).smem;
}

// CTAs of the cluster of one batch element at f blocks.
int dcom_reorth_cluster(int f) { return f < kMaxCluster ? f : kMaxCluster; }

// Whether the CTAs keep their Q rows in shared memory (Q read once).
int dcom_reorth_q_in_smem(int side, int S, int H, int k, int f) {
  return plan(side == 0, S, H, k, f, 1).qsm;
}

int dcom_reorth_max_k() { return 32 * KPL; }

#ifdef DCOM_REORTH_TIMELINE
// The stamps of the last launch's first n CTAs, [n][11] uint64.
int dcom_reorth_read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, dcom_reorth_stamps,
                                   sizeof(unsigned long long) * kStamps * n);
}
#endif

// Clusters of one element (min(f, 16) CTAs each) the current device holds
// at once; 0 when none fits, negative on a CUDA error.
int dcom_reorth_max_clusters(int side, int S, int H, int k, int f) {
  const Geo g = plan(side == 0, S, H, k, f, 1);
  if (g.smem == 0) return 0;
  const Kernel kern = side == 0 ? reorth_right_kernel : reorth_left_kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  int err = configure(kern, g, 1, nullptr, &cfg, attr);
  if (err == 0) err = max_clusters(kern, cfg, g.C, g.smem, &n);
  return err ? -err : n;
}

// Return value: the cudaError_t of the launch (0 = success), the CUresult
// of a tensor map that cannot be made, or -1 when the card cannot place
// one cluster of min(f, 16) CTAs.
int dcom_reorth_right_f32(const float* a, const float* u, const float* q,
                          float* z, float* nrm, int B, int S, int H, int k,
                          int f, void* stream) {
  return launch(true, a, u, q, z, nrm, B, S, H, k, f, stream);
}

int dcom_reorth_left_f32(const float* a, const float* v, const float* q,
                         float* w, float* nrm, int B, int S, int H, int k,
                         int f, void* stream) {
  return launch(false, a, v, q, w, nrm, B, S, H, k, f, stream);
}

}  // extern "C"

// Backward of the intra-chunk term of the Mamba2 SSD scan for Hopper
// (sm_90a).
//
// The forward (csrc/ssd_chunk.cu; the Pallas kernel of
// src/repro/kernels/ssd_chunk.py:70) is, per chunk g and head n,
//   y[q, :] = sum_{s <= q} M[q, s] x[s, :],
//   M[q, s] = cb[q, s] * E[q, s] * dt[s],   E[q, s] = exp(l[q] - l[s]),
// all float32: cb [G, Q, Q], l/dt [G, Q, NH], x/y [G, Q, NH, HD].  Given
// dy, with G[q, s] = dy[q, :] . x[s, :] (s <= q), its gradients are
//   dx[s, :]  = sum_{q >= s} M[q, s] dy[q, :]
//   dcb[q, s] = sum_n G E dt            (over the heads: see below)
//   ddt[s]    = sum_{q >= s} G cb E
//   dl[q]     = sum_{s <= q} (G M)[q, s] - sum_{q' >= q} (G M)[q', q]
// (E's exponent is l[q] - l[s], so it adds to dl[q] and takes from
// dl[s]).  The reference's training path differentiates the same lines
// written in jnp (src/repro/models/mamba2.py:120-126); the Pallas kernel
// has no VJP.
//
// What bounds it on the H100: at the training chunk of Q = 64 the bytes
// (x and dy in, dx out: 3 Q·nh·hd floats a chunk) would take 0.023 ms
// of the 0.35 ms a simple design took; the two 64 x 64 x hd products per
// (chunk, head, tile pair) are as many float32 operations as the CUDA
// cores issue in that time, so they run on the tensor cores in 3xTF32
// (float32 accuracy).  The warps' issue of those products now sets the
// pace (PERF.md; ssd_timeline.py).
//
// Design: a persistent grid of one CTA an SM (a producer warp and eight
// consumer warps).  An item is (key tile j, chunk g, block of hb heads);
// the items are taken heaviest first (key tile 0 meets every query tile),
// the first by CTA index and the rest from a self-resetting ticket; the
// host's plan (kernels/ssd_chunk.py: bwd_plan) picks hb.  An item walks
// its query tiles i = j .. nt - 1 and, for each, its heads.
//   Producer: for each (query tile, head) stage it fills a slot of a ring
//   with the x box of key tile j and the dy box of query tile i by TMA
//   (128-byte swizzled [64 rows][32 columns] boxes, out of range reading
//   as 0) and the stage's l and dt values by cp.async; the cb box of
//   tile (i, j) lands in a second ring once and stays while the item's
//   heads walk it.  Later stages stream in while one computes.
//   Consumers: warp (w, gm) owns the 16 keys s = 16w .. 16w + 15 and the
//   query blocks 2a + gm (8 queries each) of the tile; the gm = 1 warps
//   take the key blocks in reverse, so that on the diagonal each pair of
//   warps sharing a sub-partition holds 5 of the 20 blocks that are not
//   wholly above it (those are skipped).  Product 1, G^T[s, q] =
//   x[s, :] . dy[q, :], and product 2, dx[s, half of hd] = sum_q M[s, q]
//   dy[q, :], run as mma.sync m16n8k8 TF32 with each operand split into
//   a TF32 high part and residual (three products summed in float32, each
//   pass over independent accumulators; the guard of a skipped block is
//   the instruction's predicate, not a branch).  Product 1's accumulator
//   fragment is product 2's A fragment with the k order permuted (k = t
//   <-> q = 2t, k = t + 4 <-> q = 2t + 1): M stays in registers and
//   reaches the pair's other warp through shared memory, and each warp of
//   a pair computes and stores dx for its half of hd.  The masked terms
//   are built from the fragments, exp(l_q - l_s) evaluated only under
//   s <= q (exp(-inf) = 0 above the diagonal, where the difference could
//   overflow).  dl's row sums are a reduce-scatter over the warp's lanes,
//   added over the four key blocks in order through shared memory; ddt's
//   and dl's column sums are added by the gm = 0 warp of each pair (gm 0
//   first).  dx, ddt and dl's column part accumulate over the query
//   tiles in the thread's own stores, in query-tile order.
//   dcb sums over the heads: a thread's (q, s) positions are the same
//   for every head, so it sums its block's heads in registers and writes
//   the block's partial tile; the last CTA to finish a tile (a ticket per
//   tile) adds the partials in block order.  With Q over one tile, dl's
//   row sums span key tiles: per-item partials, added in key-tile order
//   by the last CTA of the chunk.  One launch, no float atomics, every
//   ticket reset before the launch ends: reruns are bit-identical
//   whichever CTA takes an item.
#include <climits>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

namespace {

constexpr int kT = 64;                    // query rows / keys of a tile
constexpr int kCW = 8;                    // consumer warps
constexpr int kCThreads = 32 * kCW;
constexpr int kThreads = kCThreads + 32;  // + the producer warp
constexpr int kNCB = 2;                   // cb ring slots
constexpr int kBoxF = kT * 32;            // floats in one [64][32] box
constexpr int kTileF = kT * kT;           // floats in a 64 x 64 tile
constexpr int kMaxHD = 128;

struct Hdr {                              // a stage's values for one head
  float lq[kT];                           // l of the query rows
  float ls[kT];                           // l of the keys
  float dt[kT];                           // dt of the keys
  int item;                               // the stage's item, -1: stop
  int pad[3];
};

struct Geo {
  int G, Q, NH, HDo;                      // HDo: dx's row width
  int nt, hb, nhb, full, rem, items;
};

struct Item {
  int g, j, b, n0, hcount;
  // u = j * (G * nhb) + v: key tile j ascending (heaviest first), then
  // the full blocks of every chunk (chunk-major), then the remainders
  __device__ Item(int u, const Geo& geo) {
    const int per = geo.G * geo.nhb, nf = geo.G * geo.full;
    j = u / per;
    const int v = u - j * per;
    if (v < nf) {
      g = v / geo.full;
      b = v - g * geo.full;
      hcount = geo.hb;
    } else {
      g = v - nf;
      b = geo.full;
      hcount = geo.rem;
    }
    n0 = b * geo.hb;
  }
};

// Shared memory (floats, from a 1024-aligned base): x ring | dy ring |
// cb ring | M fragments [2][8 warps][4][32][4] | row sums [2][4][64] |
// column sums [2][4][32][4] | headers.  NS x/dy slots.
template <int HDP>
struct Layout {
  static constexpr int NS = HDP <= 64 ? 3 : 2;
  static constexpr size_t bytes =
      1024 + (size_t)2 * NS * HDP * kT * 4 + (size_t)kNCB * kTileF * 4 +
      (size_t)2 * 8 * 512 * 4 + 2 * 4 * kT * 4 + 2 * 4 * 128 * 4 +
      NS * sizeof(Hdr) + 16;
};

// Measurement build only (ssd_timeline.py at the repository's root
// compiles this file with -DDCOM_SSD_BWD_TIMELINE): lane 0 of consumer
// warp 0 and of the producer warp log %globaltimer stamps and their tags
// per CTA.  The library that kernels/build.py builds has none of it.
#ifdef DCOM_SSD_BWD_TIMELINE
constexpr int kEvents = 160, kStampCtas = 1024;
__device__ unsigned long long dcom_ssd_bwd_times[kStampCtas][2][kEvents];
__device__ unsigned char dcom_ssd_bwd_tags[kStampCtas][2][kEvents];
__device__ __forceinline__ void ev(int who, int& n, int tag) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  if ((threadIdx.x & 31) == 0 && blockIdx.x < kStampCtas && n < kEvents) {
    dcom_ssd_bwd_times[blockIdx.x][who][n] = t;
    dcom_ssd_bwd_tags[blockIdx.x][who][n++] = (unsigned char)(tag + 1);
  }
}
#define DCOM_EV(who, tag) ev(who, n_ev, tag)
#else
#define DCOM_EV(who, tag)
#endif

// 4 bytes global -> shared, zero-filled when !ok; completes on the
// thread's next cp.async.mbarrier.arrive.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   dcom::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   dcom::smem_addr(bar))
               : "memory");
}

// v = hi + lo for the 3xTF32 products: hi is v cut to TF32's 10 mantissa
// bits (exactly representable), lo = v - hi exactly; the tensor core reads
// lo's top 10 mantissa bits, so the dropped part is below 2^-21 |v|
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a b when `on` (the same for the whole warp): the guard is the
// instruction's predicate, so no branch or reconvergence surrounds it
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1, bool on) {
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "@p mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"((int)on));
}

// c[k] += a b[k] in 3xTF32 for N independent accumulators: each pass
// runs over all N (the products of one accumulator N issues apart), the
// two residual products first, then hi * hi
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2],
                                     const bool (&on)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) mma(c[k], al, bh[k][0], bh[k][1], on[k]);
#pragma unroll
  for (int k = 0; k < N; ++k) mma(c[k], ah, bl[k][0], bl[k][1], on[k]);
#pragma unroll
  for (int k = 0; k < N; ++k) mma(c[k], ah, bh[k][0], bh[k][1], on[k]);
}

// MT: Q spans more than one query tile (with MT false, nt is 1 and every
// stage is on the diagonal, so the paths of the partial dl and of dx
// added over query tiles compile away)
template <int HDP, bool MT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_intra_bwd_kernel(const __grid_constant__ CUtensorMap cbmap,
                           const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap dymap,
                           const float* __restrict__ l,
                           const float* __restrict__ dt,
                           float* __restrict__ dcb, float* __restrict__ dl,
                           float* __restrict__ ddt, float* __restrict__ dx,
                           float* __restrict__ dcbw, float* __restrict__ dlw,
                           unsigned* __restrict__ tk, const Geo geo) {
  constexpr int NS = Layout<HDP>::NS, NCB = kNCB;
  constexpr int KD = HDP / 8;             // k steps of product 1
  constexpr int kStageF = HDP * kT;       // floats of one x (or dy) slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xring = reinterpret_cast<float*>(dcom::align1024(smem_raw));
  float* yring = xring + (size_t)NS * kStageF;
  float* cring = yring + (size_t)NS * kStageF;
  float* mbuf = cring + (size_t)NCB * kTileF;     // [2][8][4][32][4]
  float* rowsum = mbuf + 2 * 8 * 512;             // [2][4][kT]
  float* pairbuf = rowsum + 2 * 4 * kT;           // [2][4][32][4]
  Hdr* hdr = reinterpret_cast<Hdr*>(pairbuf + 2 * 4 * 128);
  int* flag = reinterpret_cast<int*>(hdr + NS);
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  __shared__ __align__(8) uint64_t cfull[NCB], cempty[NCB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = geo.Q, NH = geo.NH, nt = MT ? geo.nt : 1;
#ifdef DCOM_SSD_BWD_TIMELINE
  int n_ev = 0;
#endif
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      // 32 copy arrivals of the l/dt values and one arrive.expect_tx
      dcom::mbar_init(&full[s], 33);
      dcom::mbar_init(&empty[s], kCW);
    }
    for (int s = 0; s < NCB; ++s) {
      dcom::mbar_init(&cfull[s], 1);
      dcom::mbar_init(&cempty[s], kCW);
    }
    dcom::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kCW) {                      // the producer warp
    DCOM_EV(1, 20);
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(&cbmap) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(&xmap) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(&dymap) : "memory");
    }
    int u = blockIdx.x, m = 0, cs = 0;
    while (u < geo.items) {
      unsigned nxt = 0;                   // in flight while this is queued
      if (lane == 0) nxt = atomicAdd(&tk[0], 1u);
      const Item it(u, geo);
      const float* lg = l + (size_t)it.g * Q * NH;
      const float* dg = dt + (size_t)it.g * Q * NH;
      const int s0 = it.j * kT;
      for (int i = it.j; i < nt; ++i, ++cs) {
        const int q0 = i * kT, cslot = cs % NCB;
        // the cb box of tile (i, j), once for the item's heads
        if (cs >= NCB) dcom::mbar_wait(&cempty[cslot], (cs / NCB - 1) & 1);
        if (lane == 0) {
          float* dst = cring + (size_t)cslot * kTileF;
          dcom::mbar_expect(&cfull[cslot], kTileF * 4);
          dcom::tma_load_3d(dst, &cbmap, s0, q0, it.g, &cfull[cslot]);
          dcom::tma_load_3d(dst + kBoxF, &cbmap, s0 + 32, q0, it.g,
                            &cfull[cslot]);
        }
        for (int h = 0; h < it.hcount; ++h, ++m) {
          const int n = it.n0 + h, slot = m % NS;
          if (m >= NS) dcom::mbar_wait(&empty[slot], (m / NS - 1) & 1);
          Hdr& hd = hdr[slot];
#pragma unroll
          for (int e = 0; e < 2; ++e) {   // l and dt of rows lane, lane + 32
            const int r = lane + 32 * e, q = q0 + r, s = s0 + r;
            const size_t oq = (size_t)(q < Q ? q : 0) * NH + n;
            const size_t os = (size_t)(s < Q ? s : 0) * NH + n;
            cp4(&hd.lq[r], lg + oq, q < Q);
            cp4(&hd.ls[r], lg + os, s < Q);
            cp4(&hd.dt[r], dg + os, s < Q);
          }
          cp_arrive(&full[slot]);
          if (lane == 0) {
            hd.item = u;
            float* xd = xring + (size_t)slot * kStageF;
            float* yd = yring + (size_t)slot * kStageF;
            dcom::mbar_expect(&full[slot], 2 * kStageF * 4);
#pragma unroll
            for (int k = 0; k < HDP / 32; ++k) {
              dcom::tma_load_4d(xd + k * kBoxF, &xmap, 32 * k, n, s0, it.g,
                                &full[slot]);
              dcom::tma_load_4d(yd + k * kBoxF, &dymap, 32 * k, n, q0, it.g,
                                &full[slot]);
            }
          }
          DCOM_EV(1, 21);
        }
      }
      u = gridDim.x + (int)__shfl_sync(0xffffffffu, nxt, 0);
    }
    const int slot = m % NS;              // stop
    if (m >= NS) dcom::mbar_wait(&empty[slot], (m / NS - 1) & 1);
    if (lane == 0) hdr[slot].item = -1;
    dcom::mbar_arrive(&full[slot]);
    if (lane == 0) dcom::mbar_arrive(&full[slot]);
    if (lane == 0 && atomicAdd(&tk[1], 1u) == gridDim.x - 1) {
      tk[0] = 0u;                         // every CTA has taken its last
      tk[1] = 0u;                         // ticket: reset for the next launch
    }
    DCOM_EV(1, 22);
    return;
  }

  // consumers: warp cw is (w, gm): keys sa = 16 w + g and sa + 8, query
  // blocks 2a + gm (columns 16a + 8gm .. 16a + 8gm + 7, a < 4) of the
  // tile (g = lane / 4, t = lane % 4: the fragments' row and column
  // groups).  The gm = 1 warps take the key blocks in reverse, so that on
  // the diagonal each sub-partition's pair of warps (cw, cw + 4) holds 5
  // of the 20 query blocks at or below it.
  const int gm = warp >> 2, w = gm ? 7 - warp : warp;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int sa = 16 * w + g4;
  const int qg = 8 * gm;                  // query column of block 0
  constexpr int qa = 16;                  // columns between blocks
  unsigned* tile_tk = tk + 2;
  unsigned* chunk_tk = tile_tk + (size_t)geo.G * nt * nt;
  // Offsets (floats) into the swizzled [64][32] boxes, per-thread tables
  // indexed by compile-time values, so that every shared load is a base
  // register plus an immediate.  Column chunk c of a row r lies at chunk
  // c ^ (r & 7) (dcom::swz).
  //   o1[c]: rows with r & 7 == g, columns 4c + t (product 1's x and dy)
  //   o2[e][c]: row 2t + e, column dcol + 8c + g (dy in product 2;
  //     dcol = gm hd / 2: this warp's half), its box included
  //   oc[r][c]: cb row 2t + c, column sa + 8r
  const int dcol = gm * (HDP / 2);
  int o1[8], o2[2][HDP / 16], oc[2][2];
#pragma unroll
  for (int c = 0; c < 8; ++c) o1[c] = ((c ^ g4) << 2) + t4;
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int c = 0; c < HDP / 16; ++c) {
      const int col = dcol + 8 * c + g4;
      o2[e][c] = (col >> 5) * kBoxF + (2 * t4 + e) * 32 +
                 (((((col & 31) >> 2)) ^ (2 * t4 + e)) << 2) + (col & 3);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      oc[r][c] = (w >> 1) * kBoxF + (2 * t4 + c) * 32 +
                 (((4 * (w & 1) + 2 * r + (g4 >> 2)) ^ (2 * t4 + c)) << 2) +
                 (g4 & 3);
  // this thread's slot in the pair buffers: [warp w][lane]
  const int pb = (w * 32 + lane) * 4;
  int m = 0, cs = 0;
  if (warp == 0) DCOM_EV(0, 0);
  for (;;) {
    int slot = m % NS;
    dcom::mbar_wait(&full[slot], (m / NS) & 1);
    const int u = hdr[slot].item;
    if (u < 0) break;
    const Item it(u, geo);
    if (warp == 0) DCOM_EV(0, 1);
    const int s0 = it.j * kT;
    for (int i = it.j; i < nt; ++i, ++cs) {
      const int q0 = i * kT, cslot = cs % NCB;
      const bool diag = !MT || i == it.j;
      bool on[4];                         // query blocks at or below the
#pragma unroll                            // diagonal
      for (int a = 0; a < 4; ++a) on[a] = !diag || qa * a + qg >= 16 * w;
      dcom::mbar_wait(&cfull[cslot], (cs / NCB) & 1);
      const float* cbt = cring + (size_t)cslot * kTileF + 32 * qg;
      float dca[4][4];                    // the block's dcb partial
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) dca[a][e] = 0.f;
      for (int h = 0; h < it.hcount; ++h, ++m) {
        const int n = it.n0 + h, buf = m & 1;
        slot = m % NS;
        dcom::mbar_wait(&full[slot], (m / NS) & 1);
        if (warp == 0) DCOM_EV(0, 2);
        const float* xs = xring + (size_t)slot * kStageF + sa * 32;
        const float* y0 = yring + (size_t)slot * kStageF;
        const float* ys = y0 + 32 * qg;
        const float* y1 = ys + g4 * 32;
        // product 1: acc[a] = G^T[keys sa, sa + 8][queries 16a + 8gm ..]
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          // columns 8 kd + t and 8 kd + t + 4: chunks 2 (kd % 4) (+ 1)
          const int bx = (kd >> 2) * kBoxF;
          const int c0 = o1[2 * (kd & 3)], c1 = o1[2 * (kd & 3) + 1];
          uint32_t ah[4], al[4], bh[4][2], bl[4][2];
          split(xs[bx + c0], ah[0], al[0]);
          split(xs[bx + 256 + c0], ah[1], al[1]);
          split(xs[bx + c1], ah[2], al[2]);
          split(xs[bx + 256 + c1], ah[3], al[3]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            split(y1[bx + 32 * qa * a + c0], bh[a][0], bl[a][0]);
            split(y1[bx + 32 * qa * a + c1], bh[a][1], bl[a][1]);
          }
          mma3<4>(acc, ah, al, bh, bl, on);
        }
        if (warp == 0) DCOM_EV(0, 3);
        // the masked terms, from the fragments: acc becomes M^T
        const Hdr& hd = hdr[slot];
        const float ls[2] = {hd.ls[sa], hd.ls[sa + 8]};
        const float dts[2] = {hd.dt[sa], hd.dt[sa + 8]};
        float rp[4][2];                   // dl row sums, this thread's keys
        float cp[2] = {0.f, 0.f}, cc[2] = {0.f, 0.f};  // column sums
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float2 lq2 = *reinterpret_cast<const float2*>(
              &hd.lq[qa * a + qg + 2 * t4]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = e & 1;
            const int q = q0 + qa * a + qg + 2 * t4 + c, s = s0 + sa + 8 * r;
            // the mask before the exponent: exp(-inf) = 0 for s > q, so
            // l_q - l_s is never exponentiated above the diagonal
            const bool ok = s <= q && q < Q;
            const float ev = __expf(ok ? (c ? lq2.y : lq2.x) - ls[r]
                                       : -__int_as_float(0x7f800000));
            const float cbv = cbt[32 * qa * a + oc[r][c]];
            const float gv = acc[a][e];
            const float mv = cbv * ev * dts[r];
            const float p = gv * mv;
            cp[r] += p;
            cc[r] += gv * cbv * ev;
            dca[a][e] += gv * ev * dts[r];
            acc[a][e] = mv;
            if (r == 0)
              rp[a][c] = p;
            else
              rp[a][c] += p;
          }
        }
        // dl's row sums over the warp's 16 keys: a reduce-scatter over the
        // lanes of one t (g's bits 2, 1, 0); lane (g, t) is left with query
        // column 16 (2 g2 + g1) + 8 gm + 2t + g0
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const bool hi = g4 & 4;
            const float send = hi ? rp[a][c] : rp[a + 2][c];
            const float keep = hi ? rp[a + 2][c] : rp[a][c];
            rp[a][c] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
          }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool hi = g4 & 2;
          const float send = hi ? rp[0][c] : rp[1][c];
          const float keep = hi ? rp[1][c] : rp[0][c];
          rp[0][c] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        {
          const bool hi = g4 & 1;
          const float send = hi ? rp[0][0] : rp[0][1];
          const float keep = hi ? rp[0][1] : rp[0][0];
          rp[0][0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        }
        rowsum[(buf * 4 + w) * kT + qa * (2 * (g4 >> 2) + (g4 >> 1 & 1)) +
               qg + 2 * t4 + (g4 & 1)] = rp[0][0];
        if (warp == 0) DCOM_EV(0, 4);
        // hand M, and the column sums, to the pair's other warp
        float* mb = mbuf + buf * 8 * 512;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(mb + warp * 512 + a * 128 + lane * 4) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        float* pr = pairbuf + buf * 4 * 128 + pb;
        if (gm == 1)
          *reinterpret_cast<float4*>(pr) =
              make_float4(cp[0], cp[1], cc[0], cc[1]);
        dcom::sync_consumers(kCThreads);
        if (warp == 0) DCOM_EV(0, 11);
        if (gm == 0) {
          // ddt and dl: the pair's column sums (gm 0 first), the four
          // warps' row sums in order
          const float4 o = *reinterpret_cast<const float4*>(pr);
          cp[0] += o.x;
          cp[1] += o.y;
          cc[0] += o.z;
          cc[1] += o.w;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            cp[r] += __shfl_xor_sync(0xffffffffu, cp[r], 1);
            cp[r] += __shfl_xor_sync(0xffffffffu, cp[r], 2);
            cc[r] += __shfl_xor_sync(0xffffffffu, cc[r], 1);
            cc[r] += __shfl_xor_sync(0xffffffffu, cc[r], 2);
          }
          if (t4 == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int ql = sa + 8 * r;
              const float* rr = rowsum + buf * 4 * kT + ql;
              const float tot = ((rr[0] + rr[kT]) + rr[2 * kT]) + rr[3 * kT];
              const size_t o = ((size_t)it.g * Q + s0 + ql) * NH + n;
              float* dlp = dlw + (((size_t)it.g * nt + it.j) * Q) * NH + n;
              if (s0 + ql < Q) {          // ddt and dl's column part of
                if (diag) {               // the keys; the query tile's
                  ddt[o] = cc[r];         // row part
                  if (nt == 1)
                    dl[o] = tot - cp[r];
                  else
                    dlp[(size_t)(s0 + ql) * NH] = tot - cp[r];
                } else {
                  ddt[o] += cc[r];
                  dlp[(size_t)(s0 + ql) * NH] -= cp[r];
                }
              }
              if (!diag && q0 + ql < Q) dlp[(size_t)(q0 + ql) * NH] = tot;
            }
          }
        }
        // product 2: dx[keys][this warp's half of hd] = M^T dy over the
        // tile's 64 queries: query block 2a + gm's M from this warp's
        // registers, 2a + 1 - gm's from the pair's other warp, each as the
        // A fragment (k = t <-> q = 2t, k = t + 4 <-> q = 2t + 1)
        float dxa[KD / 2][4];
#pragma unroll
        for (int a = 0; a < KD / 2; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxa[a][e] = 0.f;
        // past the first query tile, the earlier stages' dx of these keys
        // (this thread's own stores), read now and added after the product
        float dxp[KD / 2][4];
#pragma unroll
        for (int nd = 0; nd < KD / 2; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxp[nd][e] = 0.f;
        if (!diag) {
#pragma unroll
          for (int nd = 0; nd < KD / 2; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int s = s0 + sa + 8 * (e >> 1);
              const int d = dcol + 8 * nd + 2 * t4 + (e & 1);
              if (s < Q && d < geo.HDo)
                dxp[nd][e] =
                    dx[(((size_t)it.g * Q + s) * NH + n) * geo.HDo + d];
            }
        }
        const float* mo = mb + (7 - warp) * 512 + lane * 4;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 po = *reinterpret_cast<const float4*>(mo + a * 128);
          const float pm[4] = {po.x, po.y, po.z, po.w};
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            const int kk = 2 * a + side;      // the query block
            const bool own = side == gm;
            float mv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) mv[e] = own ? acc[a][e] : pm[e];
            uint32_t ah[4], al[4], bh[KD / 2][2], bl[KD / 2][2];
            split(mv[0], ah[0], al[0]);
            split(mv[2], ah[1], al[1]);
            split(mv[1], ah[2], al[2]);
            split(mv[3], ah[3], al[3]);
            bool on2[KD / 2];
#pragma unroll
            for (int nd = 0; nd < KD / 2; ++nd) {
              split(y0[256 * kk + o2[0][nd]], bh[nd][0], bl[nd][0]);
              split(y0[256 * kk + o2[1][nd]], bh[nd][1], bl[nd][1]);
              on2[nd] = !diag || kk >= 2 * w;
            }
            mma3<KD / 2>(dxa, ah, al, bh, bl, on2);
          }
        }
        __syncwarp();
        if (lane == 0) {
          dcom::mbar_arrive(&empty[slot]);
          if (h == it.hcount - 1) dcom::mbar_arrive(&cempty[cslot]);
        }
        if (warp == 0) DCOM_EV(0, 5);
        // dx of the keys, this warp's half of hd: added in query-tile order
        // to the earlier stages'
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = s0 + sa + 8 * r;
          if (s >= Q) continue;
          float* out = dx + (((size_t)it.g * Q + s) * NH + n) * geo.HDo +
                       dcol + 2 * t4;
          if (geo.HDo == HDP) {             // whole rows: 8-byte pairs
#pragma unroll
            for (int nd = 0; nd < KD / 2; ++nd)
              *reinterpret_cast<float2*>(out + 8 * nd) =
                  make_float2(dxa[nd][2 * r] + dxp[nd][2 * r],
                              dxa[nd][2 * r + 1] + dxp[nd][2 * r + 1]);
          } else {
#pragma unroll
            for (int nd = 0; nd < KD / 2; ++nd)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                if (dcol + 8 * nd + 2 * t4 + c < geo.HDo)
                  out[8 * nd + c] = dxa[nd][2 * r + c] + dxp[nd][2 * r + c];
          }
        }
        if (warp == 0) DCOM_EV(0, 6);
      }
      // the block's dcb partial of tile (i, j): 16 values a thread,
      // contiguous
      const size_t tile = ((size_t)it.g * nt + i) * nt + it.j;
      const size_t mine = (size_t)(warp * 32 + lane) * 16;
      float4* wp = reinterpret_cast<float4*>(
          dcbw + (tile * geo.nhb + it.b) * kTileF + mine);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        wp[a] = make_float4(dca[a][0], dca[a][1], dca[a][2], dca[a][3]);
      __threadfence();
      dcom::sync_consumers(kCThreads);
      if (tid == 0)
        *flag = atomicAdd(&tile_tk[tile], 1u) == (unsigned)geo.nhb - 1;
      dcom::sync_consumers(kCThreads);
      if (warp == 0) DCOM_EV(0, 7);
      if (*flag) {                        // the last partial of the tile:
        __threadfence();                  // add the blocks' in order
        const float4* src = reinterpret_cast<const float4*>(
            dcbw + tile * geo.nhb * kTileF + mine);
        constexpr int kF = kTileF / 4;
        float4 sum[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) sum[a] = __ldcg(src + a);
        int bb = 1;
        for (; bb + 4 <= geo.nhb; bb += 4) {   // four blocks in flight
          float4 v[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int a = 0; a < 4; ++a)
              v[k][a] = __ldcg(src + (size_t)(bb + k) * kF + a);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              sum[a].x += v[k][a].x;
              sum[a].y += v[k][a].y;
              sum[a].z += v[k][a].z;
              sum[a].w += v[k][a].w;
            }
        }
        for (; bb < geo.nhb; ++bb)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float4 v = __ldcg(src + (size_t)bb * kF + a);
            sum[a].x += v.x;
            sum[a].y += v.y;
            sum[a].z += v.z;
            sum[a].w += v.w;
          }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float sv[4] = {sum[a].x, sum[a].y, sum[a].z, sum[a].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + qa * a + qg + 2 * t4 + (e & 1);
            const int s = s0 + sa + 8 * (e >> 1);
            if (q < Q && s < Q) dcb[((size_t)it.g * Q + q) * Q + s] = sv[e];
          }
        }
        if (i > it.j) {                   // the mirror tile above: zeros
          for (int e = tid; e < kTileF; e += kCThreads) {
            const int q = s0 + e / kT, s = q0 + e % kT;
            if (q < Q && s < Q) dcb[((size_t)it.g * Q + q) * Q + s] = 0.f;
          }
        }
        if (tid == 0) tile_tk[tile] = 0u;
      }
      if (warp == 0) DCOM_EV(0, 8);
    }
    if (nt > 1) {
      // the item is done: the chunk's last item adds dl's partials
      __threadfence();
      dcom::sync_consumers(kCThreads);
      if (tid == 0)
        *flag = atomicAdd(&chunk_tk[it.g], 1u) == (unsigned)(nt * geo.nhb) - 1;
      dcom::sync_consumers(kCThreads);
      if (*flag) {
        __threadfence();
        // dl[q, n] = sum over key tiles j <= q / 64 of the partials
        // [G][nt][Q][NH], eight (q, n) a thread in flight
        const int qn = Q * NH;
        const float* src = dlw + (size_t)it.g * nt * qn;
        float* dst = dl + (size_t)it.g * qn;
        for (int e0 = tid; e0 < qn; e0 += 8 * kCThreads) {
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = 0.f;
          for (int j0 = 0; j0 < nt; j0 += 4) {   // 32 loads in flight
            float p[4][8];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                const int e = e0 + k * kCThreads;
                p[jj][k] = e < qn && j0 + jj <= e / NH / kT
                               ? __ldcg(src + (size_t)(j0 + jj) * qn + e)
                               : 0.f;
              }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int k = 0; k < 8; ++k) v[k] += p[jj][k];
          }
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (e0 + k * kCThreads < qn) dst[e0 + k * kCThreads] = v[k];
        }
        if (tid == 0) chunk_tk[it.g] = 0u;
      }
      if (warp == 0) DCOM_EV(0, 9);
    }
  }
  if (warp == 0) DCOM_EV(0, 10);
}

template <int HDP, bool MT>
int set_attrs() {
  const auto k = ssd_chunk_intra_bwd_kernel<HDP, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Layout<HDP>::bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

// the CTAs one SM holds of both instances (the smaller count)
template <int HDP>
int ctas_per_sm() {
  int most = 0;
  for (int mt = 0; mt < 2; ++mt) {
    const auto k = mt ? ssd_chunk_intra_bwd_kernel<HDP, true>
                      : ssd_chunk_intra_bwd_kernel<HDP, false>;
    if ((mt ? set_attrs<HDP, true>() : set_attrs<HDP, false>()) != 0)
      return 0;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, k, kThreads, Layout<HDP>::bytes) != cudaSuccess)
      return 0;
    most = mt ? (n < most ? n : most) : n;
  }
  return most;
}

template <int HDP>
int launch(const CUtensorMap& cbmap, const CUtensorMap& xmap,
           const CUtensorMap& dymap, const float* l, const float* dt,
           float* dcb, float* dl, float* ddt, float* dx, float* dcbw,
           float* dlw, unsigned* tk, const Geo& geo, int grid,
           cudaStream_t stream) {
  const bool mt = geo.nt > 1;
  const int e = mt ? set_attrs<HDP, true>() : set_attrs<HDP, false>();
  if (e != 0) return e;
  const auto k = mt ? ssd_chunk_intra_bwd_kernel<HDP, true>
                    : ssd_chunk_intra_bwd_kernel<HDP, false>;
  k<<<grid, kThreads, Layout<HDP>::bytes, stream>>>(
      cbmap, xmap, dymap, l, dt, dcb, dl, ddt, dx, dcbw, dlw, tk, geo);
  return (int)cudaGetLastError();
}

// a 128-byte swizzled float32 map of `rank` dimensions (innermost first;
// strides in bytes between consecutive indices of dims 1..) with boxes of
// [.., 64 rows, 32 columns]
int make_map(CUtensorMap* map, const void* base, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  const dcom::EncodeTiled encode = dcom::encode_tiled();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
                     const_cast<void*>(base), dims, strides, box, step,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int hd_pad(int hd) { return (hd + 31) / 32 * 32; }

}  // namespace

extern "C" {

// Most float32 hd columns the kernel takes.
int dcom_ssd_bwd_max_hd() { return kMaxHD; }

// CTAs of the kernel one SM holds at once for head width hd (0 on error).
int dcom_ssd_bwd_ctas_per_sm(int hd) {
  switch (hd_pad(hd)) {
    case 32: return ctas_per_sm<32>();
    case 64: return ctas_per_sm<64>();
    case 96: return ctas_per_sm<96>();
    case 128: return ctas_per_sm<128>();
    default: return 0;
  }
}

#ifdef DCOM_SSD_BWD_TIMELINE
// The event logs of the last launch's first n CTAs: times [n][2][160]
// uint64 and tags + 1 [n][2][160] uint8 (0: no event), then zeroed for
// the next launch.
int dcom_ssd_bwd_read_events(void* times, void* tags, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(
      times, dcom_ssd_bwd_times, sizeof(unsigned long long) * 2 * kEvents * n);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(tags, dcom_ssd_bwd_tags, 2 * kEvents * n);
  if (e != cudaSuccess) return (int)e;
  static unsigned char zero[kStampCtas][2][kEvents];
  return (int)cudaMemcpyToSymbol(dcom_ssd_bwd_tags, zero, sizeof(zero));
}
#endif

// cb [G, Q, Q] with row stride cbs >= Q floats (cbs % 4 == 0), l/dt
// [G, Q, NH], x/dy [G, Q, NH, HD] (HD % 4 == 0; 16-byte aligned), all
// contiguous float32 on the current device -> dcb [G, Q, Q], dl/ddt
// [G, Q, NH], dx [G, Q, NH, HDo] (HDo <= HD: the columns kept).  hb heads
// an item.  dcbw: G * nt^2 * ceil(NH / hb)
// * 4096 floats, dlw: G * nt * Q * NH floats (nt = ceil(Q / 64); unused
// when nt == 1) of scratch; tickets: 2 + G * nt^2 + G zeroed counters,
// left zeroed; ctas: the grid's CTAs at most.  One kernel on `stream`.
// Return value: the cudaError_t of the launch (0 = success) or the
// CUresult of a tensor map that cannot be made.
int dcom_ssd_chunk_intra_bwd_f32(const float* cb, const float* l,
                                 const float* dt, const float* x,
                                 const float* dy, float* dcb, float* dl,
                                 float* ddt, float* dx, float* dcbw,
                                 float* dlw, int G, int Q, int NH, int HD,
                                 int HDo, int cbs, int hb, unsigned* tickets,
                                 int ctas, void* stream) {
  if (G <= 0 || Q <= 0 || NH <= 0 || HD <= 0) return 0;
  // autograd runs the backward on a thread of its own, where this may be
  // the first CUDA call: make the device's primary context current before
  // the tensor maps are encoded (cuTensorMapEncodeTiled needs one)
  static thread_local bool bound = false;
  if (!bound) {
    const cudaError_t e = cudaFree(nullptr);
    if (e != cudaSuccess) return (int)e;
    bound = true;
  }
  Geo g{};
  g.G = G; g.Q = Q; g.NH = NH; g.HDo = HDo;
  g.nt = (Q + kT - 1) / kT;
  g.hb = hb;
  g.full = hb > 0 ? NH / hb : 0;
  g.rem = hb > 0 ? NH % hb : 0;
  g.nhb = g.full + (g.rem > 0);
  const long long items = (long long)g.nt * G * g.nhb;
  if (hb < 1 || hb > NH || items > INT_MAX ||
      HD % 4 != 0 || HD > kMaxHD || HDo > HD || cbs % 4 != 0 || cbs < Q ||
      ctas < 1)
    return (int)cudaErrorInvalidValue;
  g.items = (int)items;
  CUtensorMap cbmap = {}, xmap = {}, dymap = {};
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Q, (cuuint64_t)Q, (cuuint64_t)G};
    const cuuint64_t strides[2] = {(cuuint64_t)cbs * 4,
                                   (cuuint64_t)cbs * 4 * Q};
    const cuuint32_t box[3] = {32, kT, 1};
    const int e = make_map(&cbmap, cb, 3, dims, strides, box);
    if (e != 0) return e;
  }
  {
    const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH,
                                (cuuint64_t)Q, (cuuint64_t)G};
    const cuuint64_t strides[3] = {(cuuint64_t)HD * 4,
                                   (cuuint64_t)HD * 4 * NH,
                                   (cuuint64_t)HD * 4 * NH * Q};
    const cuuint32_t box[4] = {32, 1, kT, 1};
    int e = make_map(&xmap, x, 4, dims, strides, box);
    if (e == 0) e = make_map(&dymap, dy, 4, dims, strides, box);
    if (e != 0) return e;
  }
  const int grid = (int)(items < ctas ? items : ctas);
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd_pad(HD)) {
    case 32:
      return launch<32>(cbmap, xmap, dymap, l, dt, dcb, dl, ddt, dx, dcbw,
                        dlw, tickets, g, grid, s);
    case 64:
      return launch<64>(cbmap, xmap, dymap, l, dt, dcb, dl, ddt, dx, dcbw,
                        dlw, tickets, g, grid, s);
    case 96:
      return launch<96>(cbmap, xmap, dymap, l, dt, dcb, dl, ddt, dx, dcbw,
                        dlw, tickets, g, grid, s);
    default:
      return launch<128>(cbmap, xmap, dymap, l, dt, dcb, dl, ddt, dx, dcbw,
                         dlw, tickets, g, grid, s);
  }
}

}  // extern "C"

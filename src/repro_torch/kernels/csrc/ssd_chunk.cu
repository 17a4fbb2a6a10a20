// Intra-chunk term of the Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_chunk.py:
//   ssd_chunk_intra (:70, body _ssd_chunk_kernel :34)
//     y[g, q, n, :] = sum_{s <= q} cb[g, q, s] * exp(l[g, q, n] - l[g, s, n])
//                                  * dt[g, s, n] * x[g, s, n, :]
// all float32: cb [G, Q, Q], l/dt [G, Q, nh], x/y [G, Q, nh, hd]
// (G = batch * chunks; cb = C·Bᵀ of each chunk, head-independent).
//
// What bounds it on the H100: at the model's chunk of Q = 64 it is bytes
// (x in and y out, Q·nh·hd floats each; the [Q, Q] decay tile never
// leaves the chip), at one long chunk (a whole bucketed prompt, Q up to
// max_len) the float32 FMAs of the lower triangle, 2·hd per (q, s, head)
// pair, on the CUDA cores.
//
// Design: a persistent grid of one CTA an SM, each with a producer warp
// and eight consumer warps.  The work is cut into items (chunk g, pair of
// 64-row query tiles, block of HB heads, 64-column slice of hd); the grid
// takes the first items by CTA index and the rest from a ticket counter,
// heaviest items first, so the triangle of one long chunk is balanced two
// ways: query tile i is paired with tile n - 1 - i in one item (n + 1 key
// stages either way), and the CTAs take items as they free up.  The last
// CTA to run out of items resets the counter.
//   Producer: for each 64-key stage of an item it fills one slot of a ring
//   with the x box [64 keys, 64 columns] by TMA (out-of-range keys and
//   columns read as 0) and the stage's l and dt values by cp.async (both
//   complete on the slot's mbarrier), and, for the first head of the item,
//   the cb box [64 rows, 64 keys] into a second ring.  An item's cb boxes
//   stay in that ring while its HB heads walk them (the host takes HB > 1
//   only where they fit), so cb is read once per block of heads; the next
//   head's x streams in while the current one computes.
//   Consumers: warp w owns the tile's 4-row blocks w and 15 - w, so on the
//   diagonal stage every warp does the same number of FMAs: a lane (all 8
//   rows, 2 columns) runs both blocks up to the low block's last key and
//   the high block alone after it.  Each warp first builds the masked
//   decay values M [64 keys, 8 rows] of its own rows in shared memory (no
//   block barrier), evaluating exp(l_q - l_s) ONLY under the mask s <= q
//   (above the diagonal l_q - l_s > 0 and the exponent can overflow; the
//   masked argument is -inf and M is 0 there, as the reference selects 0
//   with `where`).  The arithmetic is the plain version's: expf, the
//   products in its order (cb * decay) * dt, and y summed over the keys
//   in order by one fused multiply-add each, so the kernel reproduces the
//   plain version bit for bit (phase 8's bf16 route check, 48 chaotic
//   random-weight layers deep, fails on an ulp of difference).  Keys past
//   a row's diagonal and past Q are skipped: their terms add exact zeros.
// One launch; whatever CTA takes an item, reruns are bit-identical.
#include <climits>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

namespace {

constexpr int kTile = 64;                 // query rows, keys per stage, cols
constexpr int kWarps = 8;                 // consumer warps per CTA
constexpr int kThreads = 32 * kWarps + 32;  // + the producer warp
constexpr int kNX = 4;                    // x ring slots
constexpr int kNCB = 4;                   // cb ring slots
constexpr int kMRow = 12;                 // a warp's M row: 8 rows + pad
constexpr int kBox = kTile * kTile;       // floats in one box

struct Hdr {                              // a stage's values for one head
  float lq[kTile];                        // l of the query rows
  float ls[kTile];                        // l of the keys
  float dt[kTile];                        // dt of the keys
  int item;                               // the stage's item, -1: stop
};

struct Geo {
  int G, Q, NH, HD;
  int nt, hb, nhb, ncs;                   // query tiles, heads per item,
  int items;                              // head blocks, column slices
};

// Shared layout (bytes, from a 1024-aligned base): x ring | cb ring |
// each warp's M | headers.
constexpr size_t kXBytes = (size_t)kNX * kBox * 4;
constexpr size_t kCBBytes = (size_t)kNCB * kBox * 4;
constexpr size_t kMBytes = (size_t)kWarps * kTile * kMRow * 4;
constexpr size_t kSmem = 1024 + kXBytes + kCBBytes + kMBytes +
                         kNX * sizeof(Hdr);

struct Item {
  int g, ta, tb, n0, hcount, c0;          // tb < 0: a single tile
  __device__ Item(int u, const Geo& geo) {
    int r = u;
    c0 = (r % geo.ncs) * kTile;
    r /= geo.ncs;
    const int hbi = r % geo.nhb;
    r /= geo.nhb;
    g = r % geo.G;
    const int p = r / geo.G;
    ta = geo.nt - 1 - p;
    tb = p == ta ? -1 : p;
    n0 = hbi * geo.hb;
    hcount = min(geo.hb, geo.NH - n0);
  }
  __device__ int ntiles() const { return tb < 0 ? 1 : 2; }
  __device__ int tile(int i) const { return i == 0 ? ta : tb; }
  // cb boxes of the item: tile ta's ta + 1 stages, then tile tb's
  __device__ int cb_index(int i, int j) const { return i == 0 ? j : ta + 1 + j; }
  __device__ int cb_count() const { return ta + 1 + (tb < 0 ? 0 : tb + 1); }
};

// Measurement build only (ssd_timeline.py at the repository's root
// compiles this file with -DDCOM_SSD_TIMELINE): lane 0 of consumer warp 0
// and of the producer warp log %globaltimer stamps and their tags per
// CTA.  The library that kernels/build.py builds has none of it.
#ifdef DCOM_SSD_TIMELINE
constexpr int kEvents = 128, kStampCtas = 1024;
__device__ unsigned long long dcom_ssd_times[kStampCtas][2][kEvents];
__device__ unsigned char dcom_ssd_tags[kStampCtas][2][kEvents];
__device__ __forceinline__ void ev(int who, int& n, int tag) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  if ((threadIdx.x & 31) == 0 && blockIdx.x < kStampCtas && n < kEvents) {
    dcom_ssd_times[blockIdx.x][who][n] = t;
    dcom_ssd_tags[blockIdx.x][who][n++] = (unsigned char)(tag + 1);
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

// An arrival on `bar` once this thread's cp.async copies have landed,
// counted in the barrier's expected arrivals.
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   dcom::smem_addr(bar))
               : "memory");
}

// acc[e][f] += m[e] x[f], one fused multiply-add each, as the plain
// version's contraction accumulates
__device__ __forceinline__ void fma42(float (&acc)[4][2], float4 m, float2 x) {
  const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e][0] = fmaf(mv[e], x.x, acc[e][0]);
    acc[e][1] = fmaf(mv[e], x.y, acc[e][1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_intra_kernel(const __grid_constant__ CUtensorMap cbmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ l,
                       const float* __restrict__ dt, float* __restrict__ y,
                       unsigned* __restrict__ tk, const Geo geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(dcom::align1024(smem_raw));
  float* cbs = xs + (size_t)kNX * kBox;
  float* ms = cbs + (size_t)kNCB * kBox;
  Hdr* hdr = reinterpret_cast<Hdr*>(ms + kMBytes / 4);
  __shared__ __align__(8) uint64_t xfull[kNX], xempty[kNX];
  __shared__ __align__(8) uint64_t cfull[kNCB], cempty[kNCB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = geo.Q, NH = geo.NH;
#ifdef DCOM_SSD_TIMELINE
  int n_ev = 0;
#endif
  if (tid == 0) {
    for (int s = 0; s < kNX; ++s) {
      // 32 copy arrivals of the l/dt values and one arrive.expect_tx
      dcom::mbar_init(&xfull[s], 33);
      dcom::mbar_init(&xempty[s], kWarps);
    }
    for (int s = 0; s < kNCB; ++s) {
      dcom::mbar_init(&cfull[s], 1);
      dcom::mbar_init(&cempty[s], kWarps);
    }
    dcom::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {                   // the producer warp
    DCOM_EV(1, 10);
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(&cbmap) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(&xmap) : "memory");
    }
    int u = blockIdx.x, m = 0, cseq = 0;
    while (u < geo.items) {
      // the next item's index is in flight while this one is queued
      unsigned nxt = 0;
      if (lane == 0) nxt = atomicAdd(&tk[0], 1u);
      const Item it(u, geo);
      const float* lg = l + (size_t)it.g * Q * NH;
      const float* dg = dt + (size_t)it.g * Q * NH;
      for (int h = 0; h < it.hcount; ++h) {
        const int n = it.n0 + h;
        for (int i = 0; i < it.ntiles(); ++i) {
          const int t = it.tile(i);
          for (int j = 0; j <= t; ++j, ++m) {
            if (h == 0) {                 // the cb box, once per item
              const int cs = cseq + it.cb_index(i, j);
              const int slot = cs % kNCB;
              if (cs >= kNCB) dcom::mbar_wait(&cempty[slot], (cs / kNCB - 1) & 1);
              if (lane == 0) {
                dcom::mbar_expect(&cfull[slot], kBox * 4);
                dcom::tma_load_3d(cbs + (size_t)slot * kBox, &cbmap, j * kTile,
                                  t * kTile, it.g, &cfull[slot]);
              }
            }
            const int slot = m % kNX;
            if (m >= kNX) dcom::mbar_wait(&xempty[slot], (m / kNX - 1) & 1);
            DCOM_EV(1, 11);
            Hdr& hd = hdr[slot];
#pragma unroll
            for (int e = 0; e < 2; ++e) {  // l and dt of rows lane, lane + 32
              const int q = t * kTile + lane + 32 * e;
              const int s = j * kTile + lane + 32 * e;
              const size_t oq = (size_t)(q < Q ? q : 0) * NH + n;
              const size_t os = (size_t)(s < Q ? s : 0) * NH + n;
              cp4(&hd.lq[lane + 32 * e], lg + oq, q < Q);
              cp4(&hd.ls[lane + 32 * e], lg + os, s < Q);
              cp4(&hd.dt[lane + 32 * e], dg + os, s < Q);
            }
            cp_arrive(&xfull[slot]);
            if (lane == 0) {
              hd.item = u;
              dcom::mbar_expect(&xfull[slot], kBox * 4);
              dcom::tma_load_4d(xs + (size_t)slot * kBox, &xmap, it.c0, n,
                                j * kTile, it.g, &xfull[slot]);
            }
            DCOM_EV(1, 12);
          }
        }
      }
      cseq += it.cb_count();
      u = gridDim.x + (int)__shfl_sync(0xffffffffu, nxt, 0);
    }
    const int slot = m % kNX;             // stop
    if (m >= kNX) dcom::mbar_wait(&xempty[slot], (m / kNX - 1) & 1);
    if (lane == 0) hdr[slot].item = -1;
    dcom::mbar_arrive(&xfull[slot]);
    if (lane == 0) dcom::mbar_arrive(&xfull[slot]);
    if (lane == 0 && atomicAdd(&tk[1], 1u) == gridDim.x - 1) {
      tk[0] = 0u;                         // every CTA has taken its last
      tk[1] = 0u;                         // ticket: reset for the next launch
    }
    DCOM_EV(1, 13);
    return;
  }

  // consumers: warp w owns the tile's 4-row blocks w (rows 4w..4w+3,
  // "low") and 15 - w (rows 60-4w..63-4w, "high"); a lane all 8 rows by
  // the columns 2 lane, 2 lane + 1, summed over the keys in order
  const int rlo = 4 * warp, rhi = 60 - 4 * warp;
  // this warp's M [64 keys][8 rows: its low block, then its high block]
  float* mw = ms + (size_t)warp * kTile * kMRow;
  int m = 0, cseq = 0;
  if (warp == 0) DCOM_EV(0, 0);
  for (;;) {
    int slot = m % kNX;
    dcom::mbar_wait(&xfull[slot], (m / kNX) & 1);
    const int u = hdr[slot].item;
    if (u < 0) break;
    const Item it(u, geo);
    if (warp == 0) DCOM_EV(0, 1);
    for (int h = 0; h < it.hcount; ++h) {
      const int n = it.n0 + h;
      for (int i = 0; i < it.ntiles(); ++i) {
        const int t = it.tile(i), q0 = t * kTile;
        float lo[4][2] = {}, hi[4][2] = {};
        for (int j = 0; j <= t; ++j, ++m) {
          slot = m % kNX;
          dcom::mbar_wait(&xfull[slot], (m / kNX) & 1);
          if (warp == 0) DCOM_EV(0, 7);
          const int cs = cseq + it.cb_index(i, j), cslot = cs % kNCB;
          dcom::mbar_wait(&cfull[cslot], (cs / kNCB) & 1);
          if (warp == 0) DCOM_EV(0, 2);
          const Hdr& hd = hdr[slot];
          const float* cb = cbs + (size_t)cslot * kBox;
          const int s0 = j * kTile;
          const int nk = min(kTile, Q - s0);     // keys below Q
          float lq[8];                           // l of the warp's rows,
          int qv[8];                             // their q (-1: past Q)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int r = e < 4 ? rlo + e : rhi + e - 4;
            lq[e] = hd.lq[r];
            qv[e] = q0 + r < Q ? q0 + r : -1;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            // M[key][row] of this warp's 8 rows, key = lane + 32 half,
            // under the mask s <= q only, in the reference's arithmetic
            const int kk = lane + 32 * half, s = s0 + kk;
            const float ls = hd.ls[kk], dts = hd.dt[kk];
            // on the diagonal stage no low block reads keys 32..63
            const bool no_lo = half == 1 && j == t;
            float mv[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (e < 4 && no_lo) {
                mv[e] = 0.f;
                continue;
              }
              const int r = e < 4 ? rlo + e : rhi + e - 4;
              // the mask before the exponent: exp(-inf) = 0 where s > q
              const bool ok = s <= qv[e];
              const float d = expf(ok ? lq[e] - ls
                                      : -__int_as_float(0x7f800000));
              mv[e] = ok ? cb[r * kTile + kk] * d * dts : 0.f;
            }
            *reinterpret_cast<float4*>(mw + kk * kMRow) =
                make_float4(mv[0], mv[1], mv[2], mv[3]);
            *reinterpret_cast<float4*>(mw + kk * kMRow + 4) =
                make_float4(mv[4], mv[5], mv[6], mv[7]);
          }
          __syncwarp();
          if (warp == 0) DCOM_EV(0, 3);
          // keys each block needs: all below Q off the diagonal; on the
          // diagonal stage those up to the block's last row (s <= q)
          const int nlo = j == t ? min(nk, rlo + 4) : nk;
          const int nhi = j == t ? min(nk, rhi + 4) : nk;
          const float* xk = xs + (size_t)slot * kBox + 2 * lane;
          int kk = 0;
#pragma unroll 4
          for (; kk < nlo; ++kk) {
            const float2 xv = *reinterpret_cast<const float2*>(xk + kk * kTile);
            const float4 ml = *reinterpret_cast<const float4*>(mw + kk * kMRow);
            const float4 mh =
                *reinterpret_cast<const float4*>(mw + kk * kMRow + 4);
            fma42(lo, ml, xv);
            fma42(hi, mh, xv);
          }
#pragma unroll 4
          for (; kk < nhi; ++kk) {
            const float2 xv = *reinterpret_cast<const float2*>(xk + kk * kTile);
            const float4 mh =
                *reinterpret_cast<const float4*>(mw + kk * kMRow + 4);
            fma42(hi, mh, xv);
          }
          __syncwarp();
          if (lane == 0) {
            dcom::mbar_arrive(&xempty[slot]);
            if (h == it.hcount - 1) dcom::mbar_arrive(&cempty[cslot]);
          }
          if (warp == 0) DCOM_EV(0, 4);
        }
        const int col = it.c0 + 2 * lane;
        if (col < geo.HD) {               // HD % 4 == 0: both columns
          const size_t ystep = (size_t)NH * geo.HD;
          float* yq = y + (((size_t)it.g * Q + q0) * NH + n) * geo.HD + col;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (q0 + rlo + e < Q)
              *reinterpret_cast<float2*>(yq + (rlo + e) * ystep) =
                  make_float2(lo[e][0], lo[e][1]);
            if (q0 + rhi + e < Q)
              *reinterpret_cast<float2*>(yq + (rhi + e) * ystep) =
                  make_float2(hi[e][0], hi[e][1]);
          }
        }
        if (warp == 0) DCOM_EV(0, 5);
      }
    }
    cseq += it.cb_count();
  }
  if (warp == 0) DCOM_EV(0, 6);
}

}  // namespace

extern "C" {

// cb boxes one item holds in its ring slots at once (an item may take more
// than one head only if its cb boxes fit).
int dcom_ssd_cb_slots() { return kNCB; }

#ifdef DCOM_SSD_TIMELINE
// The event logs of the last launch's first n CTAs: times [n][2][128]
// uint64 and tags + 1 [n][2][128] uint8 (0: no event), then zeroed for
// the next launch.
int dcom_ssd_read_events(void* times, void* tags, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(
      times, dcom_ssd_times, sizeof(unsigned long long) * 2 * kEvents * n);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(tags, dcom_ssd_tags, 2 * kEvents * n);
  if (e != cudaSuccess) return (int)e;
  static unsigned char zero[kStampCtas][2][kEvents];
  return (int)cudaMemcpyToSymbol(dcom_ssd_tags, zero, sizeof(zero));
}
#endif

// cb [G, Q, Q] with row stride cbs >= Q floats (cbs % 4 == 0), l/dt
// [G, Q, NH], x/y [G, Q, NH, HD] (HD % 4 == 0), all contiguous float32 on
// the current device; hb heads per item; tickets: 2 zeroed counters,
// left zeroed; sms: the grid's CTAs at most.  Return value: the cudaError_t of the launch (0 = success) or
// the CUresult of a tensor map that cannot be made.
int dcom_ssd_chunk_intra_f32(const float* cb, const float* l, const float* dt,
                             const float* x, float* y, int G, int Q, int NH,
                             int HD, int cbs, int hb, unsigned* tickets,
                             int sms, void* stream) {
  Geo g{};
  g.G = G; g.Q = Q; g.NH = NH; g.HD = HD;
  g.nt = (Q + kTile - 1) / kTile;
  g.hb = hb;
  g.nhb = (NH + hb - 1) / hb;
  g.ncs = (HD + kTile - 1) / kTile;
  const long long items = (long long)((g.nt + 1) / 2) * G * g.nhb * g.ncs;
  if (items <= 0) return 0;
  const int cb_most = g.nt + 1;           // the pair (0, nt - 1)
  if (hb < 1 || (hb > 1 && cb_most > kNCB) || items > INT_MAX ||
      HD % 4 != 0 || cbs % 4 != 0 || cbs < Q)
    return (int)cudaErrorInvalidValue;
  g.items = (int)items;
  CUtensorMap cbmap = {}, xmap = {};
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Q, (cuuint64_t)Q, (cuuint64_t)G};
    const cuuint64_t strides[2] = {(cuuint64_t)cbs * 4,
                                   (cuuint64_t)cbs * 4 * Q};
    const cuuint32_t box[3] = {kTile, kTile, 1};
    const int e = dcom::make_map_f32(&cbmap, cb, 3, dims, strides, box);
    if (e != 0) return e;
  }
  {
    const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH,
                                (cuuint64_t)Q, (cuuint64_t)G};
    const cuuint64_t strides[3] = {(cuuint64_t)HD * 4,
                                   (cuuint64_t)HD * 4 * NH,
                                   (cuuint64_t)HD * 4 * NH * Q};
    const cuuint32_t box[4] = {kTile, 1, kTile, 1};
    const int e = dcom::make_map_f32(&xmap, x, 4, dims, strides, box);
    if (e != 0) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(items < sms ? items : sms);
  ssd_chunk_intra_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      cbmap, xmap, l, dt, y, tickets, g);
  return (int)cudaGetLastError();
}

}  // extern "C"

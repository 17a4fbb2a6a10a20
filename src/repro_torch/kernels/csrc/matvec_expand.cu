// Expanded matvec pair (paper Fig. 12, computation expansion) for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/matvec_expand.py:
//   matvec          (:65,  body _matvec_kernel :27)          y = A v
//   rmatvec         (:174, body _rmatvec_kernel :40)         z = A^T u
//   matvec_batched  (:122, body _matvec_batched_kernel :84)  y_b = A_b v_b
//   rmatvec_batched (:148, body _rmatvec_batched_kernel :97) z_b = A_b^T u_b
// A [B,S,H] and the vector in float32 or bf16, read as stored; float32
// accumulation and float32 output.  The scalar functions are B = 1 calls.
//
// What bounds it on the H100: bytes.  A is streamed once and every element
// takes one multiply-add (2 operations per 4 or 2 bytes), far below the
// float32 ridge of ~20 operations per byte, so the floor is
// |A| / 3.35 TB/s.
//
// Design.  On the TPU the f reduction blocks are the sequential last grid
// axis, accumulated into the output block in VMEM.  Here f is the number
// of CTAs that split the reduction axis: the grid is (f, row or column
// blocks, batch), and each CTA reduces its rows x (H/f) (or (S/f) x cols)
// tile in float32 into one partial per output element.  The f partials of
// an output are added in block order j = 0 .. f-1 (f = 1 writes the
// output directly) in the same launch: each CTA writes its partial to a
// float32 workspace [B, f, n], and the last CTA of its row (column) block
// to arrive adds them.  No atomics on the data: reruns at a fixed f are
// bit-identical, and the block-order sum mirrors the reference's
// accumulation.  Expansion engages more CTAs and so more of the card's
// memory bandwidth; past saturation the partials' traffic and the
// per-CTA cost of ever smaller tiles grow with f (the right side of the
// U).
//
// Memory access.  A CTA's bytes in flight set its rate, and per-thread
// loads cannot keep enough in flight (a warp walking one row keeps one
// row's loads in flight), so each CTA streams its tile through a
// shared-memory ring of 32 KB stages fed by TMA box copies from a
// producer warp, and its other threads sum the landed stages from shared
// memory.  Both keep three stages, two in flight, so two CTAs fit an SM
// (a deeper ring was no faster at Fig. 12's points).  rmatvec's threads
// lie along the columns.  matvec's lie along the rows, one row each, so
// a row's sum needs no shuffles and v is read by all lanes of a warp at
// once; its boxes are 128 bytes wide and swizzled so those row-parallel
// loads hit distinct banks.  Ragged shapes are masked, never padded; the
// 16-byte path is taken when H (and rmatvec's block) is a multiple of
// the vector width and A is 16-byte aligned, else element copies into
// the same ring layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "pipeline.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBf16 = 1;  // dtype codes of the C interface: 0 float32

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive elements at p (aligned to VEC * sizeof(T) when VEC > 1)
// as float32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = to_f(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC % 4 == 0, "float32 vectors are whole float4s");
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = x.x;
      o[4 * i + 1] = x.y;
      o[4 * i + 2] = x.z;
      o[4 * i + 3] = x.w;
    }
  } else if constexpr (VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(q[i]);
      o[2 * i] = x.x;
      o[2 * i + 1] = x.y;
    }
  } else {
    static_assert(VEC == 4, "bf16 vectors are 8 or 4 elements");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 x = __bfloat1622float2(q[i]);
      o[2 * i] = x.x;
      o[2 * i + 1] = x.y;
    }
  }
}

// ---------------------------------------------------------------------------
// The shared-memory ring of both directions.
// ---------------------------------------------------------------------------

constexpr int kStages = 3;              // ring depth: 2 stages in flight
constexpr int kStageBytes = 32 * 1024;  // bytes of A per ring stage
constexpr int kMaxColBlock = 4096;      // MAX_COL_BLOCK of the wrapper
constexpr int kUChunk = 2048;           // rows of u staged at a time
constexpr int kVChunk = 2048;           // matvec: columns of v staged at a time

// ---------------------------------------------------------------------------
// matvec: one pass, the split partials combined by the last CTA to arrive.
// ---------------------------------------------------------------------------

// A matvec ring stage: kThreads x 128 bytes of A (32 KB) as ncg boxes of
// [br rows][128 bytes] side by side along H, written with the 128-byte
// swizzle (dcom::swz): br is the CTA's row block rounded up to a power of
// two in 8 .. 256, so a stage holds br rows of ncg * E columns (E
// elements make 128 bytes).
struct MvStage {
  int br, ncg, cols, box;
  __host__ __device__ MvStage(int rb, int elem) {
    br = 8;
    while (br < 256 && br < rb) br <<= 1;
    ncg = kThreads / br;
    cols = ncg * (128 / elem);
    box = br * (128 / elem);
  }
};

// y[b, r0:r0+rb] over the split [c0, c1) = [j*split, j*split + split) of
// H.  The CTA streams its [rb x split] tile of A through a ring of
// kStages shared-memory stages of 32 KB, in row groups of br rows, each
// walked along the split one stage (ncg * E columns) at a time.  A
// producer warp (threads kThreads .. kThreads + 31) fills each free slot:
// on the 16-byte path with TMA box copies of `map` (A as [B*S, H], boxes
// of [br][E], 128-byte swizzle; rows past the tile and columns past the
// split are not summed, columns past H arrive as zeros) counted on the
// slot's "full" mbarrier, on the masked path with element copies into the
// same layout.  Each of the kThreads consumers owns one row of one box
// (column group cg, row r): it waits on "full", adds its row's 128 bytes
// times v (staged in shared memory as float32, kVChunk columns at a time,
// read by every lane of a warp at once) into four accumulators, and
// releases the slot on its "empty" mbarrier, one arrival per warp.  The
// swizzle puts eight consecutive rows of one 16-byte column chunk in
// eight different bank groups, so a warp's loads are conflict-free.  At
// the end of a row group the column groups' sums are added in order
// cg = 0 .. ncg-1.  With f == 1 the CTA writes y.  Otherwise it writes
// its float32 partial to part[b, j, :], and the last of the f CTAs of
// its row block to take a ticket adds the f partials in block order
// j = 0 .. f-1, writes y and resets the ticket to 0 for the next launch:
// one launch, no atomics on the data, bit-identical reruns.
template <typename TA, typename TV, int VEC>
__global__ void __launch_bounds__(kThreads + 32)
    matvec_kernel(const __grid_constant__ CUtensorMap map,
                  const TA* __restrict__ a, const TV* __restrict__ v,
                  float* __restrict__ part, float* __restrict__ y,
                  unsigned* __restrict__ tickets, int S, int H, int rb,
                  int split) {
  constexpr int E = 128 / sizeof(TA);     // elements of a 128-byte box row
  constexpr int NV = 16 / sizeof(TA);     // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* ring = reinterpret_cast<TA*>(dcom::align1024(smem_raw));
  __shared__ __align__(16) float vs[kVChunk];
  __shared__ float red[kThreads];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int j = blockIdx.x, f = gridDim.x;
  const size_t b = blockIdx.z;
  const int r0 = blockIdx.y * rb, rows = min(S, r0 + rb) - r0;
  const int c0 = min(H, j * split), cw = min(H, c0 + split) - c0;
  const MvStage sg(rb, sizeof(TA));
  const int ncs = (cw + sg.cols - 1) / sg.cols;   // stages of a row group
  const int nst = (rows + sg.br - 1) / sg.br * ncs;
  const int stage = sg.box * sg.ncg;              // elements of a stage
  float* out = (f == 1 ? y + b * S : part + (b * f + j) * S) + r0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      dcom::mbar_init(&full[s], VEC > 1 ? 1 : 32);
      dcom::mbar_init(&empty[s], kThreads / 32);
    }
    dcom::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kThreads) {                  // the producer warp
    const int lane = tid - kThreads;
    for (int t = 0; t < nst; ++t) {
      const int slot = t % kStages, g = t / ncs, cs = t - g * ncs;
      if (t >= kStages) dcom::mbar_wait(&empty[slot], (t / kStages - 1) & 1);
      TA* dst = ring + (size_t)slot * stage;
      if constexpr (VEC > 1) {
        if (lane == 0) {
          dcom::mbar_expect(&full[slot], stage * sizeof(TA));
          for (int k = 0; k < sg.ncg; ++k)
            dcom::tma_load_2d(dst + k * sg.box, &map,
                              c0 + cs * sg.cols + k * E,
                              (int)(b * S) + r0 + g * sg.br, &full[slot]);
        }
      } else {
        const int nr = min(sg.br, rows - g * sg.br);
        const int nc = min(sg.cols, cw - cs * sg.cols);
        const TA* at = a + (b * S + r0 + g * sg.br) * H + c0 + cs * sg.cols;
        for (int i = lane; i < nr * nc; i += 32) {
          const int r = i / nc, q = i - r * nc;
          dst[dcom::swz<TA>(r, q, sg.br)] = at[(size_t)r * H + q];
        }
        dcom::mbar_arrive(&full[slot]);
      }
    }
  } else {                                // the consumers
    const int cg = tid / sg.br, r = tid - cg * sg.br;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < nst; ++t) {
      const int slot = t % kStages, g = t / ncs, cs = t - g * ncs;
      const int col = cs * sg.cols;       // the stage's first column
      if (col % kVChunk == 0 && (t == 0 || cw > kVChunk)) {
        if (t > 0) dcom::sync_consumers(kThreads);
        for (int q = tid; q < kVChunk; q += kThreads)  // v as float32
          vs[q] = col + q < cw ? to_f(v[b * H + c0 + col + q]) : 0.f;
        dcom::sync_consumers(kThreads);
      }
      dcom::mbar_wait(&full[slot], (t / kStages) & 1);
      const TA* row = ring + (size_t)slot * stage + cg * sg.box + r * E;
      const int cb = col + cg * E;        // the box's first column
      const float* vb = vs + cb % kVChunk;
      if (cb + E <= cw) {                 // the whole box row in the split
#pragma unroll
        for (int k = 0; k < E / NV; ++k) {
          float x[NV], w[NV];
          load_vec<TA, NV>(row + ((k ^ (r & 7)) * NV), x);
          load_vec<float, NV>(vb + k * NV, w);
#pragma unroll
          for (int e = 0; e < NV; ++e)
            acc[k & 3] = fmaf(x[e], w[e], acc[k & 3]);
        }
      } else {                            // columns past the split: not added
#pragma unroll
        for (int k = 0; k < E / NV; ++k) {
          float x[NV], w[NV];
          load_vec<TA, NV>(row + ((k ^ (r & 7)) * NV), x);
          load_vec<float, NV>(vb + k * NV, w);
#pragma unroll
          for (int e = 0; e < NV; ++e)
            acc[k & 3] = cb + k * NV + e < cw ? fmaf(x[e], w[e], acc[k & 3])
                                              : acc[k & 3];
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) dcom::mbar_arrive(&empty[slot]);
      if (cs == ncs - 1) {                // the row group's sums
        const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
        const int i = g * sg.br + r;
        if (sg.ncg == 1) {
          if (i < rows) out[i] = sum;
        } else {
          red[tid] = sum;
          dcom::sync_consumers(kThreads);
          if (cg == 0 && i < rows) {
            float x = 0.f;
            for (int q = 0; q < sg.ncg; ++q) x += red[q * sg.br + r];
            out[i] = x;
          }
          dcom::sync_consumers(kThreads);
        }
      }
    }
  }
  if (ncs == 0)                           // an empty split adds zeros
    for (int i = tid; i < rows; i += blockDim.x) out[i] = 0.f;
  if (f == 1) return;
  __threadfence();                        // partial visible device-wide
  __syncthreads();                        // before the ticket is taken
  if (tid == 0) {
    unsigned* tk = tickets + b * gridDim.y + blockIdx.y;
    last = atomicAdd(tk, 1u) == (unsigned)(f - 1);
    if (last) *tk = 0u;                   // every split has arrived
  }
  __syncthreads();
  if (!last) return;
  const float* pp = part + b * f * S + r0;
  for (int i = tid; i < rows; i += blockDim.x) {
    float sum = 0.f;
    int q = 0;
    for (; q + 8 <= f; q += 8) {          // eight loads in flight, then
      float x[8];                         // added in block order
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = __ldcg(pp + (size_t)(q + k) * S + i);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += x[k];
    }
    for (; q < f; ++q) sum += __ldcg(pp + (size_t)q * S + i);
    y[b * S + r0 + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// rmatvec: one pass, the split partials combined by the last CTA to arrive.
// ---------------------------------------------------------------------------

// One ring stage of a CTA with cb columns: `rows` rows of A as nbox boxes
// of [rows][boxc] (a TMA box is at most 256 columns and 256 rows; boxc a
// multiple of vec), each padded to 128 bytes; sizes in elements.  The
// masked path (vec 1) takes one box of all cb columns.
struct RmvStage {
  int rows, nbox, boxc, box, size;
  __host__ __device__ RmvStage(int cb, int elem, int vec) {
    rows = kStageBytes / (cb * elem);
    rows = rows < 1 ? 1 : (rows > 256 ? 256 : rows);
    nbox = vec == 1 ? 1 : (cb + 255) / 256;
    while (cb % nbox != 0 || (cb / nbox) % vec != 0) ++nbox;
    boxc = cb / nbox;
    box = (rows * boxc * elem + 127) / 128 * 128 / elem;
    size = nbox * box;
  }
};

// z[b, c0:c0+cw] over the split [j*split, j*split + split) of S.  The CTA
// streams its [split x cb] tile of A through a ring of kStages shared
// memory stages of ~32 KB (two CTAs fit an SM).  A producer warp
// (threads kThreads .. kThreads + 31) fills each free slot: on the
// 16-byte path with TMA box copies of `map` (A as [B*S, H]; rows of a
// box past the split are not summed, columns past H arrive as zeros)
// counted on the slot's "full" mbarrier, on the masked path with element
// copies.  The kThreads consumers wait on "full", sum the stage and
// release the slot on its "empty" mbarrier, one arrival per warp.  u is
// staged in shared memory as float32, kUChunk rows at a time (a whole
// number of stages), so the sums never wait on a global load.  tpr
// consumers lie along the block's column vectors, MAXV each (independent
// 16-byte loads, no branch: a vector past the block reads vector 0 and
// is not added), and kThreads / tpr row groups walk alternate rows of
// each stage; the group sums are added in fixed order.  With f == 1 the
// CTA writes z.  Otherwise it writes its float32 partial to
// part[b, j, :], and the last of the f CTAs of its column block to take
// a ticket adds the f partials in block order j = 0 .. f-1, writes z and
// resets the ticket to 0 for the next launch: one launch, no atomics on
// the data, bit-identical reruns.
template <typename TA, typename TU, int VEC>
__global__ void __launch_bounds__(kThreads + 32)
    rmatvec_kernel(const __grid_constant__ CUtensorMap map,
                   const TA* __restrict__ a, const TU* __restrict__ u,
                   float* __restrict__ part, float* __restrict__ z,
                   unsigned* __restrict__ tickets, int S, int H, int cb,
                   int split) {
  constexpr int MAXV = kMaxColBlock / (kThreads * VEC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TA* ring = reinterpret_cast<TA*>(dcom::align1024(smem_raw));
  float* red = reinterpret_cast<float*>(ring);  // after the ring is drained
  __shared__ float us[kUChunk];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int j = blockIdx.x, f = gridDim.x;
  const size_t b = blockIdx.z;
  const int c0 = blockIdx.y * cb, cw = min(H, c0 + cb) - c0;
  const int s0 = min(S, j * split), rows = min(S, s0 + split) - s0;
  const RmvStage sg(cb, sizeof(TA), VEC);
  const int R = sg.rows;
  const int nst = (rows + R - 1) / R;
  // tpr consumers along the block's ncv column vectors, MAXV vectors
  // each (tc + v * tpr), rg row groups
  const int ncv = cw / VEC;
  const int tpr = min(kThreads, max(1, (ncv + MAXV - 1) / MAXV));
  const int rg = kThreads / tpr;
  const int g = tid / tpr, tc = tid % tpr;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      dcom::mbar_init(&full[s], VEC > 1 ? 1 : 32);
      dcom::mbar_init(&empty[s], kThreads / 32);
    }
    dcom::mbar_fence_init();
  }
  __syncthreads();
  float acc[MAXV][VEC];
#pragma unroll
  for (int v = 0; v < MAXV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[v][e] = 0.f;

  if (tid >= kThreads) {                  // the producer warp
    const int lane = tid - kThreads;
    const TA* at = a + (b * S + s0) * H + c0;
    for (int t = 0; t < nst; ++t) {
      const int slot = t % kStages;
      if (t >= kStages)
        dcom::mbar_wait(&empty[slot], (t / kStages - 1) & 1);
      TA* dst = ring + (size_t)slot * sg.size;
      if constexpr (VEC > 1) {
        if (lane == 0) {
          dcom::mbar_expect(&full[slot], sg.nbox * R * sg.boxc * sizeof(TA));
          for (int k = 0; k < sg.nbox; ++k)
            dcom::tma_load_2d(dst + k * sg.box, &map, c0 + k * sg.boxc,
                              (int)(b * S) + s0 + t * R, &full[slot]);
        }
      } else {
        const int r0 = t * R, nr = min(R, rows - r0);
        for (int i = lane; i < nr * cw; i += 32) {
          const int r = i / cw, q = i - r * cw;
          dst[r * cb + q] = at[(size_t)(r0 + r) * H + q];
        }
        dcom::mbar_arrive(&full[slot]);
      }
    }
  } else {                                // the consumers
    const TU* ut = u + b * S + s0;
    const int uc = R * (kUChunk / R);     // rows of u a chunk: whole stages
    int off[MAXV];                        // a vector's place in a stage row
    bool ok[MAXV];                        // (invalid ones read vector 0)
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int cv = tc + v * tpr, c = cv * VEC;
      ok[v] = cv < ncv && g < rg;
      off[v] = ok[v] ? c / sg.boxc * sg.box + c % sg.boxc : 0;
    }
    for (int t = 0; t < nst; ++t) {
      if (t * R % uc == 0) {              // u[t R, t R + uc) as float32
        if (t > 0) dcom::sync_consumers(kThreads);
        float x[kUChunk / kThreads];
#pragma unroll
        for (int k = 0; k < kUChunk / kThreads; ++k) {
          const int i = tid + k * kThreads, r = t * R + i;
          x[k] = i < uc && r < rows ? to_f(ut[r]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kUChunk / kThreads; ++k)
          if (tid + k * kThreads < uc) us[tid + k * kThreads] = x[k];
        dcom::sync_consumers(kThreads);
      }
      const int slot = t % kStages;
      dcom::mbar_wait(&full[slot], (t / kStages) & 1);
      const TA* st = ring + (size_t)slot * sg.size;
      const float* ust = us + t * R % uc;
      const int nr = min(R, rows - t * R);
      for (int r = g; r < nr; r += rg) {  // branch-free over the vectors
        const float u_r = ust[r];
        const TA* row = st + r * sg.boxc;
        float x[MAXV][VEC];
#pragma unroll
        for (int v = 0; v < MAXV; ++v) load_vec<TA, VEC>(row + off[v], x[v]);
#pragma unroll
        for (int v = 0; v < MAXV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[v][e] = ok[v] ? fmaf(x[v][e], u_r, acc[v][e]) : acc[v][e];
      }
      __syncwarp();
      if ((tid & 31) == 0) dcom::mbar_arrive(&empty[slot]);
    }
  }
  __syncthreads();                        // the ring is drained
  const bool mine = tid < kThreads && g < rg;
  if (rg > 1) {                           // add the row groups in order
    if (mine) {
#pragma unroll
      for (int v = 0; v < MAXV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[((g * tpr + tc) * MAXV + v) * VEC + e] = acc[v][e];
    }
    __syncthreads();
    if (mine && g == 0) {
#pragma unroll
      for (int v = 0; v < MAXV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float sum = 0.f;
          for (int q = 0; q < rg; ++q)
            sum += red[((q * tpr + tc) * MAXV + v) * VEC + e];
          acc[v][e] = sum;
        }
    }
  }
  float* dst = (f == 1 ? z + b * H : part + (b * f + j) * H) + c0;
  if (mine && g == 0) {
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int cv = tc + v * tpr;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (cv < ncv && cv * VEC + e < cw) dst[cv * VEC + e] = acc[v][e];
    }
  }
  if (f == 1) return;
  __threadfence();                        // partial visible device-wide
  __syncthreads();                        // before the ticket is taken
  if (tid == 0) {
    unsigned* tk = tickets + b * gridDim.y + blockIdx.y;
    last = atomicAdd(tk, 1u) == (unsigned)(f - 1);
    if (last) *tk = 0u;                   // every split has arrived
  }
  __syncthreads();
  if (!last) return;
  const float* p = part + b * f * H + c0;
  for (int c = tid; c < cw; c += blockDim.x) {
    float sum = 0.f;
    int q = 0;
    for (; q + 8 <= f; q += 8) {          // eight loads in flight, then
      float x[8];                         // added in block order
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = __ldcg(p + (size_t)(q + k) * H + c);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += x[k];
    }
    for (; q < f; ++q) sum += __ldcg(p + (size_t)q * H + c);
    z[b * H + c0 + c] = sum;
  }
}

template <typename TA, typename TV, int VEC>
int launch_matvec(const void* a, const void* v, float* part, float* y,
                  unsigned* tickets, int B, int S, int H, int f, int split,
                  int rb, cudaStream_t st) {
  const MvStage sg(rb, sizeof(TA));
  CUtensorMap map = {};
  if (VEC > 1) {
    const int e = dcom::make_map_2d(&map, a, sizeof(TA), (long)B * S, H,
                                    sg.br, 128 / sizeof(TA), true);
    if (e != 0) return e;
  }
  const size_t smem = (size_t)kStages * kStageBytes + 1024;
  const cudaError_t e = cudaFuncSetAttribute(   // on the current device
      matvec_kernel<TA, TV, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(f, (S + rb - 1) / rb, B);
  matvec_kernel<TA, TV, VEC><<<grid, kThreads + 32, smem, st>>>(
      map, static_cast<const TA*>(a), static_cast<const TV*>(v), part, y,
      tickets, S, H, rb, split);
  return (int)cudaGetLastError();
}

template <typename TA, typename TU, int VEC>
int launch_rmatvec(const void* a, const void* u, float* part, float* z,
                   unsigned* tickets, int B, int S, int H, int f, int split,
                   int cb, cudaStream_t st) {
  const RmvStage sg(cb, sizeof(TA), VEC);
  CUtensorMap map = {};
  if (VEC > 1) {
    const int e = dcom::make_map_2d(&map, a, sizeof(TA), (long)B * S, H,
                                    sg.rows, sg.boxc, false);
    if (e != 0) return e;
  }
  // the ring, or the row groups' sums (kThreads * MAXV * VEC floats =
  // kMaxColBlock) after it, whichever is larger
  const size_t smem = std::max((size_t)kStages * sg.size * sizeof(TA),
                               sizeof(float) * kMaxColBlock) + 1024;
  const cudaError_t e = cudaFuncSetAttribute(   // on the current device
      rmatvec_kernel<TA, TU, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(f, (H + cb - 1) / cb, B);
  rmatvec_kernel<TA, TU, VEC><<<grid, kThreads + 32, smem, st>>>(
      map, static_cast<const TA*>(a), static_cast<const TU*>(u), part, z,
      tickets, S, H, cb, split);
  return (int)cudaGetLastError();
}

// Dispatch on (A type, vector type, 16-byte path).  A's vector width is
// 16 bytes of its own type; the vector operand is read at the same width.
#define DCOM_MV_DISPATCH(FN)                                                  \
  if (a_bf16 && v_bf16)                                                      \
    err = vec ? FN<__nv_bfloat16, __nv_bfloat16, 8>(ARGS)                    \
              : FN<__nv_bfloat16, __nv_bfloat16, 1>(ARGS);                   \
  else if (a_bf16)                                                           \
    err = vec ? FN<__nv_bfloat16, float, 8>(ARGS)                            \
              : FN<__nv_bfloat16, float, 1>(ARGS);                           \
  else if (v_bf16)                                                           \
    err = vec ? FN<float, __nv_bfloat16, 4>(ARGS)                            \
              : FN<float, __nv_bfloat16, 1>(ARGS);                           \
  else                                                                       \
    err = vec ? FN<float, float, 4>(ARGS) : FN<float, float, 1>(ARGS);

}  // namespace

extern "C" {

// y[b, s] = sum_h A[b, s, h] v[b, h] in one launch.  a_dtype / v_dtype:
// 0 float32, 1 bf16.  part: float32 [B, f, S] partials and tickets:
// B * ceil(S / rb) zeroed counters, left zeroed (both unused when
// f == 1); split: columns per CTA (the wrapper's rule); rb: rows per CTA;
// vec: take the 16-byte path.  Returns the
// cudaError_t of the launch (0 = success), or the CUresult of a tensor map
// that cannot be made.
int dcom_matvec(int a_dtype, int v_dtype, const void* a, const void* v,
                float* part, unsigned* tickets, float* y, int B, int S,
                int H, int f, int split, int rb, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool a_bf16 = a_dtype == kBf16, v_bf16 = v_dtype == kBf16;
  int err;
#define ARGS a, v, part, y, tickets, B, S, H, f, split, rb, st
  DCOM_MV_DISPATCH(launch_matvec)
#undef ARGS
  return err;
}

// z[b, h] = sum_s A[b, s, h] u[b, s] in one launch.  part: float32
// [B, f, H] partials and tickets: B * ceil(H / cb) zeroed counters, left
// zeroed (both unused when f == 1); split: rows per CTA; cb: columns per
// CTA (<= 4096); otherwise as dcom_matvec, except that a tensor map that
// cannot be made returns its CUresult.
int dcom_rmatvec(int a_dtype, int u_dtype, const void* a, const void* u,
                 float* part, unsigned* tickets, float* z, int B, int S,
                 int H, int f, int split, int cb, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool a_bf16 = a_dtype == kBf16, v_bf16 = u_dtype == kBf16;
  int err;
#define ARGS a, u, part, z, tickets, B, S, H, f, split, cb, st
  DCOM_MV_DISPATCH(launch_rmatvec)
#undef ARGS
  return err;
}

}  // extern "C"

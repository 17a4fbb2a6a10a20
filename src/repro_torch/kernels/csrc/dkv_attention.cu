// Rank-space flash-decoding statistics for Hopper (sm_90a).
//
// Replaces the Pallas kernels src/repro/kernels/dkv_attention.py:
//   dkv_attention_stats       (:90, body _dkv_kernel :39)
//   dkv_attention_stats_paged (:190, body _dkv_paged_kernel :141)
// For every slot b and query head g (all heads of the slot at once):
//   s_t  = inner[b,g,:] . U_k[b,t,:]                     (t < T)
//   rows t >= t_valid[b] are masked exactly: score -1e30, probability 0
//   m    = max_t s_t,  l = sum_t exp(s_t - m),  a = sum_t exp(s_t - m) U_v[b,t,:]
// inner [B,G,R] float32 (already scaled by hd^-0.5); t_valid [B] int32 (per
// slot: serving's frozen_len; the Pallas kernels take one static int).
// Outputs a [B,G,R], m, l [B,G] float32.  The exact dense-tail merge stays
// outside (merge_with_tail).  Two layouts of U, float32 or bf16:
//   slab:  U_k, U_v [B,T,R]; row t of slot b at (b*T + t)*R;
//   paged: pools [P,page,R_pool] and a block table bt [B,n] int32; row t of
//          slot b at (bt[b,t/page]*page + t%page)*R_pool, of which the
//          first R <= R_pool columns are read (T = n*page).
// The layout is a template parameter of the row loader; every other
// instruction is shared, so on the gathered rows at equal R the paged
// statistics are bit-identical to the slab statistics.
//
// What bounds it on the H100: neither bytes nor operations.  A decode step
// reads each slot's U_k and U_v rows below t_valid once (4*R bytes a row
// in bf16) and does 4*G*R float32 operations a row: at serving's shape
// (4 slots of up to 512 rows, G 32, R 64) ~340 KB and ~11 MFLOP, 0.1 us
// of bytes and 0.16 us of FMA issue, below the ~2 us an empty launch
// takes.  What is left is latency: a walk over the rows in series costs
// one dependent round of loads, products and block barriers per tile,
// and a split of the rows costs the round trips of its merge.
//
// Design: the rows below t_valid[b] are cut into blocks, and the heads into
// groups of GH = 8; the grid is (blocks, head groups, B), sized from the
// shapes alone, so the host never reads t_valid.  With no operating point
// a block is a chunk of TC = 32 rows by row index (chunk c holds rows
// [32c, 32c + 32)) and the grid has ceil(T / 32) of them.  A caller's
// expansion f makes f blocks, as the TPU kernel's grid (f,) does: block c
// holds rows [c L, c L + L) with L = ceil(t_valid / f) (the reference's
// blocks of a time axis padded to a multiple of f; they depend on
// t_valid, never on T, so padded and unpadded U agree bit for bit), and
// its CTA walks them in tiles of 32 rows from the block's start, carrying
// the running (m, l, a) with the reference's online-softmax update
// (_dkv_kernel :39-85; a in shared memory).  A CTA whose block starts at
// or past t_valid[b] returns at once (block 0 always runs, so t_valid = 0
// gives a = 0, m = -1e30, l = 0).  For each tile the CTA stages inner
// (once) while t_valid is in flight, then the tile's U_k and U_v rows
// (16-byte loads where the rows are aligned, all in flight together) as
// float32 in shared memory; one warp per head scores its 32 rows, one row
// a lane, and takes the tile's max, probabilities and sum with shuffles;
// the lanes then sum P U_v along R.  The result is the block's (m_c, l_c,
// a_c).  A slot whose t_valid fits one block writes it as the output.
// Otherwise each block writes it to float32 scratch and takes a ticket;
// the last CTA of a (slot, head group) to arrive merges the blocks in
// block order c = 0, 1, ...:
//   m = max_c m_c,  l = sum_c l_c exp(m_c - m),  a = sum_c a_c exp(m_c - m)
// (its loads of the a_c are in flight while m is found) and resets its
// ticket for the next launch: one launch, no atomics on the data,
// bit-identical reruns.  Both loaders share the chunking by row index and
// the merge order, so paged and slab stay bit-equal (the paged kernel
// takes no operating point, as in the reference).  A one-block merge
// gives the block's own bits (exp(0) = 1), so the direct write agrees
// with it, and a one-tile block's online update is the tile's own
// statistics.  The products stay float32 FMAs: they are not what costs
// time, and a bf16 mma would round inner and the probabilities.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;            // rows per tile (one per lane)
constexpr int GH = 8;             // heads per CTA
constexpr int NT = 32 * GH;       // a warp per head
constexpr int CCH = 16;           // blocks' loads in flight in the merge
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The 16 bytes at p as float32 (4 floats or 8 bf16).
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(q[i]);
    o[2 * i] = x.x;
    o[2 * i + 1] = x.y;
  }
}

// Row loaders: the element offset of row t (column 0) of slot b.
template <typename T>
struct SlabRows {
  const T* ku;
  const T* vu;
  int tn, stride;                  // T rows of R columns per slot
  __device__ __forceinline__ size_t row(size_t b, int t) const {
    return (b * tn + t) * (size_t)stride;
  }
};

template <typename T>
struct PagedRows {
  const T* ku;                     // pools [P, page, stride]
  const T* vu;
  const int* bt;                   // [B, n] page ids
  int tn, stride, page, n;         // tn = n * page
  __device__ __forceinline__ size_t row(size_t b, int t) const {
    const int j = t / page;
    return ((size_t)bt[b * n + j] * page + (t - j * page)) * (size_t)stride;
  }
};

// Shared layout (floats), a tile's pass: inner [GH*R] | uk [TC*ks] |
// uv [TC*R] | pr [GH*TC] (| ra [GH*R], the running a of a walking CTA),
// with ks = R | 1 (an odd row stride, so the score loop, lanes along rows,
// hits distinct banks); the merge reuses the same floats for sc [GH*nc]
// (each block's scale exp(m_c - m)) and sl [GH*nc] (l_c scaled).
size_t smem_bytes(int R, int nc, bool walk) {
  const size_t pass = (size_t)GH * R + (size_t)TC * (R | 1) +
                      (size_t)TC * R + (size_t)GH * TC +
                      (walk ? (size_t)GH * R : 0);
  const size_t merge = 2 * (size_t)GH * nc;
  return sizeof(float) * (pass > merge ? pass : merge);
}

// Blocks of a launch over Tn rows: f, or ceil(Tn / TC) chunks (f = 0).
int blocks_of(int Tn, int f) { return f > 0 ? f : (Tn + TC - 1) / TC; }

// Partials of block c of (slot b, head group g): a at
// pa[(((b * NG + g) * nc + c) * GH + h) * R], m and l at the same index
// over R in pm and pl.
template <typename T, typename Rows, bool VEC>
__global__ void __launch_bounds__(NT)
dkv_stats_kernel(const float* __restrict__ inner, const Rows rows,
                 const int* __restrict__ t_valid, float* __restrict__ pa,
                 float* __restrict__ pm, float* __restrict__ pl,
                 unsigned* __restrict__ tickets, float* __restrict__ a_out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int G, int R, int f) {
  extern __shared__ __align__(16) float sm[];
  __shared__ bool last;
  const int c = blockIdx.x, nc = gridDim.x;
  const int grp = blockIdx.y, ng = gridDim.y, g0 = grp * GH;
  const size_t b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gn = min(GH, G - g0);                // heads of this CTA
  const int ks = R | 1;
  float* inn = sm;
  float* uk = inn + GH * R;
  float* uv = uk + TC * ks;
  float* pr = uv + TC * R;
  float* ra = pr + GH * TC;                      // walking CTAs only
  const T* __restrict__ ku = rows.ku;
  const T* __restrict__ vu = rows.vu;

  // stage inner (heads past G as zeros) while t_valid is in flight
  const int tv_raw = t_valid[b];
  for (int i = tid; i < GH * R; i += NT)
    inn[i] = i < gn * R ? inner[(b * G + g0) * R + i] : 0.f;
  const int tv = min(max(tv_raw, 0), rows.tn);
  const int len = f > 0 ? max(1, (tv + f - 1) / f) : TC;  // rows a block
  const int nact = max(1, (tv + len - 1) / len);  // blocks holding rows
  if (c >= nact) return;
  const int r0 = c * len, r1 = min(tv, r0 + len);  // the block's rows
  const int ntile = max(1, (r1 - r0 + TC - 1) / TC);
  const bool direct = nact == 1;
  const int hl = warp;                           // a warp per head
  const bool mine = hl < gn;
  const size_t pidx = ((b * ng + grp) * nc + c) * GH + hl;
  float m_run = kNeg, l_run = 0.f;               // the warp's head, so far
  for (int tl = 0; tl < ntile; ++tl) {
  // the tile's rows as float32 (rows past the block as zeros: they are
  // multiplied by probability 0)
  if (tl > 0) __syncthreads();                   // the last tile is read
  const int t0 = r0 + tl * TC, nr = min(TC, r1 - t0);  // rows of the block
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);            // elements per 16 bytes
    constexpr int K = 4;                         // loads of a thread in flight
    const int nv = R / E, items = TC * nv;
    for (int i0 = 0; i0 < items; i0 += K * NT) {
      float kx[K][E], vx[K][E];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = i0 + k * NT + tid, t = i / nv;
        if (i < items && t < nr) {
          const size_t off = rows.row(b, t0 + t) + (i - t * nv) * E;
          load16(ku + off, kx[k]);
          load16(vu + off, vx[k]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kx[k][e] = vx[k][e] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = i0 + k * NT + tid, t = i / nv, q = (i - t * nv) * E;
        if (i < items) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            uk[t * ks + q + e] = kx[k][e];
            uv[t * R + q + e] = vx[k][e];
          }
        }
      }
    }
  } else {
    for (int i = tid; i < TC * R; i += NT) {
      const int t = i / R, q = i - t * R;
      float kx = 0.f, vx = 0.f;
      if (t < nr) {
        const size_t off = rows.row(b, t0 + t) + q;
        kx = to_f32(ku[off]);
        vx = to_f32(vu[off]);
      }
      uk[t * ks + q] = kx;
      uv[t * R + q] = vx;
    }
  }
  __syncthreads();

  // the scores of the warp's head, one row a lane (four partial sums)
  const float* iq = inn + hl * R;
  const float* kr = uk + lane * ks;
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
  int q = 0;
  for (; q + 4 <= R; q += 4)
#pragma unroll
    for (int k = 0; k < 4; ++k) s4[k] = fmaf(iq[q + k], kr[q + k], s4[k]);
  for (; q < R; ++q) s4[0] = fmaf(iq[q], kr[q], s4[0]);
  const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
  const bool valid = lane < nr;
  // the online-softmax update (the first tile: the tile's own statistics)
  const float mt = warp_max(valid ? s : kNeg);
  const float mc = tl ? fmaxf(m_run, mt) : mt;
  const float p = valid ? expf(s - mc) : 0.f;
  const float sc = tl ? expf(m_run - mc) : 0.f;  // rescale of the carry
  const float lt = warp_sum(p);
  const float lc = tl ? l_run * sc + lt : lt;
  m_run = mc;
  l_run = lc;
  const bool fin = tl == ntile - 1;
  pr[hl * TC + lane] = p;
  __syncwarp();

  // a_c = P U_v for the warp's head, lanes along R (two columns a lane
  // at a time), added to the carry of a walk
  const float* ph = pr + hl * TC;
  float* rh = ra + hl * R;
  for (int q0 = lane; q0 < R; q0 += 64) {
    const int q1 = min(q0 + 32, R - 1);          // a spare lane repeats R-1
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int t = 0; t < TC; ++t) {
      a0 = fmaf(ph[t], uv[t * R + q0], a0);
      a1 = fmaf(ph[t], uv[t * R + q1], a1);
    }
    if (tl) {
      a0 = rh[q0] * sc + a0;
      if (q0 + 32 < R) a1 = rh[q0 + 32] * sc + a1;
    }
    if (!fin) {
      rh[q0] = a0;
      if (q0 + 32 < R) rh[q0 + 32] = a1;
    } else if (mine) {
      float* dst = direct ? a_out + (b * G + g0 + hl) * R : pa + pidx * R;
      dst[q0] = a0;
      if (q0 + 32 < R) dst[q0 + 32] = a1;
    }
  }
  if (fin && mine && lane == 0) {
    if (direct) {
      m_out[b * G + g0 + hl] = mc;
      l_out[b * G + g0 + hl] = lc;
    } else {
      pm[pidx] = mc;
      pl[pidx] = lc;
    }
  }
  }                                              // the block's tiles
  if (direct) return;

  __threadfence();                 // the partial visible device-wide
  __syncthreads();                 // before the ticket is taken
  if (tid == 0) {
    unsigned* tk = tickets + b * ng + grp;
    last = atomicAdd(tk, 1u) == (unsigned)(nact - 1);
    if (last) *tk = 0u;            // every block has arrived
  }
  __syncthreads();
  if (!last) return;

  // the merge, blocks in order.  Each thread's first CCH blocks of a
  // (two outputs a thread) are loaded first, so they are in flight while
  // the warp of each head finds m and each block's scale exp(m_c - m),
  // its lanes along the blocks.
  const size_t base = (b * ng + grp) * nc * GH;  // block 0, head 0
  const float* pc = pa + base * R;               // block k at k * GH * R
  float y[2][CCH];
  auto load = [&](int i0, int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int k = 0; k < CCH; ++k) {
        const int i = i0 + u * NT;
        y[u][k] = i < gn * R && k0 + k < nact
                      ? __ldcg(pc + (size_t)(k0 + k) * GH * R + i)
                      : 0.f;
      }
  };
  load(tid, 0);
  float* sc = sm;                                // [GH][nc]
  float* sl = sc + GH * nc;                      // [GH][nc] l_c scaled
  if (mine) {
    float* sch = sc + hl * nc;
    float* slh = sl + hl * nc;
    float m = kNeg;
    for (int k = lane; k < nact; k += 32) {
      const size_t i = base + (size_t)k * GH + hl;
      sch[k] = __ldcg(pm + i);
      slh[k] = __ldcg(pl + i);
      m = fmaxf(m, sch[k]);
    }
    m = warp_max(m);
    for (int k = lane; k < nact; k += 32) {
      const float e = expf(sch[k] - m);
      sch[k] = e;
      slh[k] *= e;
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int k = 0; k < nact; ++k) l += slh[k];
      m_out[b * G + g0 + hl] = m;
      l_out[b * G + g0 + hl] = l;
    }
  }
  __syncthreads();
  for (int i0 = tid; i0 < gn * R; i0 += 2 * NT) {
    float x[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < nact; k0 += CCH) {
      if (i0 != tid || k0 != 0) load(i0, k0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* sch = sc + min(i0 + u * NT, gn * R - 1) / R * nc + k0;
#pragma unroll
        for (int k = 0; k < CCH; ++k)
          if (k0 + k < nact) x[u] = fmaf(y[u][k], sch[k], x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (i0 + u * NT < gn * R) a_out[(b * G + g0) * R + i0 + u * NT] = x[u];
  }
}

template <typename T, typename Rows, bool VEC>
int launch_vec(const float* inner, const Rows& rows, const int* t_valid,
               float* part, unsigned* tickets, float* a, float* m, float* l,
               int B, int G, int R, int f, void* stream) {
  const int nc = blocks_of(rows.tn, f), ng = (G + GH - 1) / GH;
  if (rows.tn == 0 || B == 0) return 0;
  const size_t smem = smem_bytes(R, nc, f > 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dkv_stats_kernel<T, Rows, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t np = (size_t)B * ng * nc * GH;
  const dim3 grid(nc, ng, B);
  dkv_stats_kernel<T, Rows, VEC><<<grid, NT, smem, (cudaStream_t)stream>>>(
      inner, rows, t_valid, part, part + np * R, part + np * (R + 1),
      tickets, a, m, l, G, R, f);
  return (int)cudaGetLastError();
}

// The 16-byte path when every row starts 16-byte aligned and R columns
// are whole 16-byte vectors.
template <typename T, typename Rows>
int launch(const float* inner, const Rows& rows, const int* t_valid,
           float* part, unsigned* tickets, float* a, float* m, float* l,
           int B, int G, int R, int f, void* stream) {
  const bool vec = (R * sizeof(T)) % 16 == 0 &&
                   (rows.stride * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows.ku) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows.vu) % 16 == 0;
  return vec ? launch_vec<T, Rows, true>(inner, rows, t_valid, part, tickets,
                                         a, m, l, B, G, R, f, stream)
             : launch_vec<T, Rows, false>(inner, rows, t_valid, part,
                                          tickets, a, m, l, B, G, R, f,
                                          stream);
}

template <typename T>
int slab(const float* inner, const void* ku, const void* vu,
         const int* t_valid, float* part, unsigned* tickets, float* a,
         float* m, float* l, int B, int G, int Tn, int R, int f,
         void* stream) {
  const SlabRows<T> rows{static_cast<const T*>(ku),
                         static_cast<const T*>(vu), Tn, R};
  return launch<T>(inner, rows, t_valid, part, tickets, a, m, l, B, G, R, f,
                   stream);
}

template <typename T>
int paged(const float* inner, const void* ku, const void* vu, const int* bt,
          const int* t_valid, float* part, unsigned* tickets, float* a,
          float* m, float* l, int B, int G, int n, int page, int r_pool,
          int R, void* stream) {
  const PagedRows<T> rows{static_cast<const T*>(ku),
                          static_cast<const T*>(vu), bt, n * page, r_pool,
                          page, n};
  return launch<T>(inner, rows, t_valid, part, tickets, a, m, l, B, G, R, 0,
                   stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA at rank R over T rows, at expansion f
// (0: 32-row chunks).
size_t dcom_dkv_smem_bytes(int R, int Tn, int f) {
  return smem_bytes(R, blocks_of(Tn, f), f > 0);
}

// Floats of scratch a launch takes (the blocks' partials) and the ticket
// counters it takes (zeroed; each launch leaves them zeroed).
size_t dcom_dkv_scratch_floats(int B, int G, int Tn, int R, int f) {
  return (size_t)B * ((G + GH - 1) / GH) * blocks_of(Tn, f) * GH * (R + 2);
}
int dcom_dkv_tickets(int B, int G) { return B * ((G + GH - 1) / GH); }

// Return value of every launcher: the cudaError_t of the launch (0 = ok).
// f: the slab kernel's expansion (blocks per slot and head group), 0 for
// 32-row chunks.
int dcom_dkv_stats_f32(const float* inner, const void* ku, const void* vu,
                       const int* t_valid, float* part, unsigned* tickets,
                       float* a, float* m, float* l, int B, int G, int Tn,
                       int R, int f, void* stream) {
  if (f < 0) return (int)cudaErrorInvalidValue;
  return slab<float>(inner, ku, vu, t_valid, part, tickets, a, m, l, B, G,
                     Tn, R, f, stream);
}

int dcom_dkv_stats_bf16(const float* inner, const void* ku, const void* vu,
                        const int* t_valid, float* part, unsigned* tickets,
                        float* a, float* m, float* l, int B, int G, int Tn,
                        int R, int f, void* stream) {
  if (f < 0) return (int)cudaErrorInvalidValue;
  return slab<__nv_bfloat16>(inner, ku, vu, t_valid, part, tickets, a, m, l,
                             B, G, Tn, R, f, stream);
}

// Pools [P, page, r_pool]; bt [B, n] page ids; the first R columns read.
int dcom_dkv_stats_paged_f32(const float* inner, const void* ku,
                             const void* vu, const int* bt,
                             const int* t_valid, float* part,
                             unsigned* tickets, float* a, float* m,
                             float* l, int B, int G, int n, int page,
                             int r_pool, int R, void* stream) {
  return paged<float>(inner, ku, vu, bt, t_valid, part, tickets, a, m, l, B,
                      G, n, page, r_pool, R, stream);
}

int dcom_dkv_stats_paged_bf16(const float* inner, const void* ku,
                              const void* vu, const int* bt,
                              const int* t_valid, float* part,
                              unsigned* tickets, float* a, float* m,
                              float* l, int B, int G, int n, int page,
                              int r_pool, int R, void* stream) {
  return paged<__nv_bfloat16>(inner, ku, vu, bt, t_valid, part, tickets, a,
                              m, l, B, G, n, page, r_pool, R, stream);
}

}  // extern "C"

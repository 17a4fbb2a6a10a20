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
// output directly): matvec writes them to a float32 workspace [B, f, n]
// and a second launch adds them; rmatvec folds that combine into its own
// launch (the last CTA of a column block to arrive adds them).  No
// atomics on the data: reruns at a fixed f are bit-identical, and the
// block-order sum mirrors the reference's accumulation.  Expansion
// engages more CTAs and so more of the card's memory bandwidth; past
// saturation the partials' traffic and the per-CTA cost of ever smaller
// tiles grow with f (the right side of the U).
//
// Memory access.  matvec: a group of L lanes (L a power of two, <= 32)
// walks one row's slice with 16-byte loads along H, then reduces by
// shuffles; a warp covers 32/L rows at a time.  rmatvec: a CTA's bytes
// in flight set its rate, and per-thread loads cannot keep enough in
// flight, so the CTA streams its tile through a three-stage shared-memory
// ring fed by TMA box copies from a producer warp, ~64 KB in flight, and
// its other threads sum the landed stages from shared memory.  Ragged shapes
// are masked, never padded; the 16-byte path is taken when H and the
// block are multiples of the vector width and the pointers are 16-byte
// aligned, else 4/2-byte loads (rmatvec: element copies into the ring).
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

// Partial y over the split [j*split, j*split + split) of H for the rows
// [r0, r0 + rb) of batch element b.  part: [B, f, S].  lpr lanes per row.
template <typename TA, typename TV, int VEC>
__global__ void __launch_bounds__(kThreads)
    matvec_kernel(const TA* __restrict__ a, const TV* __restrict__ v,
                  float* __restrict__ part, int S, int H, int rb, int split,
                  int lpr) {
  const int j = blockIdx.x, f = gridDim.x;
  const size_t b = blockIdx.z;
  const int r0 = blockIdx.y * rb, r1 = min(S, r0 + rb);
  const int c0 = min(H, j * split), c1 = min(H, c0 + split);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int rpw = 32 / lpr, sub = lane / lpr, li = lane % lpr;
  const TA* ab = a + b * S * H;
  const TV* vb = v + b * H;
  float* out = part + (b * f + j) * S;
  // rbase is uniform across the warp, so every lane reaches the shuffles
  for (int rbase = r0 + warp * rpw; rbase < r1; rbase += nw * rpw) {
    const int r = rbase + sub;
    float acc = 0.f;
    if (r < r1) {
      const TA* row = ab + (size_t)r * H;
#pragma unroll 4
      for (int c = c0 + li * VEC; c < c1; c += lpr * VEC) {
        float x[VEC], y[VEC];
        load_vec<TA, VEC>(row + c, x);
        load_vec<TV, VEC>(vb + c, y);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc += x[e] * y[e];
      }
    }
    for (int o = lpr >> 1; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (li == 0 && r < r1) out[r] = acc;
  }
}

// ---------------------------------------------------------------------------
// rmatvec: one pass, the split partials combined by the last CTA to arrive.
// ---------------------------------------------------------------------------

constexpr int kStages = 3;              // ring depth: 2 stages in flight
constexpr int kStageBytes = 32 * 1024;  // bytes of A per ring stage
constexpr int kMaxColBlock = 4096;      // MAX_COL_BLOCK of the wrapper
constexpr int kUChunk = 2048;           // rows of u staged at a time

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
      if (t >= kStages) dcom::mbar_wait(&empty[slot], (t / kStages - 1) & 1);
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

// out[b, i] = sum_{j < f} part[b, j, i], in block order j = 0 .. f-1.
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int f, int n, size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t b = idx / n, i = idx % n;
  const float* p = part + b * f * n + i;
  float s = 0.f;
  for (int j = 0; j < f; ++j) s += p[(size_t)j * n];
  out[idx] = s;
}

template <typename TA, typename TV, int VEC>
int launch_matvec(const void* a, const void* v, float* part, int B, int S,
                  int H, int f, int split, int rb, cudaStream_t st) {
  // lanes per row: enough to cover the split's vectors, at most a warp
  const int nvec = (split + VEC - 1) / VEC;
  int lpr = 1;
  while (lpr < 32 && lpr < nvec) lpr <<= 1;
  const dim3 grid(f, (S + rb - 1) / rb, B);
  matvec_kernel<TA, TV, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const TA*>(a), static_cast<const TV*>(v), part, S, H, rb,
      split, lpr);
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

int combine(const float* part, float* out, int B, int f, int n,
            cudaStream_t st) {
  const size_t total = (size_t)B * n;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  combine_kernel<<<blocks, kThreads, 0, st>>>(part, out, f, n, total);
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

// y[b, s] = sum_h A[b, s, h] v[b, h].  a_dtype / v_dtype: 0 float32, 1 bf16.
// part: float32 [B, f, S] workspace (unused when f == 1).  split: columns
// per CTA (the wrapper's rule); rb: rows per CTA; vec: take the 16-byte
// path.  Returns the cudaError_t of the launches (0 = success).
int dcom_matvec(int a_dtype, int v_dtype, const void* a, const void* v,
                float* part, float* y, int B, int S, int H, int f, int split,
                int rb, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool a_bf16 = a_dtype == kBf16, v_bf16 = v_dtype == kBf16;
  float* dst = f == 1 ? y : part;
  int err;
#define ARGS a, v, dst, B, S, H, f, split, rb, st
  DCOM_MV_DISPATCH(launch_matvec)
#undef ARGS
  if (err || f == 1) return err;
  return combine(part, y, B, f, S, st);
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

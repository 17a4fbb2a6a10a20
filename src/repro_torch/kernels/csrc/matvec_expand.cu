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
// blocks, batch), each CTA reduces its rows x (H/f) (or (S/f) x cols)
// tile in float32 and writes one partial per output element to a float32
// workspace [B, f, n].  A second launch adds the f partials of each
// output in block order j = 0 .. f-1 (f = 1 writes the output directly).
// No atomics: reruns at a fixed f are bit-identical, and the block-order
// sum mirrors the reference's accumulation.  Expansion engages more CTAs
// and so more of the card's memory bandwidth; past saturation the
// partials' traffic, the combine and the per-CTA cost of ever smaller
// tiles grow with f (the right side of the U).
//
// Memory access.  matvec: a group of L lanes (L a power of two, <= 32)
// walks one row's slice with 16-byte loads along H, then reduces by
// shuffles; a warp covers 32/L rows at a time.  rmatvec: threads lie along
// the columns of the block (16-byte loads, coalesced along H) in R row
// groups that walk alternate rows; the R group sums are added in fixed
// order through shared memory.  Ragged shapes are masked, never padded;
// the 16-byte path is taken when H and the split are multiples of the
// vector width and the pointers are 16-byte aligned, else 4/2-byte loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Partial z over the split [j*split, j*split + split) of S for the columns
// [c0, c0 + cb) of batch element b.  part: [B, f, H].  tpr threads along
// the columns (one VEC-wide column vector each per round), kThreads / tpr
// row groups.
template <typename TA, typename TU, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmatvec_kernel(const TA* __restrict__ a, const TU* __restrict__ u,
                   float* __restrict__ part, int S, int H, int cb, int split,
                   int tpr) {
  __shared__ float red[kThreads * VEC];
  const int j = blockIdx.x, f = gridDim.x;
  const size_t b = blockIdx.z;
  const int c0 = blockIdx.y * cb, c1 = min(H, c0 + cb);
  const int s0 = min(S, j * split), s1 = min(S, s0 + split);
  const int rg = kThreads / tpr;
  const int g = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const TA* ab = a + b * S * H;
  const TU* ub = u + b * S;
  float* out = part + (b * f + j) * H;
  const int ncv = (c1 - c0 + VEC - 1) / VEC;
  for (int base = 0; base < ncv; base += tpr) {  // uniform: syncs are safe
    const int cv = base + t;
    const int c = c0 + cv * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (g < rg && cv < ncv) {
#pragma unroll 4
      for (int s = s0 + g; s < s1; s += rg) {
        float x[VEC];
        load_vec<TA, VEC>(ab + (size_t)s * H + c, x);
        const float us = to_f(ub[s]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += x[e] * us;
      }
    }
    if (g < rg) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[(g * tpr + t) * VEC + e] = acc[e];
    }
    __syncthreads();
    if (g == 0 && cv < ncv) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float sum = 0.f;
        for (int q = 0; q < rg; ++q) sum += red[(q * tpr + t) * VEC + e];
        if (c + e < c1) out[c + e] = sum;
      }
    }
    __syncthreads();
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
int launch_rmatvec(const void* a, const void* u, float* part, int B, int S,
                   int H, int f, int split, int cb, cudaStream_t st) {
  const int ncv = (cb + VEC - 1) / VEC;
  const int tpr = ncv < kThreads ? ncv : kThreads;
  const dim3 grid(f, (H + cb - 1) / cb, B);
  rmatvec_kernel<TA, TU, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const TA*>(a), static_cast<const TU*>(u), part, S, H, cb,
      split, tpr);
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

// z[b, h] = sum_s A[b, s, h] u[b, s].  part: float32 [B, f, H]; split:
// rows per CTA; cb: columns per CTA (<= 4096); otherwise as dcom_matvec.
int dcom_rmatvec(int a_dtype, int u_dtype, const void* a, const void* u,
                 float* part, float* z, int B, int S, int H, int f,
                 int split, int cb, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool a_bf16 = a_dtype == kBf16, v_bf16 = u_dtype == kBf16;
  float* dst = f == 1 ? z : part;
  int err;
#define ARGS a, u, dst, B, S, H, f, split, cb, st
  DCOM_MV_DISPATCH(launch_rmatvec)
#undef ARGS
  if (err || f == 1) return err;
  return combine(part, z, B, f, H, st);
}

}  // extern "C"

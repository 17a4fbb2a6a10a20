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
// once (S*H*4 bytes) and the Q buffer three times (N*k*4 each, N = H or S);
// it does ~2 flops per byte, far below the ~20 flop/byte float32 ridge, so
// the floor is (A + Q + vectors) / 3.35 TB/s.
//
// Design: one CTA per batch element.  The TPU kernel walks a sequential
// grid (3 passes x f blocks) carrying z and the Q^T z partials in VMEM
// scratch; here that sequence runs inside one block and the carried state
// lives in shared memory: z (N floats), the input vector, the f per-warp
// partials of Q^T z and the combined p.  The paper's f-way computation
// expansion maps onto the f warps of the block: every reduction over N is
// split into f warp-local partial sums and one small combine in shared
// memory.  A is streamed once, coalesced (threads along H, 16-byte loads
// where H % 4 == 0); Q rows are read by one warp each, lanes along k.
// Ragged shapes are masked, never padded.  With B = 32..128 batch elements
// the grid covers 1/4 to all of the 132 SMs; splitting one element over a
// cluster of CTAs (DSMEM) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KPL = 8;            // Q columns per lane: k <= 32 * KPL
constexpr float kZero = 0.f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Combine the f per-warp partials part[w*k + c] into p[c].
__device__ __forceinline__ void combine(const float* part, float* p, int k,
                                        int nw) {
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = kZero;
    for (int w = 0; w < nw; ++w) s += part[w * k + c];
    p[c] = s;
  }
}

// CGS2 of z (length n, shared memory) against q [n, k] (global, row-major):
//   sweep A: p = Q^T z
//   sweep B: z <- z - Q p ;  p' = Q^T z     (one read of Q)
//   sweep C: z <- z - Q p' ; out = z, norm = |z|^2
// Row j of Q belongs to warp j % f in every sweep, so z[j] has one owner.
__device__ void cgs2(float* z, const float* __restrict__ q, int n, int k,
                     float* part, float* p, float* red,
                     float* __restrict__ out, float* __restrict__ nrm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float acc[KPL];

  // sweep A
#pragma unroll
  for (int i = 0; i < KPL; ++i) acc[i] = kZero;
  for (int j = warp; j < n; j += nw) {
    const float zj = z[j];
    const float* qr = q + (size_t)j * k;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int c = lane + 32 * i;
      if (c < k) acc[i] += qr[c] * zj;
    }
  }
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int c = lane + 32 * i;
    if (c < k) part[warp * k + c] = acc[i];
  }
  __syncthreads();
  combine(part, p, k, nw);
  __syncthreads();

  // sweep B
#pragma unroll
  for (int i = 0; i < KPL; ++i) acc[i] = kZero;
  for (int j = warp; j < n; j += nw) {
    const float* qr = q + (size_t)j * k;
    float qv[KPL];
    float d = kZero;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int c = lane + 32 * i;
      qv[i] = c < k ? qr[c] : kZero;
      d += c < k ? qv[i] * p[c] : kZero;
    }
    const float zj = z[j] - warp_sum(d);
    if (lane == 0) z[j] = zj;
#pragma unroll
    for (int i = 0; i < KPL; ++i) acc[i] += qv[i] * zj;
  }
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int c = lane + 32 * i;
    if (c < k) part[warp * k + c] = acc[i];
  }
  __syncthreads();
  combine(part, p, k, nw);
  __syncthreads();

  // sweep C
  float sq = kZero;
  for (int j = warp; j < n; j += nw) {
    const float* qr = q + (size_t)j * k;
    float d = kZero;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int c = lane + 32 * i;
      if (c < k) d += qr[c] * p[c];
    }
    const float zj = z[j] - warp_sum(d);
    if (lane == 0) {
      out[j] = zj;
      sq += zj * zj;
    }
  }
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = kZero;
    for (int w = 0; w < nw; ++w) s += red[w];
    *nrm = s;
  }
}

// z_b = CGS2(A_b^T u_b, V_b).  Shared: z [H], u [S], part [f*k], p [k],
// red [32].
__global__ void __launch_bounds__(1024) reorth_right_kernel(const float* __restrict__ a,
                                    const float* __restrict__ u,
                                    const float* __restrict__ q,
                                    float* __restrict__ z_out,
                                    float* __restrict__ nrm_out,
                                    int S, int H, int k) {
  extern __shared__ float sm[];
  const int nw = blockDim.x >> 5;
  float* z = sm;
  float* us = z + H;
  float* part = us + S;
  float* p = part + nw * k;
  float* red = p + k;
  const size_t b = blockIdx.x;
  a += b * S * H;
  u += b * S;
  q += b * H * k;

  for (int s = threadIdx.x; s < S; s += blockDim.x) us[s] = u[s];
  __syncthreads();

  // pass 0: z = A^T u, threads along H, rows streamed 4 at a time
  if ((H & 3) == 0 && ((uintptr_t)a & 15) == 0) {
    const int H4 = H >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    for (int c4 = threadIdx.x; c4 < H4; c4 += blockDim.x) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      int s = 0;
      for (; s + 4 <= S; s += 4) {
        const float4 x0 = a4[(size_t)(s + 0) * H4 + c4];
        const float4 x1 = a4[(size_t)(s + 1) * H4 + c4];
        const float4 x2 = a4[(size_t)(s + 2) * H4 + c4];
        const float4 x3 = a4[(size_t)(s + 3) * H4 + c4];
        const float u0 = us[s], u1 = us[s + 1], u2 = us[s + 2],
                    u3 = us[s + 3];
        acc.x += x0.x * u0 + x1.x * u1 + x2.x * u2 + x3.x * u3;
        acc.y += x0.y * u0 + x1.y * u1 + x2.y * u2 + x3.y * u3;
        acc.z += x0.z * u0 + x1.z * u1 + x2.z * u2 + x3.z * u3;
        acc.w += x0.w * u0 + x1.w * u1 + x2.w * u2 + x3.w * u3;
      }
      for (; s < S; ++s) {
        const float4 x = a4[(size_t)s * H4 + c4];
        const float us_ = us[s];
        acc.x += x.x * us_;
        acc.y += x.y * us_;
        acc.z += x.z * us_;
        acc.w += x.w * us_;
      }
      z[4 * c4 + 0] = acc.x;
      z[4 * c4 + 1] = acc.y;
      z[4 * c4 + 2] = acc.z;
      z[4 * c4 + 3] = acc.w;
    }
  } else {
    for (int c = threadIdx.x; c < H; c += blockDim.x) {
      float acc = kZero;
      for (int s = 0; s < S; ++s) acc += a[(size_t)s * H + c] * us[s];
      z[c] = acc;
    }
  }
  __syncthreads();
  cgs2(z, q, H, k, part, p, red, z_out + b * H, nrm_out + b);
}

// w_b = CGS2(A_b v_b, U_b).  Shared: v [H], w [S], part [f*k], p [k],
// red [32].
__global__ void __launch_bounds__(1024) reorth_left_kernel(const float* __restrict__ a,
                                   const float* __restrict__ v,
                                   const float* __restrict__ q,
                                   float* __restrict__ w_out,
                                   float* __restrict__ nrm_out,
                                   int S, int H, int k) {
  extern __shared__ float sm[];
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* vs = sm;
  float* w = vs + H;
  float* part = w + S;
  float* p = part + nw * k;
  float* red = p + k;
  const size_t b = blockIdx.x;
  a += b * S * H;
  v += b * H;
  q += b * S * k;

  for (int c = threadIdx.x; c < H; c += blockDim.x) vs[c] = v[c];
  __syncthreads();

  // pass 0: w_s = A[s,:] . v, one warp per row, lanes along H
  const bool vec = (H & 3) == 0 && ((uintptr_t)a & 15) == 0;
  for (int s = warp; s < S; s += nw) {
    const float* row = a + (size_t)s * H;
    float d = kZero;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const int H4 = H >> 2;
#pragma unroll 4
      for (int c4 = lane; c4 < H4; c4 += 32) {
        const float4 x = row4[c4];
        d += x.x * vs[4 * c4] + x.y * vs[4 * c4 + 1] +
             x.z * vs[4 * c4 + 2] + x.w * vs[4 * c4 + 3];
      }
    } else {
      for (int c = lane; c < H; c += 32) d += row[c] * vs[c];
    }
    d = warp_sum(d);
    if (lane == 0) w[s] = d;
  }
  __syncthreads();
  cgs2(w, q, S, k, part, p, red, w_out + b * S, nrm_out + b);
}

size_t smem_bytes(int n_vec, int n_out, int k, int warps) {
  return sizeof(float) * ((size_t)n_vec + n_out + (size_t)warps * k + k + 32);
}

int launch(void (*kern)(const float*, const float*, const float*, float*,
                        float*, int, int, int),
           const float* a, const float* x, const float* q, float* out,
           float* nrm, int B, int S, int H, int k, int warps, size_t smem,
           void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B, warps * 32, smem, (cudaStream_t)stream>>>(a, x, q, out, nrm, S,
                                                       H, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks the 227 KB limit).
size_t dcom_reorth_smem_bytes(int S, int H, int k, int warps) {
  return smem_bytes(H, S, k, warps);
}

int dcom_reorth_max_k() { return 32 * KPL; }

// Return value: the cudaError_t of the launch (0 = success).
int dcom_reorth_right_f32(const float* a, const float* u, const float* q,
                          float* z, float* nrm, int B, int S, int H, int k,
                          int warps, void* stream) {
  return launch(reorth_right_kernel, a, u, q, z, nrm, B, S, H, k, warps,
                smem_bytes(H, S, k, warps), stream);
}

int dcom_reorth_left_f32(const float* a, const float* v, const float* q,
                         float* w, float* nrm, int B, int S, int H, int k,
                         int warps, void* stream) {
  return launch(reorth_left_kernel, a, v, q, w, nrm, B, S, H, k, warps,
                smem_bytes(H, S, k, warps), stream);
}

}  // extern "C"

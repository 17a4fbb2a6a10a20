// Rank-space flash-decoding statistics for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/dkv_attention.py:
//   dkv_attention_stats (:90, body _dkv_kernel :39)
// For every slot b and query head g (all heads of the slot at once):
//   s_t  = inner[b,g,:] . U_k[b,t,:]                     (t < T)
//   rows t >= t_valid[b] are masked exactly: score -1e30, probability 0
//   m    = max_t s_t,  l = sum_t exp(s_t - m),  a = sum_t exp(s_t - m) U_v[b,t,:]
// inner [B,G,R] float32 (already scaled by hd^-0.5); U_k, U_v [B,T,R] in
// float32 or bf16; t_valid [B] int32 (per slot: serving's frozen_len; the
// Pallas kernel takes one static int).  Outputs a [B,G,R], m, l [B,G]
// float32.  The exact dense-tail merge stays outside (merge_with_tail).
//
// What bounds it on the H100: one decode step reads each slot's U_k and
// U_v rows below t_valid once (4*R bytes per row in bf16) and does 4*G*R
// flops per row, G flops per byte.  Against the tensor cores' bf16 rate
// (ridge ~295 flop/byte) that is bytes-bound: the floor is the U bytes
// over 3.35 TB/s.  This first kernel does its products on the FMA units
// (67 TFLOP/s float32, ridge ~20 flop/byte), where G = 32 heads makes it
// operation-limited; moving the two products onto mma is later work.
//
// Design: one CTA per slot.  U is shared by every head of the slot, so the
// CTA reads each U row once for all G query rows, instead of once per
// (slot, kv-head) as the Pallas grid does.  The time axis is walked in
// tiles of 32 rows staged (as float32) in shared memory; one warp per head
// updates the online-softmax state (m, l) for a tile with shuffles (one
// row per lane), and the rank-space accumulator a [G,R] stays in shared
// memory across tiles.  Tiles at or past t_valid are skipped: they would
// add probability 0 and leave the running max unchanged, so skipping them
// is exact.  With a handful of slots the grid covers few SMs; splitting the
// time axis over CTAs with a combine is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;            // time rows per tile (one per lane)
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

// Shared layout (floats): inner [G*R] | acc [G*R] | uk [TT*(R+1)] |
// uv [TT*R] | pr [G*TT] | m [G] | l [G] | corr [G].  uk rows are padded by
// one float so the score loop (lanes along t) hits distinct banks.
template <typename T>
__global__ void __launch_bounds__(512)
dkv_stats_kernel(const float* __restrict__ inner, const T* __restrict__ ku,
                 const T* __restrict__ vu, const int* __restrict__ t_valid,
                 float* __restrict__ a_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int G, int Tn, int R) {
  extern __shared__ float sm[];
  float* inn = sm;
  float* acc = inn + G * R;
  float* uk = acc + G * R;
  float* uv = uk + TT * (R + 1);
  float* pr = uv + TT * R;
  float* mrow = pr + G * TT;
  float* lrow = mrow + G;
  float* crow = lrow + G;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t b = blockIdx.x;
  const int tv = min(max(t_valid[b], 0), Tn);
  inner += b * G * R;
  ku += b * Tn * R;
  vu += b * Tn * R;

  for (int i = threadIdx.x; i < G * R; i += blockDim.x) {
    inn[i] = inner[i];
    acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    mrow[g] = kNeg;
    lrow[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < tv; t0 += TT) {
    // stage the U_k / U_v tile as float32 (rows past t_valid as zeros)
    for (int i = threadIdx.x; i < TT * R; i += blockDim.x) {
      const int t = i / R, c = i - t * R;
      const int row = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (row < tv) {
        kx = to_f32(ku[(size_t)row * R + c]);
        vx = to_f32(vu[(size_t)row * R + c]);
      }
      uk[t * (R + 1) + c] = kx;
      uv[t * R + c] = vx;
    }
    __syncthreads();
    // scores of the tile for every head
    for (int i = threadIdx.x; i < G * TT; i += blockDim.x) {
      const int g = i / TT, t = i - g * TT;
      const float* iq = inn + g * R;
      const float* kr = uk + t * (R + 1);
      float s = 0.f;
      for (int c = 0; c < R; ++c) s += iq[c] * kr[c];
      pr[i] = (t0 + t < tv) ? s : kNeg;
    }
    __syncthreads();
    // online softmax: one warp per head, one tile row per lane
    for (int g = warp; g < G; g += nw) {
      const float s = pr[g * TT + lane];
      const bool valid = t0 + lane < tv;
      const float m_old = mrow[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      pr[g * TT + lane] = p;
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        crow[g] = c;
        lrow[g] = lrow[g] * c + psum;
        mrow[g] = m_new;
      }
    }
    __syncthreads();
    // a <- a * c + P U_v
    for (int i = threadIdx.x; i < G * R; i += blockDim.x) {
      const int g = i / R, c = i - g * R;
      const float* pg = pr + g * TT;
      float s = acc[i] * crow[g];
#pragma unroll 8
      for (int t = 0; t < TT; ++t) s += pg[t] * uv[t * R + c];
      acc[i] = s;
    }
    __syncthreads();
  }

  a_out += b * G * R;
  for (int i = threadIdx.x; i < G * R; i += blockDim.x) a_out[i] = acc[i];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_out[b * G + g] = mrow[g];
    l_out[b * G + g] = lrow[g];
  }
}

size_t smem_bytes(int G, int R) {
  return sizeof(float) * (2 * (size_t)G * R + (size_t)TT * (R + 1) +
                          (size_t)TT * R + (size_t)G * TT + 3 * (size_t)G);
}

template <typename T>
int launch(const float* inner, const T* ku, const T* vu, const int* t_valid,
           float* a, float* m, float* l, int B, int G, int Tn, int R,
           void* stream) {
  const size_t smem = smem_bytes(G, R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dkv_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dkv_stats_kernel<T><<<B, 512, smem, (cudaStream_t)stream>>>(
      inner, ku, vu, t_valid, a, m, l, G, Tn, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t dcom_dkv_smem_bytes(int G, int R) { return smem_bytes(G, R); }

// Return value: the cudaError_t of the launch (0 = success).
int dcom_dkv_stats_f32(const float* inner, const float* ku, const float* vu,
                       const int* t_valid, float* a, float* m, float* l,
                       int B, int G, int Tn, int R, void* stream) {
  return launch<float>(inner, ku, vu, t_valid, a, m, l, B, G, Tn, R, stream);
}

int dcom_dkv_stats_bf16(const float* inner, const void* ku, const void* vu,
                        const int* t_valid, float* a, float* m, float* l,
                        int B, int G, int Tn, int R, void* stream) {
  return launch<__nv_bfloat16>(
      inner, static_cast<const __nv_bfloat16*>(ku),
      static_cast<const __nv_bfloat16*>(vu), t_valid, a, m, l, B, G, Tn, R,
      stream);
}

}  // extern "C"

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
// Design (simple and correct first): one CTA of 256 threads for each
// (chunk, block of hb heads).  For each head of its block, the CTA walks
// the 64 x 64 tile pairs (query tile i, key tile j), j <= i: the x rows of
// key tile j and the dy rows of query tile i are staged in shared memory,
// each thread computes a 4 x 4 block of G by FMAs over hd, then the masked
// E, M, G M and G cb E of its block (exp evaluated only under the mask
// s <= q, so the exponent never overflows above the diagonal).  dx of the
// key tile accumulates in registers over the query tiles; dl and ddt
// accumulate in shared memory by fixed-order row and column sums.
//   dcb sums over the heads, which live in different CTAs.  Each CTA
// writes its block's partial sum (heads in order) into a workspace
// [G, nhb, Q, Q]; a second kernel of the same call sums the nhb partials
// in order.  No float atomics: the result does not depend on which CTA
// runs first, so reruns are bit-identical.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // query rows / key columns of a tile
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTP = kT + 1;       // padded tile row (floats)
constexpr int kMaxHD = 128;       // 8 columns of hd per thread at most
constexpr int kSmemLimit = 232448;

struct Args {
  const float* cb;
  const float* l;
  const float* dt;
  const float* x;
  const float* dy;
  float* dx;
  float* dl;
  float* ddt;
  float* work;                    // [G, nhb, Q, Q] partial dcb
  int G, Q, NH, HD, hb, nhb;
};

size_t smem_bytes(int Q, int HD) {
  return sizeof(float) *
         ((size_t)2 * kT * (HD + 1) + (size_t)3 * kT * kTP + 3 * (size_t)Q +
          kT);
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_intra_bwd_kernel(Args a) {
  extern __shared__ float sm[];
  const int Q = a.Q, NH = a.NH, HD = a.HD;
  const int hdp = HD + 1;
  float* xs = sm;                   // [kT][hdp] x of the key tile
  float* dys = xs + kT * hdp;       // [kT][hdp] dy of the query tile
  float* mt = dys + kT * hdp;       // [kT][kTP] M
  float* gmt = mt + kT * kTP;       // [kT][kTP] G M
  float* ct = gmt + kT * kTP;       // [kT][kTP] G cb E
  float* lrow = ct + kT * kTP;      // [Q] l of the head
  float* dtrow = lrow + Q;          // [Q] dt of the head
  float* dlacc = dtrow + Q;         // [Q] dl of the head
  float* ddtacc = dlacc + Q;        // [kT] ddt of the key tile

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int g = blockIdx.x, hbi = blockIdx.y;
  const int nt = (Q + kT - 1) / kT;
  const int nd = (HD + 15) / 16;    // hd columns a thread owns
  const float* cbg = a.cb + (size_t)g * Q * Q;
  float* wg = a.work + ((size_t)g * a.nhb + hbi) * Q * Q;

  for (int k = 0; k < a.hb; ++k) {
    const int n = hbi * a.hb + k;
    if (n >= NH) break;
    for (int t = tid; t < Q; t += kThreads) {
      lrow[t] = a.l[((size_t)g * Q + t) * NH + n];
      dtrow[t] = a.dt[((size_t)g * Q + t) * NH + n];
      dlacc[t] = 0.f;
    }
    for (int j = 0; j < nt; ++j) {
      const int s0 = j * kT;
      __syncthreads();              // earlier readers of xs are done
      for (int e = tid; e < kT * HD; e += kThreads) {
        const int b = e / HD, d = e - b * HD;
        const int s = s0 + b;
        xs[b * hdp + d] =
            s < Q ? a.x[(((size_t)g * Q + s) * NH + n) * HD + d] : 0.f;
      }
      if (tid < kT) ddtacc[tid] = 0.f;
      float acc[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

      for (int i = j; i < nt; ++i) {
        const int q0 = i * kT;
        __syncthreads();            // earlier readers of dys/mt/gmt/ct done
        for (int e = tid; e < kT * HD; e += kThreads) {
          const int r = e / HD, d = e - r * HD;
          const int q = q0 + r;
          dys[r * hdp + d] =
              q < Q ? a.dy[(((size_t)g * Q + q) * NH + n) * HD + d] : 0.f;
        }
        __syncthreads();
        // G = dy_i x_j^T, 4 x 4 per thread (rows ty + 16 r, cols tx + 16 c)
        float gv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) gv[r][c] = 0.f;
        for (int d = 0; d < HD; ++d) {
          float dv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) dv[r] = dys[(ty + 16 * r) * hdp + d];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = xs[(tx + 16 * c) * hdp + d];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) gv[r][c] = fmaf(dv[r], xv[c], gv[r][c]);
        }
        // the masked terms; the partial dcb of the block, heads in order
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ar = ty + 16 * r, bc = tx + 16 * c;
            const int q = q0 + ar, s = s0 + bc;
            float m = 0.f, p = 0.f, cterm = 0.f;
            if (q < Q && s <= q) {
              const float e = expf(lrow[q] - lrow[s]);
              const float cbv = cbg[(size_t)q * Q + s];
              const float gq = gv[r][c];
              m = (cbv * e) * dtrow[s];
              p = gq * m;
              cterm = (gq * cbv) * e;
              const float dc = (gq * e) * dtrow[s];
              float* w = wg + (size_t)q * Q + s;
              *w = k == 0 ? dc : *w + dc;
            }
            mt[ar * kTP + bc] = m;
            gmt[ar * kTP + bc] = p;
            ct[ar * kTP + bc] = cterm;
          }
        }
        __syncthreads();
        // dx of the key tile += M^T dy_i (rows ty + 16 r, cols tx + 16 c)
        for (int q = 0; q < kT; ++q) {
          float mv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = mt[q * kTP + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (c < nd) {
              const int d = tx + 16 * c;
              const float dv = d < HD ? dys[q * hdp + d] : 0.f;
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(mv[r], dv, acc[r][c]);
            }
          }
        }
        // dl of the queries (row sums of G M), ddt of the keys (column
        // sums of G cb E)
        if (tid < kT) {
          float sum = 0.f;
          for (int b = 0; b < kT; ++b) sum += gmt[tid * kTP + b];
          if (q0 + tid < Q) dlacc[q0 + tid] += sum;
        } else if (tid >= 2 * kT && tid < 3 * kT) {
          const int b = tid - 2 * kT;
          float sum = 0.f;
          for (int q = 0; q < kT; ++q) sum += ct[q * kTP + b];
          ddtacc[b] += sum;
        }
        __syncthreads();
        // dl of the keys (minus the column sums of G M)
        if (tid >= kT && tid < 2 * kT) {
          const int b = tid - kT;
          float sum = 0.f;
          for (int q = 0; q < kT; ++q) sum += gmt[q * kTP + b];
          if (s0 + b < Q) dlacc[s0 + b] -= sum;
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = s0 + ty + 16 * r;
        if (s >= Q) continue;
        float* out = a.dx + (((size_t)g * Q + s) * NH + n) * HD;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int d = tx + 16 * c;
          if (c < nd && d < HD) out[d] = acc[r][c];
        }
      }
      if (tid < kT && s0 + tid < Q)
        a.ddt[((size_t)g * Q + s0 + tid) * NH + n] = ddtacc[tid];
    }
    __syncthreads();
    for (int t = tid; t < Q; t += kThreads)
      a.dl[((size_t)g * Q + t) * NH + n] = dlacc[t];
  }
}

// dcb[g, q, s] = sum over the head blocks of the partials, in block order
// (0 above the diagonal).
__global__ void ssd_dcb_reduce_kernel(const float* __restrict__ work,
                                      float* __restrict__ dcb, int G, int Q,
                                      int nhb) {
  const size_t qq = (size_t)Q * Q;
  const size_t total = (size_t)G * qq;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t g = e / qq, rest = e - g * qq;
    const int q = (int)(rest / Q), s = (int)(rest - (size_t)q * Q);
    float v = 0.f;
    if (s <= q) {
      const float* w = work + g * nhb * qq + rest;
      for (int h = 0; h < nhb; ++h) v += w[(size_t)h * qq];
    }
    dcb[e] = v;
  }
}

}  // namespace

extern "C" {

// Most float32 hd columns the kernel takes.
int dcom_ssd_bwd_max_hd() { return kMaxHD; }

// cb [G, Q, Q], l/dt [G, Q, NH], x/dy [G, Q, NH, HD] (contiguous float32
// on the current device) -> dcb [G, Q, Q], dl/ddt [G, Q, NH], dx
// [G, Q, NH, HD]; hb heads a CTA; work: G * ceil(NH / hb) * Q * Q floats
// of scratch.  Two kernels on `stream`.  Return value: the cudaError_t of
// the launches (0 = success).
int dcom_ssd_chunk_intra_bwd_f32(const float* cb, const float* l,
                                 const float* dt, const float* x,
                                 const float* dy, float* dcb, float* dl,
                                 float* ddt, float* dx, float* work, int G,
                                 int Q, int NH, int HD, int hb, void* stream) {
  if (G <= 0 || Q <= 0 || NH <= 0 || HD <= 0) return 0;
  const int nhb = (NH + hb - 1) / hb;
  const size_t smem = smem_bytes(Q, HD);
  if (hb < 1 || HD > kMaxHD || nhb > 65535 ||
      smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_intra_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  Args a{cb, l, dt, x, dy, dx, dl, ddt, work, G, Q, NH, HD, hb, nhb};
  ssd_chunk_intra_bwd_kernel<<<dim3(G, nhb), kThreads, smem,
                               (cudaStream_t)stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)G * Q * Q;
  size_t blocks = (total + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  ssd_dcb_reduce_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      work, dcb, G, Q, nhb);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// Design: one CTA per (g, head, 64-column slice of hd, 64-row query
// tile).  The TPU kernel keeps one [Q, Q] tile per head in VMEM, but Q is
// not bounded by the chunk length (the model takes the whole sequence as
// one chunk when 64 does not divide it), so a [Q, Q] tile does not fit in
// shared memory; instead the CTA walks the key tiles up to the diagonal:
//   1. stage l_s, dt_s and the x tile [64 keys, 64 columns] in smem;
//   2. build the masked decay tile M [64 rows, 64 keys] in smem, reading
//      cb straight from memory (coalesced along s), and evaluating
//      exp(l_q - l_s) ONLY under the mask s <= q: above the diagonal
//      l_q - l_s > 0 and the exponent can overflow, so M is set to 0 there
//      without multiplying (the reference selects 0 with `where`);
//   3. y tile += M @ x tile, each of the 256 threads holding a 4 x 4 block
//      of the 64 x 64 output in float32 registers.
// The products follow the reference's order, (cb * decay) * dt, with
// accurate expf (no fast math).  Simple and correct first: wgmma/TMA are
// later work.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // query rows per CTA
constexpr int kKeys = 64;                 // key rows per staged tile
constexpr int kCols = 64;                 // output columns per CTA
constexpr int kThreads = 256;
constexpr int kTx = 16;                   // threads along the columns
constexpr int kTy = kThreads / kTx;       // threads along the rows
constexpr int kRpt = kRows / kTy;         // rows per thread (4)
constexpr int kCpt = kCols / kTx;         // columns per thread (4)

__global__ void __launch_bounds__(kThreads)
ssd_chunk_intra_kernel(const float* __restrict__ cb,
                       const float* __restrict__ l,
                       const float* __restrict__ dt,
                       const float* __restrict__ x, float* __restrict__ y,
                       int Q, int NH, int HD, int qtiles, int ctiles) {
  __shared__ float m_s[kRows][kKeys + 1];
  __shared__ float x_s[kKeys][kCols];
  __shared__ float lq_s[kRows];
  __shared__ float ls_s[kKeys];
  __shared__ float dts_s[kKeys];

  int bid = blockIdx.x;
  const int qt = bid % qtiles;
  bid /= qtiles;
  const int ct = bid % ctiles;
  bid /= ctiles;
  const int n = bid % NH;
  const int g = bid / NH;
  const int q0 = qt * kRows, c0 = ct * kCols;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;

  const float* cbg = cb + (size_t)g * Q * Q;
  const float* lg = l + (size_t)g * Q * NH + n;       // stride NH per row
  const float* dtg = dt + (size_t)g * Q * NH + n;
  const size_t xrow = (size_t)NH * HD;                // x/y row stride
  const float* xg = x + (size_t)g * Q * xrow + (size_t)n * HD + c0;
  float* yg = y + (size_t)g * Q * xrow + (size_t)n * HD + c0;

  if (tid < kRows) {
    const int q = q0 + tid;
    lq_s[tid] = q < Q ? lg[(size_t)q * NH] : 0.f;
  }
  float acc[kRpt][kCpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
#pragma unroll
    for (int j = 0; j < kCpt; ++j) acc[i][j] = 0.f;

  const int q_last = min(Q, q0 + kRows) - 1;          // last row of the tile
  for (int s0 = 0; s0 <= q_last; s0 += kKeys) {
    __syncthreads();                  // the previous tile is consumed
    if (tid < kKeys) {
      const int s = s0 + tid;
      ls_s[tid] = s < Q ? lg[(size_t)s * NH] : 0.f;
      dts_s[tid] = s < Q ? dtg[(size_t)s * NH] : 0.f;
    }
    for (int i = tid; i < kKeys * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const int s = s0 + r;
      x_s[r][c] = (s < Q && c0 + c < HD) ? xg[(size_t)s * xrow + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, k = i % kKeys;
      const int q = q0 + r, s = s0 + k;
      float m = 0.f;
      if (s <= q && q < Q)            // s <= q < Q, so s < Q as well
        m = cbg[(size_t)q * Q + s] * expf(lq_s[r] - ls_s[k]) * dts_s[k];
      m_s[r][k] = m;
    }
    __syncthreads();
    const int kend = min(kKeys, q_last - s0 + 1);     // later keys give 0
#pragma unroll 4
    for (int k = 0; k < kend; ++k) {
      float xv[kCpt];
#pragma unroll
      for (int j = 0; j < kCpt; ++j) xv[j] = x_s[k][tx + j * kTx];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const float m = m_s[ty + i * kTy][k];
#pragma unroll
        for (int j = 0; j < kCpt; ++j) acc[i][j] = fmaf(m, xv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int q = q0 + ty + i * kTy;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < kCpt; ++j) {
      const int c = tx + j * kTx;
      if (c0 + c < HD) yg[(size_t)q * xrow + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Every pointer is a contiguous float32 tensor on the current device.
// Return value: the cudaError_t of the launch (0 = success).
int dcom_ssd_chunk_intra_f32(const float* cb, const float* l, const float* dt,
                             const float* x, float* y, int G, int Q, int NH,
                             int HD, void* stream) {
  const int qtiles = (Q + kRows - 1) / kRows;
  const int ctiles = (HD + kCols - 1) / kCols;
  const long long blocks = (long long)G * NH * ctiles * qtiles;
  if (blocks <= 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_intra_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(cb, l, dt, x, y, Q, NH, HD,
                                                   qtiles, ctiles);
  return (int)cudaGetLastError();
}

}  // extern "C"

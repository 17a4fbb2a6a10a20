// Preserved-compute GEMM out[M, N] = Vt[M, H] @ W[H, N] (paper Eq. 6) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/lowrank_matmul.py:
//   lowrank_matmul (:59, body _lr_matmul_kernel :36)
//     Vt [k, H] @ W [H, N] -> float32 [k, N], the H reduction split f ways
// here with the batch of Vt flattened into M = B*k rows.  Inputs are both
// bfloat16 (the main path) or both float32; accumulation is float32 and
// the output is written once, rounded to the inputs' type (what the
// einsum at src/repro/core/preserved.py:143 returns).
//
// What bounds it on the H100: bytes.  The left operand is skinny (M = 20
// on the main path), so every byte of W read from device memory meets
// only ~M multiply-adds: W is read once and the arithmetic intensity is
// about M FLOP/byte, far below the bf16 ridge (~295 FLOP/byte).  The floor
// is |W| / 3.35 TB/s (10 us for a 4096 x 4096 bf16 W).
//
// Design: CTAs over (N tile, H split, M chunk).  128 threads each own two
// adjacent columns of W (one 4-byte bf16 pair or 8-byte float pair per
// row, so a warp reads 128 contiguous bytes of a row) and accumulate the
// M-chunk's outputs of those columns in registers.  The CTA's H slice of
// Vt is staged once in shared memory as float32, transposed to [h][m], so
// one broadcast 16-byte shared load feeds eight multiply-adds.  Rows of W
// are loaded eight at a time before they are used, to keep loads in
// flight.  The H split is the paper's f-way expansion (the TPU kernel's
// second grid axis); f is chosen so the grid holds about two CTAs per SM.
// Each split writes its float32 partial [M, N] to a scratch buffer and a
// second small pass adds the f partials in split order and rounds once to
// the output type: no float atomics, so two runs give bit-identical
// results.  With f == 1 the one pass writes the output itself.  Ragged M
// (zero rows in shared memory), H (slice bounds) and N (masked scalar
// loads) are masked, never padded.
// The products run on the CUDA cores in float32; moving them onto the
// tensor cores (mma/wgmma with TMA-fed W tiles) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 2;                      // columns of W per thread
constexpr int kTileN = kThreads * kCols;      // columns per CTA
constexpr int kMaxMT = 32;                    // output rows per CTA
constexpr int kBatch = 8;                     // W rows loaded ahead
constexpr size_t kSmemCap = 48 * 1024;        // static-launch limit

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);                // as torch's .to(bfloat16)
}

// Columns n, n+1 of row `row` (masked at N).
__device__ __forceinline__ float2 load2(const float* row, int n, int N,
                                        bool vec) {
  if (vec) return *reinterpret_cast<const float2*>(row + n);
  return make_float2(row[n], n + 1 < N ? row[n + 1] : 0.f);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* row, int n,
                                        int N, bool vec) {
  if (vec)
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + n));
  return make_float2(__bfloat162float(row[n]),
                     n + 1 < N ? __bfloat162float(row[n + 1]) : 0.f);
}

template <int MT>
__device__ __forceinline__ void fma_row(float (&acc)[MT][kCols],
                                        const float4* vrow, float2 w) {
#pragma unroll
  for (int q = 0; q < MT / 4; ++q) {
    const float4 v = vrow[q];
    acc[4 * q + 0][0] += v.x * w.x;
    acc[4 * q + 0][1] += v.x * w.y;
    acc[4 * q + 1][0] += v.y * w.x;
    acc[4 * q + 1][1] += v.y * w.y;
    acc[4 * q + 2][0] += v.z * w.x;
    acc[4 * q + 2][1] += v.z * w.y;
    acc[4 * q + 3][0] += v.w * w.x;
    acc[4 * q + 3][1] += v.w * w.y;
  }
}

// part[split, m, n] = sum over h in this CTA's H slice of Vt[m, h] W[h, n];
// O is float for partials, or the output type when there is one split.
template <typename T, typename O, int MT>
__global__ void __launch_bounds__(kThreads)
lrmm_kernel(const T* __restrict__ vt, const T* __restrict__ w,
            O* __restrict__ part, int M, int H, int N, int hs) {
  extern __shared__ float4 vs4[];             // [hs][MT] floats
  float* vs = reinterpret_cast<float*>(vs4);
  const int m0 = blockIdx.z * MT;
  const int h0 = blockIdx.y * hs;
  const int len = min(H, h0 + hs) - h0;

  for (int i = threadIdx.x; i < MT * len; i += kThreads) {
    const int m = i / len, h = i - m * len;
    vs[h * MT + m] =
        m0 + m < M ? to_f(vt[(size_t)(m0 + m) * H + h0 + h]) : 0.f;
  }
  __syncthreads();

  const int n = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (n >= N) return;
  const bool vec = (N % kCols) == 0 &&
                   ((uintptr_t)w % (kCols * sizeof(T))) == 0;
  const T* wp = w + (size_t)h0 * N;

  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = 0.f;

  int h = 0;
  for (; h + kBatch <= len; h += kBatch) {
    float2 wr[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      wr[j] = load2(wp + (size_t)(h + j) * N, n, N, vec);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      fma_row<MT>(acc, vs4 + (h + j) * (MT / 4), wr[j]);
  }
  for (; h < len; ++h)
    fma_row<MT>(acc, vs4 + h * (MT / 4), load2(wp + (size_t)h * N, n, N,
                                               vec));

  O* out = part + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m < M) {
      O* o = out + (size_t)(m0 + m) * N + n;
      store(o, acc[m][0]);
      if (n + 1 < N) store(o + 1, acc[m][1]);
    }
  }
}

// out[i] = sum_{j < f} part[j, i], in split order, rounded once to O.
template <typename O>
__global__ void lrmm_combine(const float* __restrict__ part,
                             O* __restrict__ out, size_t count, int f) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < f; ++j) s += part[(size_t)j * count + i];
    store(out + i, s);
  }
}

struct Plan {
  int mt, chunks, tiles, f, hs;
};

Plan plan(int M, int H, int N, int sms) {
  Plan p;
  p.mt = M >= kMaxMT ? kMaxMT : ((M + 7) / 8) * 8;
  p.chunks = (M + p.mt - 1) / p.mt;
  p.tiles = (N + kTileN - 1) / kTileN;
  const long ctas = (long)p.chunks * p.tiles;
  long f = (2L * sms + ctas - 1) / ctas;
  const long f_max = (H + 63) / 64;            // at least 64 rows a split
  if (f > f_max) f = f_max;
  if (f < 1) f = 1;
  int hs = (int)((H + f - 1) / f);
  const int hs_max = (int)(kSmemCap / (sizeof(float) * p.mt));
  if (hs > hs_max) hs = hs_max;
  p.hs = hs;
  p.f = (H + hs - 1) / hs;
  return p;
}

template <typename T, typename O>
void launch_split(const Plan& p, const T* vt, const T* w, O* part, int M,
                  int H, int N, cudaStream_t st) {
  dim3 grid(p.tiles, p.f, p.chunks);
  const size_t smem = sizeof(float) * (size_t)p.hs * p.mt;
  switch (p.mt) {
    case 8:
      lrmm_kernel<T, O, 8><<<grid, kThreads, smem, st>>>(vt, w, part, M, H,
                                                         N, p.hs);
      break;
    case 16:
      lrmm_kernel<T, O, 16><<<grid, kThreads, smem, st>>>(vt, w, part, M, H,
                                                          N, p.hs);
      break;
    case 24:
      lrmm_kernel<T, O, 24><<<grid, kThreads, smem, st>>>(vt, w, part, M, H,
                                                          N, p.hs);
      break;
    default:
      lrmm_kernel<T, O, 32><<<grid, kThreads, smem, st>>>(vt, w, part, M, H,
                                                          N, p.hs);
  }
}

// out has the inputs' type T.
template <typename T>
int launch(const T* vt, const T* w, T* out, float* scratch, int M, int H,
           int N, int sms, void* stream) {
  const Plan p = plan(M, H, N, sms);
  cudaStream_t st = (cudaStream_t)stream;
  if (p.f == 1) {
    launch_split(p, vt, w, out, M, H, N, st);
    return (int)cudaGetLastError();
  }
  launch_split(p, vt, w, scratch, M, H, N, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t count = (size_t)M * N;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256
                                                       : 4096);
  lrmm_combine<T><<<blocks, 256, 0, st>>>(scratch, out, count, p.f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of H splits f the launch will use: the wrapper sizes the
// float32 scratch buffer as f * M * N (unused when f == 1).
int dcom_lrmm_splits(int M, int H, int N, int sms) {
  return plan(M, H, N, sms).f;
}

// Return value: the cudaError_t of the launches (0 = success).  `out` has
// the inputs' type.
int dcom_lrmm_f32(const float* vt, const float* w, float* out,
                  float* scratch, int M, int H, int N, int sms,
                  void* stream) {
  return launch(vt, w, out, scratch, M, H, N, sms, stream);
}

int dcom_lrmm_bf16(const void* vt, const void* w, void* out,
                   float* scratch, int M, int H, int N, int sms,
                   void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(vt),
                static_cast<const __nv_bfloat16*>(w),
                static_cast<__nv_bfloat16*>(out), scratch, M, H, N, sms,
                stream);
}

}  // extern "C"

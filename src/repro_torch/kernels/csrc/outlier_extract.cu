// Channel-wise outlier statistics for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/outlier_extract.py:
//   outlier_stats (:53, body _outlier_kernel :30)
//     per channel h of X [S, H]: count(|x| > T) and max |x| over S
// here batched: X [B, S, H] float32 -> counts [B, H], maxabs [B, H]
// float32 (the TPU kernel takes one [S, H]).
//
// What bounds it on the H100: bytes.  One pass over X (S*H*4 bytes per
// prompt) at ~2 operations per element; nothing is reused, so the floor is
// |X| / 3.35 TB/s (20 us for a 4096 x 4096 prompt).
//
// Design: CTAs over (H tile, S split, b).  Threads run along H, four
// channels each, so a warp reads 512 contiguous bytes of a row (16-byte
// loads where H % 4 == 0, masked scalar loads otherwise); each thread
// walks the rows of its split and keeps its four counts and maxima in
// registers.  The TPU kernel's f-way expansion of the S reduction becomes
// the S split across CTAs, sized so the grid holds about four CTAs per SM.
// The splits combine by atomics, which is exact and independent of their
// order: a count is an integer below 2^24 (the wrapper checks S), so the
// float32 atomicAdd of integer partials is exact, and the maximum of
// non-negative floats is the integer maximum of their bit patterns
// (atomicMax on the bits).  The wrapper zeroes both outputs first.
// The engine hands the kernel the float32 copy of the activation that its
// Lanczos base track needs anyway, so the kernel reads float32 only
// (reading bf16 would halve the bytes for a caller that holds no copy).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                       // channels per thread
constexpr int kTile = kThreads * kCols;        // channels per CTA
constexpr int kMinRows = 16;                   // rows per split, at least

__global__ void __launch_bounds__(kThreads)
outlier_stats_kernel(const float* __restrict__ x, float thr,
                     float* __restrict__ cnt, float* __restrict__ mx, int S,
                     int H, int rows) {
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (c0 >= H) return;
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * rows;
  const int s1 = min(S, s0 + rows);
  const float* xb = x + (size_t)b * S * H;
  float n[kCols], m[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) n[i] = m[i] = 0.f;

  if ((H & 3) == 0 && ((uintptr_t)x & 15) == 0) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const float4 v =
          *reinterpret_cast<const float4*>(xb + (size_t)s * H + c0);
      const float a[kCols] = {fabsf(v.x), fabsf(v.y), fabsf(v.z),
                              fabsf(v.w)};
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        n[i] += a[i] > thr ? 1.f : 0.f;
        m[i] = fmaxf(m[i], a[i]);
      }
    }
  } else {
    for (int s = s0; s < s1; ++s) {
      const float* row = xb + (size_t)s * H + c0;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (c0 + i < H) {
          const float a = fabsf(row[i]);
          n[i] += a > thr ? 1.f : 0.f;
          m[i] = fmaxf(m[i], a);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (c0 + i < H) {
      const size_t o = (size_t)b * H + c0 + i;
      atomicAdd(cnt + o, n[i]);
      atomicMax(reinterpret_cast<int*>(mx) + o, __float_as_int(m[i]));
    }
  }
}

}  // namespace

extern "C" {

// counts/maxabs must hold zeros.  Return value: the cudaError_t of the
// launch (0 = success).
int dcom_outlier_stats_f32(const float* x, float thr, float* cnt, float* mx,
                           int B, int S, int H, void* stream) {
  int dev = 0, sms = 132;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (H + kTile - 1) / kTile;
  long want = (4L * sms + (long)tiles * B - 1) / ((long)tiles * B);
  int rows = (int)((S + want - 1) / want);
  if (rows < kMinRows) rows = kMinRows;
  if ((S + rows - 1) / rows > 65535) rows = (S + 65534) / 65535;
  const int splits = (S + rows - 1) / rows;
  dim3 grid(tiles, splits, B);
  outlier_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, thr, cnt, mx, S, H, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Channel-wise outlier statistics for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/outlier_extract.py:
//   outlier_stats (:53, body _outlier_kernel :30)
//     per channel h of X [S, H]: count(|x| > T) and max |x| over S
// here batched: X [B, S, H] float32 or bfloat16 -> counts [B, H], maxabs
// [B, H] float32 (the TPU kernel takes one [S, H] and casts it to float32,
// as this kernel does element by element: |x| of a bf16 value is exact in
// float32, so both reductions are exact for either input type).
//
// What bounds it on the H100: bytes.  One pass over X at ~3 operations
// per element; nothing is reused, so the floor is |X| / 3.35 TB/s (20 us
// for a 4096 x 4096 prompt in float32, 10 us in bf16).
//
// Design: one launch.  CTAs of 8 warps over (channel tile, S split, b);
// a warp reads 512 contiguous bytes of a row (a 16-byte load a lane: 4
// float32 or 8 bf16 channels) and the 8 warps walk interleaved rows of
// the split.  Each thread keeps 8 rows' loads in flight (128 bytes) before
// it counts, so a CTA has 32 KB in flight; the grid is one wave of at most
// two CTAs an SM (the host passes the SM count), not sized to the shape.
// An X larger than the L2 is loaded streaming (evict-first): its lines
// displace X's own earlier lines, not what other kernels keep in L2; a
// smaller X (the bf16 activation of phase 6) is loaded through the L2,
// where its producer usually left it.  The warps
// combine in shared memory in warp order.  Where S is split, each CTA
// writes its tile's partials to float32 scratch and takes a ticket; the
// last CTA of the tile to arrive sums the splits in split order (8
// splits' loads in flight at a time), writes
// the outputs and resets its ticket for the next launch (the counters are
// zero between launches), so no memset launch precedes it.  Counts are
// integers below 2^24 (the wrapper checks S), so every sum is exact and
// the maximum of non-negative floats is order-free: the results equal the
// plain version bit for bit.  A row that is not 16-byte aligned (H not a
// multiple of 4 or 8) takes masked scalar loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;               // rows in flight per thread

// |x| as float32 of the V channels in 16 raw bytes, or of one element.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int V = 4;            // channels per 16-byte load
  __device__ static void abs16(uint4 v, float* a) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = __uint_as_float(w[i] & 0x7fffffffu);
  }
  __device__ static float abs1(const float* p) { return fabsf(__ldg(p)); }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int V = 8;
  // bf16 -> float32 is the bf16 bits in the high half; |.| clears the sign
  __device__ static void abs16(uint4 v, float* a) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[2 * i] = __uint_as_float((w[i] << 16) & 0x7fffffffu);
      a[2 * i + 1] = __uint_as_float(w[i] & 0x7fff0000u);
    }
  }
  __device__ static float abs1(const __nv_bfloat16* p) {
    return fabsf(__bfloat162float(p[0]));
  }
};

// One CTA: channels [c0, c0 + 32 V) of prompt b over rows [s0, s1).
// part: [B, splits, H] counts then [B, splits, H] maxima (splits > 1).
template <typename T, bool VEC, bool CS>
__global__ void __launch_bounds__(kThreads)
outlier_stats_kernel(const T* __restrict__ x, float thr,
                     float* __restrict__ cnt, float* __restrict__ mx,
                     float* __restrict__ part, unsigned* __restrict__ tickets,
                     int S, int H, int rows, int tiles, int splits) {
  constexpr int V = Elem<T>::V, TILE = 32 * V;
  __shared__ float red_n[kWarps][TILE], red_m[kWarps][TILE];
  __shared__ bool last;
  const int tile = blockIdx.x % tiles;
  const int split = (blockIdx.x / tiles) % splits;
  const size_t b = blockIdx.x / tiles / splits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = tile * TILE + lane * V;            // this lane's channels
  const int s0 = split * rows, s1 = min(S, s0 + rows);
  const T* xb = x + b * S * H;
  float n[V], m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) n[i] = m[i] = 0.f;

  if (c < H) {
    for (int r0 = s0 + warp; r0 < s1; r0 += kUnroll * kWarps) {
      if (VEC) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {        // all loads first
          const int r = r0 + u * kWarps;
          const uint4* src =
              reinterpret_cast<const uint4*>(xb + (size_t)r * H + c);
          raw[u] = r < s1 ? (CS ? __ldcs(src) : __ldg(src))
                          : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {        // 0 counts nothing
          float a[V];
          Elem<T>::abs16(raw[u], a);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            n[i] += a[i] > thr ? 1.f : 0.f;
            m[i] = fmaxf(m[i], a[i]);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = r0 + u * kWarps;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float a = r < s1 && c + i < H
                                ? Elem<T>::abs1(xb + (size_t)r * H + c + i)
                                : 0.f;
            n[i] += a > thr ? 1.f : 0.f;
            m[i] = fmaxf(m[i], a);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red_n[warp][lane * V + i] = n[i];
    red_m[warp][lane * V + i] = m[i];
  }
  __syncthreads();
  // the tile's column sums, warp order; then either the outputs or this
  // split's partials
  const bool direct = splits == 1;
  const size_t np = (size_t)gridDim.x / tiles * H;   // B * splits * H
  const size_t mine = (b * splits + split) * H;
  float* on = direct ? cnt + b * H : part + mine;
  float* om = direct ? mx + b * H : part + np + mine;
  for (int j = threadIdx.x; j < TILE; j += kThreads) {
    const int h = tile * TILE + j;
    if (h >= H) break;
    float sn = 0.f, sm = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sn += red_n[w][j];
      sm = fmaxf(sm, red_m[w][j]);
    }
    on[h] = sn;
    om[h] = sm;
  }
  if (direct) return;
  __threadfence();                 // partials visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* t = tickets + b * tiles + tile;
    last = atomicAdd(t, 1u) == (unsigned)splits - 1;
    if (last) *t = 0u;             // reset for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();                 // the other splits' partials
  for (int j = threadIdx.x; j < TILE; j += kThreads) {
    const int h = tile * TILE + j;
    if (h >= H) break;
    float sn = 0.f, sm = 0.f;
    const float* pn = part + b * splits * H + h;
    for (int k0 = 0; k0 < splits; k0 += kUnroll) { // split order
      float vn[kUnroll], vm[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {          // all loads first
        const size_t o = (size_t)min(k0 + u, splits - 1) * H;
        vn[u] = __ldcg(pn + o);
        vm[u] = __ldcg(pn + np + o);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u < splits) {
          sn += vn[u];
          sm = fmaxf(sm, vm[u]);
        }
      }
    }
    cnt[b * H + h] = sn;
    mx[b * H + h] = sm;
  }
}

template <typename T>
int launch(const T* x, float thr, float* cnt, float* mx, float* part,
           unsigned* tickets, int B, int S, int H, int splits, void* stream) {
  constexpr int V = Elem<T>::V, TILE = 32 * V;
  const int tiles = (H + TILE - 1) / TILE;
  const int rows = (S + splits - 1) / splits;
  const long long blocks = (long long)B * splits * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // an X larger than the L2 cannot stay there for a later reader: stream it
  static int l2 = -1;
  if (l2 < 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const bool cs = (long long)B * S * H * (long long)sizeof(T) > l2;
  const bool vec = H % V == 0 && ((uintptr_t)x & 15) == 0;
  auto kern = vec ? (cs ? outlier_stats_kernel<T, true, true>
                        : outlier_stats_kernel<T, true, false>)
                  : outlier_stats_kernel<T, false, false>;
  kern<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, thr, cnt, mx, part, tickets, S, H, rows, tiles, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Channels per CTA tile for an element size of 4 (float32) or 2 (bf16).
int dcom_outlier_tile(int elem) { return elem == 4 ? 128 : 256; }

// S splits for B prompts of H channels on `sms` SMs: at most two CTAs an
// SM (one wave), each split at least 64 rows.
int dcom_outlier_splits(int elem, int B, int S, int H, int sms) {
  const int tiles = (H + dcom_outlier_tile(elem) - 1) / dcom_outlier_tile(elem);
  long long want = 2LL * sms / ((long long)tiles * B);
  const long long most = (S + 63) / 64;
  if (want > most) want = most;
  return want < 1 ? 1 : (int)want;
}

// x: contiguous [B, S, H], elem 4 (float32) or 2 (bf16); part: scratch of
// 2 * B * splits * H floats (unused when splits == 1); tickets: B * tiles
// zeroed counters, left zeroed.  Return value: the cudaError_t of the
// launch (0 = success).
int dcom_outlier_stats(const void* x, int elem, float thr, float* cnt,
                       float* mx, float* part, unsigned* tickets, int B,
                       int S, int H, int splits, void* stream) {
  if (elem == 4)
    return launch(static_cast<const float*>(x), thr, cnt, mx, part, tickets,
                  B, S, H, splits, stream);
  if (elem == 2)
    return launch(static_cast<const __nv_bfloat16*>(x), thr, cnt, mx, part,
                  tickets, B, S, H, splits, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

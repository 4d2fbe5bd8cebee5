// Per-pixel max and argmax of pointwise values over data-dependent pixel ids.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_pixel_max_kernel
// (pallas_call in _pixel_max_fwd_raw, wrapped by pixel_max_pallas) and, in
// pixel_max_bwd_launch at the end of this file, _pixel_max_bwd_kernel
// (pallas_call in _pixel_max_bwd). Semantics of the forward are the TPU
// kernel's: per (cloud, pixel, channel) the max value and the lowest point
// index attaining it; -3.4e38 / -1 where no point falls; ids outside
// [0, P^2) match no pixel.
//
// Bound on the H100: bytes, and few of them. A serve-step call reads
// 20 x 10000 x (4 + 12) B and writes 20 x 400 x 3 x 8 B (~3.2 MB + 0.2 MB,
// about 1 us at 3.35 TB/s); there is one compare per value. What costs in
// practice is contention on the few pixels' atomics and the launches.
//
// Design: the TPU kernel compares every point with every pixel (a dense
// (P^2, chunk) mask) because TPU scatters serialise. Hopper has shared-memory
// atomics, so each point goes straight to its pixel. A value is mapped to
// an order-preserving uint32 and packed into a 64-bit key
// (ord(v) << 32) | (0xFFFFFFFF - idx), so one atomicMax keeps the larger
// value and, among equal values, the lower index: deterministic, whatever
// the order of the atomics. One block per (cloud, chunk of points) reduces
// into a P^2 x C table of keys in shared memory (400 x 3 x 8 B at the serve
// geometry), then merges its occupied slots into a (B, P^2, C) key scratch
// in device memory with global atomicMax; a second kernel decodes the keys.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // points per block

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_value(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__global__ void __launch_bounds__(kThreads)
pixel_max_scatter(const int* __restrict__ pix, const float* __restrict__ vals,
                  unsigned long long* __restrict__ keys, int n, int p2, int c) {
  extern __shared__ unsigned long long table[];
  const int b = blockIdx.y;
  const int slots = p2 * c;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) table[i] = 0ull;
  __syncthreads();
  const int begin = blockIdx.x * kChunk;
  const int end = min(n, begin + kChunk);
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const int p = pix[static_cast<size_t>(b) * n + i];
    if (p < 0 || p >= p2) continue;
    const unsigned long long low = 0xFFFFFFFFull - static_cast<unsigned>(i);
    for (int ch = 0; ch < c; ++ch) {
      const float v = vals[(static_cast<size_t>(b) * n + i) * c + ch];
      atomicMax(&table[p * c + ch], (static_cast<unsigned long long>(order_key(v)) << 32) | low);
    }
  }
  __syncthreads();
  unsigned long long* kb = keys + static_cast<size_t>(b) * slots;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    if (table[i]) atomicMax(&kb[i], table[i]);
  }
}

__global__ void pixel_max_decode(const unsigned long long* __restrict__ keys,
                                 float* __restrict__ vmax, int* __restrict__ amax,
                                 int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned long long key = keys[i];
  if (key == 0ull) {  // every occupied slot has a non-zero index half
    vmax[i] = -3.4e38f;
    amax[i] = -1;
  } else {
    vmax[i] = order_value(static_cast<uint32_t>(key >> 32));
    amax[i] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key & 0xFFFFFFFFull));
  }
}

// pix (b, n) i32, vals (b, n, c) f32, keys (b, p2, c) u64 scratch ->
// vmax (b, p2, c) f32, amax (b, p2, c) i32.
extern "C" int pixel_max_launch(const int* pix, const float* vals, unsigned long long* keys,
                                float* vmax, int* amax, int b, int n, int p2, int c,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(b) * p2 * c;
  cudaError_t err = cudaMemsetAsync(keys, 0, total * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(p2) * c * sizeof(unsigned long long);
  err = allow_smem(pixel_max_scatter, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kChunk - 1) / kChunk, b);
  pixel_max_scatter<<<grid, kThreads, smem, st>>>(pix, vals, keys, n, p2, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pixel_max_decode<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      keys, vmax, amax, static_cast<int>(total));
  return cudaGetLastError();
}

// Backward of the per-pixel max, one gather pass: replaces
// stratanet2_tpu/ops/pallas_kernels.py::_pixel_max_bwd_kernel (pallas_call in
// _pixel_max_bwd). dv[b, i, ch] = g[b, p, ch] where p = pix[b, i] lies in
// [0, P^2) and amax[b, p, ch] == i, else 0. That is the scatter of each
// pixel's cotangent to its winner: a point lies in exactly one pixel (or
// none, when its id is out of range), so "point i is the winner of a pixel"
// is "amax[pix[i]] == i", and empty pixels (amax = -1) have no point.
//
// Bound on the H100: bytes. It reads pix (B, N) and amax, g (B, P^2, C) and
// writes dv (B, N, C) once (PROD train step: 0.8 MB + 2 x 96 KB in, 2.4 MB
// out, about 1 us at 3.35 TB/s).
//
// Design: the TPU kernel compares every pixel with every point of a chunk (a
// dense (P^2, chunk) one-hot). Here one thread per element of dv: a block is
// (C, 256 / C) threads, x the channel and y the point, so consecutive
// threads write consecutive elements (coalesced) and no thread divides by C.
// Each thread takes kBwdUnroll points of its cloud (blockIdx.y) and issues
// their loads before any store: the pixel ids, then each pixel's winner and
// cotangent together (g is read whether or not the point won; amax and g are
// small and stay in L2). Every element of dv is written exactly once, so
// there is no memset, no atomic and no scatter, and the launch entry makes
// one kernel launch.
constexpr int kBwdThreads = 256;
constexpr int kBwdUnroll = 4;

__global__ void __launch_bounds__(kBwdThreads)
pixel_max_bwd_kernel(const int* __restrict__ pix, const int* __restrict__ amax,
                     const float* __restrict__ g, float* __restrict__ dv, int n, int p2, int c) {
  const int ch = threadIdx.x;
  const size_t b = blockIdx.y;
  const int first = blockIdx.x * blockDim.y * kBwdUnroll + threadIdx.y;
  const int* pb = pix + b * n;
  const int* ab = amax + b * p2 * c;
  const float* gb = g + b * p2 * c;
  float* db = dv + b * n * c;
  int p[kBwdUnroll], a[kBwdUnroll];
  float v[kBwdUnroll];
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u) {
    const int i = first + u * blockDim.y;
    p[u] = i < n ? pb[i] : -1;
  }
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u) {
    const bool in = p[u] >= 0 && p[u] < p2;
    a[u] = in ? ab[p[u] * c + ch] : -1;
    v[u] = in ? gb[p[u] * c + ch] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kBwdUnroll; ++u) {
    const int i = first + u * blockDim.y;
    if (i < n) db[static_cast<size_t>(i) * c + ch] = a[u] == i ? v[u] : 0.0f;
  }
}

// pix (b, n) i32, amax (b, p2, c) i32 (pixel_max's argmax for these ids),
// g (b, p2, c) f32 -> dv (b, n, c) f32; 1 <= c <= 256, b <= 65535.
extern "C" int pixel_max_bwd_launch(const int* pix, const int* amax, const float* g, float* dv,
                                    int b, int n, int p2, int c, void* stream) {
  const dim3 block(c, kBwdThreads / c);
  const int per_block = block.y * kBwdUnroll;
  const dim3 grid((n + per_block - 1) / per_block, b);
  pixel_max_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(pix, amax, g, dv,
                                                                               n, p2, c);
  return cudaGetLastError();
}

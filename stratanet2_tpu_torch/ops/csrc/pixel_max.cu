// Per-pixel max and argmax of pointwise values over data-dependent pixel ids.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_pixel_max_kernel
// (pallas_call in _pixel_max_fwd_raw, wrapped by pixel_max_pallas) and, in
// pixel_max_bwd_launch at the end of this file, _pixel_max_bwd_kernel
// (pallas_call in _pixel_max_bwd). Semantics are the TPU kernel's: per (cloud, pixel, channel) the max
// value and the lowest point index attaining it; -3.4e38 / -1 where no point
// falls; ids outside [0, P^2) match no pixel.
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

// Backward of the per-pixel max: dv[b, amax[b, p, ch], ch] = g[b, p, ch]
// wherever amax >= 0, zero elsewhere. Each point lies in at most one pixel,
// so per channel no two pixels share a winner: plain stores, no atomics,
// and the result is deterministic. The TPU kernel compares every pixel with
// every point of a chunk (a dense (P^2, chunk) one-hot); here each pixel
// stores straight to its winner.
//
// Bound on the H100: bytes. It reads amax and g (B, P^2, C) and writes dv
// (B, N, C) once (PROD train step: 2 x 96 KB in, 2.4 MB out, under 1 us at
// 3.35 TB/s); the memset of dv is most of the writing.
__global__ void pixel_max_bwd_kernel(const int* __restrict__ amax, const float* __restrict__ g,
                                     float* __restrict__ dv, int n, int p2, int c, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int a = amax[i];
  if (a < 0 || a >= n) return;  // empty pixel
  const int b = i / (p2 * c);
  const int ch = i % c;
  dv[(static_cast<size_t>(b) * n + a) * c + ch] = g[i];
}

// amax (b, p2, c) i32, g (b, p2, c) f32 -> dv (b, n, c) f32, zeroed here first.
extern "C" int pixel_max_bwd_launch(const int* amax, const float* g, float* dv, int b, int n,
                                    int p2, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dv, 0, sizeof(float) * b * static_cast<size_t>(n) * c, st);
  if (err != cudaSuccess) return err;
  const int total = b * p2 * c;
  pixel_max_bwd_kernel<<<(total + 255) / 256, 256, 0, st>>>(amax, g, dv, n, p2, c, total);
  return cudaGetLastError();
}

// Per-pixel max and argmax of pointwise values over data-dependent pixel ids.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_pixel_max_kernel (:1289,
// pallas_call :1368 in _pixel_max_fwd_raw, wrapped by pixel_max_pallas
// :1390) and, in pixel_max_bwd_launch at the end of this file,
// _pixel_max_bwd_kernel (:1329, pallas_call :1433 in _pixel_max_bwd).
// Semantics of the forward are the TPU kernel's: per (cloud, pixel, channel)
// the max value and the lowest point index attaining it; -3.4e38 / -1 where
// no point falls; ids outside [0, P^2) match no pixel.
//
// Bound on the H100: bytes, and few of them. A serve-step call reads
// 20 x 10000 x (4 + 12) B and writes 20 x 400 x 3 x 8 B (~3.2 MB + 0.2 MB,
// about 1 us at 3.35 TB/s); there is one compare per value. What costs in
// practice is the launch and the host's share of it.
//
// Design: the TPU kernel compares every point with every pixel (a dense
// (P^2, chunk) mask) because TPU scatters serialise. Hopper has shared-memory
// atomics, so each point goes straight to its pixel. A value is mapped to
// an order-preserving uint32 and packed into a 64-bit key
// (ord(v) << 32) | (0xFFFFFFFF - idx), so one atomicMax keeps the larger
// value and, among equal values, the lower index: deterministic, whatever
// the order of the atomics. One launch a call, one thread-block cluster of
// kCS blocks a cloud (grid (kCS, 1, B); a table past shared memory takes
// several pixel ranges, see pixel_max_kernel): each block zeroes its own
// P^2 x C table of keys in shared memory (400 x 3 x 8 B at the serve
// geometry), reduces its contiguous share of the cloud's points into it,
// and after a cluster barrier block r takes every kCS-th share of the slots, reads the
// kCS peers' keys through distributed shared memory, keeps the largest,
// decodes it and writes vmax and amax; a second cluster barrier keeps each
// table alive until its peers have read it. No scratch in device memory,
// no memset, no global atomic, no decode kernel. Measured
// (scripts/kernel_variants.py at the serve step's site, B=20 x N=10000,
// P^2 = 400, C = 3; device ms a call, NVIDIA H100 80GB HBM3 at 700 W): kCS =
// 8 with 512 threads 0.0076; not kept: kCS = 4 0.0082, kCS = 2 0.0119, 256
// threads 0.0087, 1024 threads 0.0122; the parent's scatter + decode kernels
// 0.0109 beside its key memset (three device operations).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kCS = 8;  // blocks a cluster, a cluster a cloud (8 is the portable most)

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_value(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Cluster (range, cloud) of grid (kCS, ranges, b): the per-pixel max of the
// pixels [lo, lo + cnt), lo = range x per, over the cloud's points. Each of
// its kCS blocks reduces its contiguous share of the points into a table of
// the range's pixels in shared memory, then the cluster merges the tables
// through distributed shared memory. One range (per = p2, the whole table)
// is every table that fits in a block (cuda_kernels.pixel_max_range: 8 p2 c
// <= 227 KB, diam_pix <= 98 at C = 3, the PROD steps among them); a larger
// table is cut into the fewest ranges whose tables leave two blocks on an
// SM (113 KB each: three ranges at the dense plots' P = 100), each block
// reading its whole share of the ids and keeping the points of its range,
// so the ids are read once a range and the values once in all. No table
// leaves shared memory at any size: no global atomic, memset or decode
// pass, and the result is the same bits on every run.
//
// Tables past one block (PERF.md §6 row 6a; scripts/kernel_variants.py
// pixel_max at B=20 x N=65,536, P = 100, uniform pixels and the dense serve
// step's raster bins, NVIDIA H100 80GB HBM3 at 700 W): the fewest ranges
// that fit (two, one block an SM: every cluster's 8 blocks hold 120 KB
// tables) took 0.0754 / 0.0674 ms a launch, three ranges (two blocks an SM)
// 0.0545 / 0.0491, four 0.070 / 0.060, eight 0.109 / 0.085. Not kept: the
// table spread over the cluster with 64-bit maxima sent to their owner
// blocks through distributed shared memory (scripts/variants/
// pixel_max_dsmem.cu; 0.116 ms, and its outputs differed: ptxas makes the
// reduction a compare-and-swap loop on the block's own slots and
// ATOM.E.MAX.64 on a peer's), a counting sort of the points by pixel and a
// segmented max (pixel_max_sort.cu; 0.099 ms, 2.65 at the raster bins,
// whose pixel 0 holds a sixth of the points), and a block a slice of the
// pixels reading every id (pixel_max_owner_scan.cu; 0.092 / 0.089).
__global__ void __cluster_dims__(kCS, 1, 1) __launch_bounds__(kThreads)
pixel_max_kernel(const int* __restrict__ pix, const float* __restrict__ vals,
                 float* __restrict__ vmax, int* __restrict__ amax, int n, int p2, int c,
                 int per) {
  extern __shared__ unsigned long long table[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.z;
  const int lo = blockIdx.y * per, cnt = min(per, p2 - lo);
  const int slots = cnt * c;
  for (int i = threadIdx.x; i < slots; i += kThreads) table[i] = 0ull;
  __syncthreads();
  const int share = (n + kCS - 1) / kCS;
  const int end = min(n, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < end; i += kThreads) {
    const int id = pix[b * n + i];
    if (id < lo || id >= lo + cnt) continue;
    const int p = id - lo;
    const unsigned long long low = 0xFFFFFFFFull - static_cast<unsigned>(i);
    for (int ch = 0; ch < c; ++ch) {
      const float v = vals[(b * n + i) * c + ch];
      atomicMax(&table[p * c + ch], (static_cast<unsigned long long>(order_key(v)) << 32) | low);
    }
  }
  cluster.sync();  // every peer's table is complete and visible
  const size_t o0 = (b * p2 + lo) * c;  // the range's first output slot
  for (int i = rank * kThreads + threadIdx.x; i < slots; i += kCS * kThreads) {
    unsigned long long key = 0ull;
#pragma unroll
    for (int q = 0; q < kCS; ++q) key = max(key, cluster.map_shared_rank(table, q)[i]);
    if (key == 0ull) {  // every occupied slot has a non-zero index half
      vmax[o0 + i] = -3.4e38f;
      amax[o0 + i] = -1;
    } else {
      vmax[o0 + i] = order_value(static_cast<uint32_t>(key >> 32));
      amax[o0 + i] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    }
  }
  cluster.sync();  // no table goes while a peer may still read it
}

// pix (b, n) i32, vals (b, n, c) f32 -> vmax (b, p2, c) f32, amax (b, p2, c)
// i32, in ranges of `per` pixels (the last may hold fewer); 8 * per * c
// bytes of shared memory a block, b and the ranges <= 65535.
extern "C" int pixel_max_launch(const int* pix, const float* vals, float* vmax, int* amax,
                                int b, int n, int p2, int c, int per, void* stream) {
  const size_t smem = static_cast<size_t>(per) * c * sizeof(unsigned long long);
  cudaError_t err = allow_smem(pixel_max_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kCS, (p2 + per - 1) / per, b);
  pixel_max_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pix, vals, vmax, amax, n, p2, c, per);
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

// The counting sort of csrc/pixel_max.cu's tables past one block's shared
// memory, kept as a variant and timed against the package's design by
// scripts/kernel_variants.py (`pixel_max`): a cluster of kCS blocks a
// cloud counts its points by pixel into per-block histograms of 32-bit
// counters, block r sums its slice's counts over the cluster through
// distributed shared memory, scans them and hands each block its starts,
// the blocks place their points' indices in a device-memory scratch in
// pixel order, and block r reduces each of its pixels' segments: per
// channel the max value, the least index among the points that reach it.
// Ranges of at most 51,200 pixels (4 B counters and a slice's segment
// starts in a block's shared memory). On an H100 it took 0.099 ms at the
// dense plots' table (B=20 x N=65,536, P = 100), the same bits as the
// plain version (PERF.md §6, row 6a).
//
// Built from this file alone: it includes csrc/pixel_max.cu (nvcc -I csrc).
#include "pixel_max.cu"

// The counting sort of a range's points by pixel, then a segmented max; a
// cluster of kCS blocks a (range, cloud) of grid (kCS, ranges, b), the
// pixels [lo, lo + cnt), lo = range x per. Block r counts its contiguous
// share of the points into `count` (a histogram of the range's pixels,
// 32-bit shared-memory atomics) and owns the slice of own = ceil(per / kCS)
// pixels from lo + r own. It sums the kCS blocks' counts of each pixel of
// its slice (distributed shared memory), scans them (the slices before it
// from their published totals), keeps each pixel's segment start in `seg`
// and writes each block's start of that pixel into the block's `count`.
// Each block then places its points' indices at those starts in `order`
// (b, ranges, n), and, after a cluster barrier, each block takes its
// pixels' segments whole: per channel the max value and the least index
// among the points that reach it (a segment holds block 0's points, then
// block 1's, ..., each in the order of the atomics: the compare decides
// ties by index, so the result does not depend on that order).
__global__ void __cluster_dims__(kCS, 1, 1) __launch_bounds__(kThreads)
pixel_max_sort_kernel(const int* __restrict__ pix, const float* __restrict__ vals,
                      float* __restrict__ vmax, int* __restrict__ amax, int* __restrict__ order,
                      int n, int p2, int c, int per) {
  extern __shared__ int sort_smem[];  // count[per], then seg[own + 1]
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int slice_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t b = blockIdx.z;
  const int lo = blockIdx.y * per, cnt = min(per, p2 - lo);
  const int own = (per + kCS - 1) / kCS, first = rank * own;
  const int mine = max(0, min(own, cnt - first));  // pixels of this block's slice
  int* count = sort_smem;
  int* seg = sort_smem + per;
  const int* pb = pix + b * n;
  int* ob = order + (b * gridDim.y + blockIdx.y) * static_cast<size_t>(n);
  const int share = (n + kCS - 1) / kCS;
  const int i0 = rank * share, i1 = min(n, i0 + share);

  for (int p = t; p < cnt; p += kThreads) count[p] = 0;
  __syncthreads();
  for (int i = i0 + t; i < i1; i += kThreads) {
    const int id = pb[i];
    if (id >= lo && id < lo + cnt) atomicAdd(&count[id - lo], 1);
  }
  cluster.sync();  // every block's counts are complete

  // the slice's pixels, k a thread in order: their points over the cluster
  const int k = (mine + kThreads - 1) / kThreads;
  const int p0 = min(t * k, mine), p1 = min(p0 + k, mine);
  int run = 0;
  for (int p = p0; p < p1; ++p) {
#pragma unroll
    for (int q = 0; q < kCS; ++q) run += cluster.map_shared_rank(count, q)[first + p];
  }
  const int incl = warp_incl_scan(run, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int total = warp_incl_scan(lane < kThreads / 32 ? warp_sums[lane] : 0, lane);
    if (lane < kThreads / 32) warp_sums[lane] = total;
    if (lane == kThreads / 32 - 1) slice_total = total;
  }
  cluster.sync();  // every slice's total is published
  int at = incl - run + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int q = 0; q < rank; ++q) at += *cluster.map_shared_rank(&slice_total, q);
  if (t == 0) seg[mine] = at - incl + run + slice_total;  // thread 0's prefix is the slice's start
  for (int p = p0; p < p1; ++p) {
    seg[p] = at;
#pragma unroll
    for (int q = 0; q < kCS; ++q) {  // block q's points of the pixel start at `at`
      int* cq = cluster.map_shared_rank(count, q) + first + p;
      const int m = *cq;
      *cq = at;
      at += m;
    }
  }
  cluster.sync();  // every block's starts are in its `count`
  for (int i = i0 + t; i < i1; i += kThreads) {
    const int id = pb[i];
    if (id >= lo && id < lo + cnt) ob[atomicAdd(&count[id - lo], 1)] = i;
  }
  __threadfence();
  cluster.sync();  // every point's index is in `order`
  const size_t o0 = (b * p2 + lo + first) * c;
  for (int p = t; p < mine; p += kThreads) {
    const int j0 = seg[p], j1 = seg[p + 1];
    for (int ch = 0; ch < c; ++ch) {
      float best = 0.0f;
      int arg = -1;
      for (int j = j0; j < j1; ++j) {
        const int i = ob[j];
        const float v = vals[(b * n + i) * c + ch];
        if (arg < 0 || v > best || (v == best && i < arg)) {
          best = v;
          arg = i;
        }
      }
      vmax[o0 + static_cast<size_t>(p) * c + ch] = arg < 0 ? -3.4e38f : best;
      amax[o0 + static_cast<size_t>(p) * c + ch] = arg;
    }
  }
}

// pix (b, n) i32, vals (b, n, c) f32 -> vmax (b, p2, c) f32, amax (b, p2, c)
// i32 by the counting sort, in ranges of `per` pixels (the last may hold
// fewer): 4 (per + ceil(per / kCS) + 1) bytes of shared memory a block;
// order (b, ranges, n) i32 scratch; b and the ranges <= 65535.
extern "C" int pixel_max_sort_launch(const int* pix, const float* vals, float* vmax, int* amax,
                                     int* order, int b, int n, int p2, int c, int per,
                                     void* stream) {
  const size_t smem = sizeof(int) * (static_cast<size_t>(per) + (per + kCS - 1) / kCS + 1);
  cudaError_t err = allow_smem(pixel_max_sort_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kCS, (p2 + per - 1) / per, b);
  pixel_max_sort_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pix, vals, vmax, amax, order, n, p2, c, per);
  return cudaGetLastError();
}

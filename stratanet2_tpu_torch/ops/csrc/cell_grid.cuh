// The cell grid of a cloud, shared by the kernels that cull by space: the
// nearest selection (ball_query_nearest.cu), the grouped selection's
// long-group path (grouped_cull.cuh, for ball_query.cu and
// sa_fused_eval.cu) and kNN interpolation on dense plots
// (knn_interpolate.cu, whose "points" are the sources and "centroids" the
// targets). Each library wraps `cell_grid_pass` in a grid kernel of its own
// name, one block of kGridThreads threads a cloud, no host sync: it reduces
// the cloud's xy extent, max |p|^2 over its points and max |c|^2 over its
// centroids; picks the cell side h (below: from a culling radius r_c, or
// for kNN from the extent alone); counts its points into cells with
// shared-memory atomics, scans the counts into each cell's start, and
// scatters the points in cell order as float4 [x, y, z, |p|^2] (|p|^2 as
// sq3_rn) beside their original indices; then sorts the centroids by cell
// the same way, so that the warps of a query block take neighbouring
// centroids and read neighbouring ranges. The order inside a cell follows
// the atomics and is not fixed; nothing downstream depends on it (the
// queries fold their candidates by a set function). The grid has at most
// gmax x gmax cells, gmax = min(64, isqrt(N)) from the shapes, so a wrapper
// sizes the workspace with torch.empty and no value is read back.
//
// The selections' invariant: EVERY POINT THAT THE PLAIN VERSION ADMITS IS
// SCORED. The plain version admits p for c when E = max(fl(fl(a - 2 ab) +
// b), 0) <= r2, with a = sq3_rn(c), b = sq3_rn(p), ab = dot3_rn(c, p), u =
// 2^-24. Its true squared distance D = |c - p|^2 can exceed r2 by the
// rounding of that cancellation, which grows with |c|^2 + |p|^2 (one ulp of
// |p|^2 is 0.125 m^2 at 1 km from the origin):
//   |a - |c|^2| <= g3 |c|^2 and |b - |p|^2| <= g3 |p|^2 (g3 = 3u / (1 - 3u),
//   fma chains of nonnegative terms); |ab - c.p| <= g3 |c||p|;
//   the fma rounds a - 2 ab once: error <= u (a + 2 |ab|) <= 2u (1 + g3) S,
//   S = |c|^2 + |p|^2; the last add rounds once, so E <= r2 gives
//   x = fl(a - 2 ab) + b <= r2 / (1 - u). Summing,
//   D <= r2 / (1 - u) + (2 g3 + 2u (1 + g3)) S <= r2 + 8.02 u (M + r2),
//   M = max |c|^2 + max |p|^2 over the cloud (|c|^2 <= a / (1 - g3)).
// The kernel takes delta = 16 u (M + r2), rounded as
//   rc2 = fl(r2 + fl(fl(fl(mc + mp) + r2) * 2^-20)), r_c = sqrt_rn(rc2),
// whose roundings lose under 3u rc2 of the margin, so D <= r_c^2: an
// admitted point lies within r_c of its centroid in x and in y. Cells:
//   inv_h = min(fl(1 / fl(r_c (1 + 2^-10))), fl((gmax - 0.5) / max(ex, ey))),
//   q(x) = fl(fl(x - xmin) inv_h), cell = q > 0 ? floor(min(q, g - 1)) : 0,
// g = gx = floor(q(xmax)) + 1 (clamped as a cell) and likewise in y. q
// carries two roundings of a value below 65 (below 1 for a centroid left of
// xmin, and no admitted point lies further out): error < 2e-5. And
// |x_p - x_c| inv_h <= r_c (1 + u)^2 / ((1 + 2^-10)(1 - u)) < 1 - 9e-4. So
// |q(x_p) - q(x_c)| < 1, the floors differ by at most 1, and the clamp to
// [0, g - 1] keeps that: the point is in the 3 x 3 cells around its
// centroid's. (A huge radius, as the r = 1e3 reference site, gives one
// cell: brute force. A NaN coordinate is never admitted and goes to cell 0.)
// ops/ballquery.py::nearest_cells mirrors the grid on the CPU in the same
// operations; tests/test_torch_port_nearest_grid.py holds its culled picks
// to the plain picks, and shows a pick lost with delta = 0.
//
// kNN has no radius (cell_grid_pass<true>, EXTENT_GRID_KERNEL): the cells
// are inv_h = fl((gmax - 0.5) / max(ex, ey)) (capped at FLT_MAX for a cloud
// of one xy), about N / gmax^2 sources a cell, and the grid's fourth
// parameter holds M = fl(mc + mp), not rc2: the query's stop rule
// (knn_interpolate.cu) bounds the rounding of a distance by M.
#pragma once

#include "common.cuh"

constexpr int kGridThreads = 1024;
constexpr int kGridMax = 64;     // cuda_kernels.NEAREST_GRID_MAX: cells a side at most
constexpr int kGridParams = 6;   // ints a cloud: xmin, ymin, inv_h, rc2 or M (float bits), gx, gy

// The cell coordinate of an offset d = fl(x - xmin) on an axis of g cells.
__device__ __forceinline__ int cell_coord(float d, float inv_h, int g) {
  const float q = __fmul_rn(d, inv_h);
  return q > 0.0f ? static_cast<int>(fminf(q, static_cast<float>(g - 1))) : 0;
}

// In-place exclusive scan of a[0, len) (len <= 4 * kGridThreads) by the
// whole block. `warp_sums` holds 32 ints.
__device__ void block_exclusive_scan(int* a, int len, int* warp_sums) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int v[4], s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = 4 * t + i < len ? a[4 * t + i] : 0;
    s += v[i];
  }
  const int incl = warp_incl_scan(s, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_sums[lane] = warp_incl_scan(warp_sums[lane], lane);
  __syncthreads();
  int run = incl - s + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (4 * t + i < len) a[4 * t + i] = run;
    run += v[i];
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// The grid pass of one cloud (blockIdx.x), run by a whole block of
// kGridThreads threads: the grid parameters, the points in cell order with
// their indices and each cell's start (cells past gx * gy start at n), and
// the centroids in cell order. kByExtent: the cells from the extent alone
// and M in place of rc2 (kNN; r2 is not read).
template <bool kByExtent = false>
__device__ __forceinline__ void cell_grid_pass(const float* __restrict__ cent,
                                               const float* __restrict__ xyz,
                                               float4* __restrict__ spts,
                                               int* __restrict__ sidx, int* __restrict__ starts,
                                               int* __restrict__ corder, int* __restrict__ grid,
                                               int n, int c, int gmax, float r2) {
  __shared__ int hist[kGridMax * kGridMax];
  __shared__ float red[6][32];
  __shared__ int warp_sums[32];
  __shared__ float prm[3];  // xmin, ymin, inv_h
  __shared__ int dims[2];   // gx, gy
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const float* xb = xyz + static_cast<size_t>(b) * n * 3;
  const float* cb = cent + static_cast<size_t>(b) * c * 3;

  float v[6] = {INFINITY, -INFINITY, INFINITY, -INFINITY, 0.0f, 0.0f};  // x, y extent, mp, mc
  for (int j = t; j < n; j += kGridThreads) {
    const float x = xb[3 * j], y = xb[3 * j + 1], z = xb[3 * j + 2];
    v[0] = fminf(v[0], x);
    v[1] = fmaxf(v[1], x);
    v[2] = fminf(v[2], y);
    v[3] = fmaxf(v[3], y);
    v[4] = fmaxf(v[4], sq3_rn(x, y, z));
  }
  for (int i = t; i < c; i += kGridThreads) {
    v[5] = fmaxf(v[5], sq3_rn(cb[3 * i], cb[3 * i + 1], cb[3 * i + 2]));
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    v[q] = (q == 0 || q == 2) ? warp_min(v[q]) : warp_max(v[q]);
    if (lane == 0) red[q][warp] = v[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float w = red[q][lane];
      v[q] = (q == 0 || q == 2) ? warp_min(w) : warp_max(w);
    }
    if (lane == 0) {
      const float xmin = v[0], ymin = v[2];
      const float ex = __fsub_rn(v[1], xmin), ey = __fsub_rn(v[3], ymin);
      float rc2, inv_h;
      if constexpr (kByExtent) {
        rc2 = __fadd_rn(v[5], v[4]);  // M
        inv_h = fminf(__fdiv_rn(static_cast<float>(gmax) - 0.5f, fmaxf(ex, ey)), 3.4028235e38f);
      } else {
        const float s = __fadd_rn(__fadd_rn(v[5], v[4]), r2);
        rc2 = __fadd_rn(r2, __fmul_rn(s, 9.5367431640625e-07f /* 2^-20 */));
        const float rc = __fsqrt_rn(rc2);
        inv_h = fminf(__fdiv_rn(1.0f, __fmul_rn(rc, 1.0009765625f /* 1 + 2^-10 */)),
                      __fdiv_rn(static_cast<float>(gmax) - 0.5f, fmaxf(ex, ey)));
      }
      const int gx = cell_coord(ex, inv_h, gmax) + 1, gy = cell_coord(ey, inv_h, gmax) + 1;
      prm[0] = xmin;
      prm[1] = ymin;
      prm[2] = inv_h;
      dims[0] = gx;
      dims[1] = gy;
      int* gp = grid + static_cast<size_t>(b) * kGridParams;
      gp[0] = __float_as_int(xmin);
      gp[1] = __float_as_int(ymin);
      gp[2] = __float_as_int(inv_h);
      gp[3] = __float_as_int(rc2);
      gp[4] = gx;
      gp[5] = gy;
    }
  }
  __syncthreads();
  const float xmin = prm[0], ymin = prm[1], inv_h = prm[2];
  const int gx = dims[0], gy = dims[1], cells = gx * gy, nstart = gmax * gmax + 1;
  auto cell_of = [&](float x, float y) {
    return cell_coord(__fsub_rn(y, ymin), inv_h, gy) * gx + cell_coord(__fsub_rn(x, xmin), inv_h, gx);
  };

  // the points: count, scan into starts, scatter
  for (int i = t; i < cells; i += kGridThreads) hist[i] = 0;
  __syncthreads();
  for (int j = t; j < n; j += kGridThreads) atomicAdd(&hist[cell_of(xb[3 * j], xb[3 * j + 1])], 1);
  __syncthreads();
  block_exclusive_scan(hist, cells, warp_sums);
  int* st = starts + static_cast<size_t>(b) * nstart;
  for (int i = t; i < nstart; i += kGridThreads) st[i] = i < cells ? hist[i] : n;
  __syncthreads();  // every start is read before the scatter's atomics move hist
  float4* sp = spts + static_cast<size_t>(b) * n;
  int* si = sidx + static_cast<size_t>(b) * n;
  for (int j = t; j < n; j += kGridThreads) {
    const float x = xb[3 * j], y = xb[3 * j + 1], z = xb[3 * j + 2];
    const int pos = atomicAdd(&hist[cell_of(x, y)], 1);
    sp[pos] = make_float4(x, y, z, sq3_rn(x, y, z));
    si[pos] = j;
  }
  __syncthreads();

  // the centroids: the same counting sort, into corder
  for (int i = t; i < cells; i += kGridThreads) hist[i] = 0;
  __syncthreads();
  for (int i = t; i < c; i += kGridThreads) atomicAdd(&hist[cell_of(cb[3 * i], cb[3 * i + 1])], 1);
  __syncthreads();
  block_exclusive_scan(hist, cells, warp_sums);
  int* co = corder + static_cast<size_t>(b) * c;
  for (int i = t; i < c; i += kGridThreads) co[atomicAdd(&hist[cell_of(cb[3 * i], cb[3 * i + 1])], 1)] = i;
}

// A grid kernel for a library: `cell_grid_pass` under the library's own
// kernel name, so that a trace tells the libraries apart.
#define CELL_GRID_KERNEL(name)                                                                 \
  __global__ void __launch_bounds__(kGridThreads)                                              \
  name(const float* __restrict__ cent, const float* __restrict__ xyz,                          \
       float4* __restrict__ spts, int* __restrict__ sidx, int* __restrict__ starts,            \
       int* __restrict__ corder, int* __restrict__ grid, int n, int c, int gmax, float r2) {   \
    cell_grid_pass(cent, xyz, spts, sidx, starts, corder, grid, n, c, gmax, r2);               \
  }

// The same with the cells from the extent alone (cell_grid_pass<true>).
#define EXTENT_GRID_KERNEL(name)                                                               \
  __global__ void __launch_bounds__(kGridThreads)                                              \
  name(const float* __restrict__ cent, const float* __restrict__ xyz,                          \
       float4* __restrict__ spts, int* __restrict__ sidx, int* __restrict__ starts,            \
       int* __restrict__ corder, int* __restrict__ grid, int n, int c, int gmax, float r2) {   \
    cell_grid_pass<true>(cent, xyz, spts, sidx, starts, corder, grid, n, c, gmax, r2);         \
  }

// The workspace `ws`, ints (cuda_kernels._cell_layout names the same parts):
// spts (b, n) float4, sidx (b, n), starts (b, gmax^2 + 1), corder (b, c),
// grid (b, kGridParams).
struct CellWs {
  float4* spts;
  int *sidx, *starts, *corder, *grid;
};

static CellWs carve_cells(int* ws, int b, int n, int c, int gmax) {
  CellWs w;
  const size_t bn = static_cast<size_t>(b) * n;
  w.spts = reinterpret_cast<float4*>(ws);
  w.sidx = ws + 4 * bn;
  w.starts = w.sidx + bn;
  w.corder = w.starts + static_cast<size_t>(b) * (gmax * gmax + 1);
  w.grid = w.corder + static_cast<size_t>(b) * c;
  return w;
}

// Launch `kernel` (a CELL_GRID_KERNEL or EXTENT_GRID_KERNEL) on the b clouds of `w`.
template <typename Kernel>
static cudaError_t launch_cell_grid(Kernel kernel, const float* cent, const float* xyz,
                                    const CellWs& w, int b, int n, int c, int gmax, float r2,
                                    cudaStream_t stream) {
  kernel<<<b, kGridThreads, 0, stream>>>(cent, xyz, w.spts, w.sidx, w.starts, w.corder, w.grid,
                                         n, c, gmax, r2);
  return cudaGetLastError();
}

// The cell grid of a cloud, shared by the kernels that cull by space: the
// nearest selection (ball_query_nearest.cu), the grouped selection's
// long-group path (grouped_cull.cuh, for ball_query.cu and
// sa_fused_eval.cu) and kNN interpolation on dense plots
// (knn_interpolate.cu, whose "points" are the sources and "centroids" the
// targets). Each library wraps `cell_grid_pass` in a grid kernel of its own
// name, no host sync: it reduces the cloud's xy extent, max |p|^2 over its
// points and max |c|^2 over its centroids; picks the cell side h (below:
// from a culling radius r_c, or for kNN from the extent alone); counts its
// points into cells, scans the counts into each cell's start, and scatters
// the points in cell order as float4 [x, y, z, |p|^2] (|p|^2 as sq3_rn)
// beside their original indices; then sorts the centroids by cell the same
// way, so that the warps of a query block take neighbouring centroids and
// read neighbouring ranges. The order inside a cell follows the atomics and
// is not fixed; nothing downstream depends on it (the queries fold their
// candidates by a set function). The grid has at most gmax x gmax cells,
// gmax = min(64, isqrt(N)) from the shapes, so a wrapper sizes the workspace
// with torch.empty and no value is read back.
//
// One cluster of cs blocks a cloud (cs, 1 to 8, a launch attribute:
// cuda_kernels.cell_grid_cluster, from B, the entries a cloud and the
// card's SMs: slices of 1,000 entries or more, and clusters that fill at
// most two thirds of the SMs, or 4 blocks a cloud if that is more). Block
// r of the cluster takes the r-th contiguous slice of the points and of
// the centroids:
// 1. it reduces its slices' extent and maxima into shared memory; after a
//    cluster barrier every block reads the cs partials through distributed
//    shared memory and computes the same parameters (min and max are exact
//    in any order, and the parameters are then the same float operations
//    as before: bit for bit the one-block pass's and the CPU mirrors');
//    rank 0 writes `grid`;
// 2. it counts its slices into its own shared histograms of the cells
//    (points and centroids at once); after a cluster barrier each block
//    reads, for the 4 cells of each thread, the cs histograms (int4 loads
//    through distributed shared memory): the cell's total and the sum over
//    the lower ranks, its own base inside the cell. An exclusive block scan
//    of the totals gives the starts (rank 0 writes them); each block
//    scatters its slices with shared atomics from start + base;
// 3. a split cluster barrier, arrived at after the block's last read of a
//    peer's histograms and waited on before it leaves, so no block's shared
//    memory goes while a peer may read it.
// Each cell thus holds block 0's points, then block 1's, ...: the same sets
// as one block's counting sort. 64 KB of dynamic shared memory a block (four
// tables of gmax^2 ints), two blocks an SM, so B x cs <= 132 clusters fit at
// once. PR 19's one-block pass is scripts/variants/cell_grid_one_block.cu.
// Bound: the bytes, each coordinate read three times from a block's slice
// (~20 MB at the dense FP1 kNN site, ~6 us at 3.35 TB/s). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (scripts/kernel_variants.py cell_grid, the
// one-block pass in turns; PERF.md §6): at B=20, 4 blocks a cloud is the
// fastest size at every site, from the dense FP1 kNN site (0.055 ms against
// the one block's 0.155; 6 blocks 0.073) and dense SA1 (0.075 against 0.202)
// down to the nearest route's PROD SA1 (0.024 against 0.037); at its SA2
// (B=20 x 2,500 points, 625 centroids) 3 blocks take 0.0125 against the one
// block's 0.0119, the cluster's barriers and tables outweighing slices of
// ~1,000 entries (and one block of this pass 0.0146). Slice loops unrolled
// by 4, or one block an SM with no spill (64 registers; 48 bytes of stack at
// two), measured no faster.
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

#include <cooperative_groups.h>

constexpr int kGridThreads = 1024;
constexpr int kGridMax = 64;      // cuda_kernels.NEAREST_GRID_MAX: cells a side at most
constexpr int kGridParams = 6;    // ints a cloud: xmin, ymin, inv_h, rc2 or M (float bits), gx, gy
constexpr int kGridClusterMax = 8;  // cuda_kernels.CELL_GRID_CLUSTER_MAX: blocks a cloud at most
constexpr int kGridMinBlocks = 2;   // blocks an SM the grid kernels ask registers for

// The cell coordinate of an offset d = fl(x - xmin) on an axis of g cells.
__device__ __forceinline__ int cell_coord(float d, float inv_h, int g) {
  const float q = __fmul_rn(d, inv_h);
  return q > 0.0f ? static_cast<int>(fminf(q, static_cast<float>(g - 1))) : 0;
}

// Exclusive scans over the whole block of two sequences, a[k] and b[k]
// being thread t's entries 4 t + k. `warp_sums` holds 2 x 32 ints.
__device__ __forceinline__ void block_exclusive_scan2(int (&a)[4], int (&b)[4],
                                                      int (*warp_sums)[32]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sa = a[0] + a[1] + a[2] + a[3], sb = b[0] + b[1] + b[2] + b[3];
  const int ia = warp_incl_scan(sa, lane), ib = warp_incl_scan(sb, lane);
  if (lane == 31) {
    warp_sums[0][warp] = ia;
    warp_sums[1][warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    warp_sums[0][lane] = warp_incl_scan(warp_sums[0][lane], lane);
    warp_sums[1][lane] = warp_incl_scan(warp_sums[1][lane], lane);
  }
  __syncthreads();
  int ra = ia - sa + (warp > 0 ? warp_sums[0][warp - 1] : 0);
  int rb = ib - sb + (warp > 0 ? warp_sums[1][warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int va = a[k], vb = b[k];
    a[k] = ra;
    b[k] = rb;
    ra += va;
    rb += vb;
  }
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

// The extent and maxima v[6] (x min, x max, y min, y max, mp, mc) of the
// lane's values, reduced over the warp.
__device__ __forceinline__ void warp_reduce6(float (&v)[6]) {
#pragma unroll
  for (int q = 0; q < 6; ++q) v[q] = (q == 0 || q == 2) ? warp_min(v[q]) : warp_max(v[q]);
}

// Ints of one of the pass's four tables of cells: gmax^2 rounded up to int4.
__host__ __device__ __forceinline__ int cell_table(int gmax) { return (gmax * gmax + 3) & ~3; }

// The grid pass of one cloud (blockIdx.y), run by a cluster of blocks of
// kGridThreads threads along x (see the header): the grid parameters, the
// points in cell order with their indices and each cell's start (cells past
// gx * gy start at n), and the centroids in cell order. kByExtent: the cells
// from the extent alone and M in place of rc2 (kNN; r2 is not read).
// Dynamic shared memory: 4 cell_table(gmax) ints.
template <bool kByExtent = false>
__device__ __forceinline__ void cell_grid_pass(const float* __restrict__ cent,
                                               const float* __restrict__ xyz,
                                               float4* __restrict__ spts,
                                               int* __restrict__ sidx, int* __restrict__ starts,
                                               int* __restrict__ corder, int* __restrict__ grid,
                                               int n, int c, int gmax, float r2) {
  extern __shared__ int4 cell_tables[];  // counts of points, of centroids; cursors of each
  __shared__ float part[6];              // this block's extent and maxima, read by its peers
  __shared__ float red[6][32];
  __shared__ int warp_sums[2][32];
  __shared__ float prm[3];  // xmin, ymin, inv_h
  __shared__ int dims[2];   // gx, gy
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y;
  const int g4 = cell_table(gmax);
  int* cnt_p = reinterpret_cast<int*>(cell_tables);
  int* cnt_c = cnt_p + g4;
  int* cur_p = cnt_c + g4;
  int* cur_c = cur_p + g4;
  const float* xb = xyz + static_cast<size_t>(b) * n * 3;
  const float* cb = cent + static_cast<size_t>(b) * c * 3;
  // the block's slices: points [p0, p1), centroids [q0, q1)
  const int pshare = (n + cs - 1) / cs, cshare = (c + cs - 1) / cs;
  const int p0 = min(n, rank * pshare), p1 = min(n, p0 + pshare);
  const int q0 = min(c, rank * cshare), q1 = min(c, q0 + cshare);
  for (int i = t; i < g4 / 2; i += kGridThreads) cell_tables[i] = make_int4(0, 0, 0, 0);

  // 1. the extent and maxima: the block's partials, then the cluster's
  float v[6] = {INFINITY, -INFINITY, INFINITY, -INFINITY, 0.0f, 0.0f};  // x, y extent, mp, mc
  for (int j = p0 + t; j < p1; j += kGridThreads) {
    const float x = xb[3 * j], y = xb[3 * j + 1], z = xb[3 * j + 2];
    v[0] = fminf(v[0], x);
    v[1] = fmaxf(v[1], x);
    v[2] = fminf(v[2], y);
    v[3] = fmaxf(v[3], y);
    v[4] = fmaxf(v[4], sq3_rn(x, y, z));
  }
  for (int i = q0 + t; i < q1; i += kGridThreads) {
    v[5] = fmaxf(v[5], sq3_rn(cb[3 * i], cb[3 * i + 1], cb[3 * i + 2]));
  }
  warp_reduce6(v);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) red[q][warp] = v[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) v[q] = red[q][lane];
    warp_reduce6(v);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 6; ++q) part[q] = v[q];
    }
  }
  cluster.sync();  // every block's partials complete and visible; tables zeroed
  if (warp == 0) {
    float w[6] = {INFINITY, -INFINITY, INFINITY, -INFINITY, 0.0f, 0.0f};
    if (lane < cs) {
      const float* pr = cluster.map_shared_rank(part, lane);
#pragma unroll
      for (int q = 0; q < 6; ++q) w[q] = pr[q];
    }
    warp_reduce6(w);
    if (lane == 0) {
      const float xmin = w[0], ymin = w[2];
      const float ex = __fsub_rn(w[1], xmin), ey = __fsub_rn(w[3], ymin);
      float rc2, inv_h;
      if constexpr (kByExtent) {
        rc2 = __fadd_rn(w[5], w[4]);  // M
        inv_h = fminf(__fdiv_rn(static_cast<float>(gmax) - 0.5f, fmaxf(ex, ey)), 3.4028235e38f);
      } else {
        const float s = __fadd_rn(__fadd_rn(w[5], w[4]), r2);
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
      if (rank == 0) {
        int* gp = grid + static_cast<size_t>(b) * kGridParams;
        gp[0] = __float_as_int(xmin);
        gp[1] = __float_as_int(ymin);
        gp[2] = __float_as_int(inv_h);
        gp[3] = __float_as_int(rc2);
        gp[4] = gx;
        gp[5] = gy;
      }
    }
  }
  __syncthreads();
  const float xmin = prm[0], ymin = prm[1], inv_h = prm[2];
  const int gx = dims[0], gy = dims[1];
  auto cell_of = [&](float x, float y) {
    return cell_coord(__fsub_rn(y, ymin), inv_h, gy) * gx +
           cell_coord(__fsub_rn(x, xmin), inv_h, gx);
  };

  // 2. the block's counts, then each cell's total, this block's base in it
  // and the starts
  for (int j = p0 + t; j < p1; j += kGridThreads)
    atomicAdd(&cnt_p[cell_of(xb[3 * j], xb[3 * j + 1])], 1);
  for (int i = q0 + t; i < q1; i += kGridThreads)
    atomicAdd(&cnt_c[cell_of(cb[3 * i], cb[3 * i + 1])], 1);
  cluster.sync();  // every block's counts complete and visible
  int tp[4] = {0, 0, 0, 0}, tc[4] = {0, 0, 0, 0};  // cells 4t .. 4t + 3 (past gx * gy: 0)
  if (4 * t < g4) {
    for (int q = 0; q < cs; ++q) {
      if (q == rank) {  // the lower ranks' counts: this block's bases
        reinterpret_cast<int4*>(cur_p)[t] = make_int4(tp[0], tp[1], tp[2], tp[3]);
        reinterpret_cast<int4*>(cur_c)[t] = make_int4(tc[0], tc[1], tc[2], tc[3]);
      }
      const int4 hp = reinterpret_cast<const int4*>(cluster.map_shared_rank(cnt_p, q))[t];
      const int4 hc = reinterpret_cast<const int4*>(cluster.map_shared_rank(cnt_c, q))[t];
      tp[0] += hp.x;
      tp[1] += hp.y;
      tp[2] += hp.z;
      tp[3] += hp.w;
      tc[0] += hc.x;
      tc[1] += hc.y;
      tc[2] += hc.z;
      tc[3] += hc.w;
    }
  }
  asm volatile("barrier.cluster.arrive;" ::: "memory");  // no more reads of a peer's counts
  block_exclusive_scan2(tp, tc, warp_sums);  // the cells' starts
  int* st = starts + static_cast<size_t>(b) * (gmax * gmax + 1);
  if (4 * t < g4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * t + k;
      cur_p[i] += tp[k];
      cur_c[i] += tc[k];
      if (rank == 0 && i < gmax * gmax) st[i] = tp[k];  // n past the gx * gy cells
    }
  }
  if (rank == 0 && t == 0) st[gmax * gmax] = n;
  __syncthreads();

  // 3. the block's slices scattered from its bases
  float4* sp = spts + static_cast<size_t>(b) * n;
  int* si = sidx + static_cast<size_t>(b) * n;
  for (int j = p0 + t; j < p1; j += kGridThreads) {
    const float x = xb[3 * j], y = xb[3 * j + 1], z = xb[3 * j + 2];
    const int pos = atomicAdd(&cur_p[cell_of(x, y)], 1);
    sp[pos] = make_float4(x, y, z, sq3_rn(x, y, z));
    si[pos] = j;
  }
  int* co = corder + static_cast<size_t>(b) * c;
  for (int i = q0 + t; i < q1; i += kGridThreads)
    co[atomicAdd(&cur_c[cell_of(cb[3 * i], cb[3 * i + 1])], 1)] = i;
  asm volatile("barrier.cluster.wait;" ::: "memory");  // no peer reads this block's counts now
}

// A grid kernel for a library: `cell_grid_pass` under the library's own
// kernel name, so that a trace tells the libraries apart. Two blocks an SM.
#define CELL_GRID_KERNEL(name)                                                                 \
  __global__ void __launch_bounds__(kGridThreads, kGridMinBlocks)                              \
  name(const float* __restrict__ cent, const float* __restrict__ xyz,                          \
       float4* __restrict__ spts, int* __restrict__ sidx, int* __restrict__ starts,            \
       int* __restrict__ corder, int* __restrict__ grid, int n, int c, int gmax, float r2) {   \
    cell_grid_pass(cent, xyz, spts, sidx, starts, corder, grid, n, c, gmax, r2);               \
  }

// The same with the cells from the extent alone (cell_grid_pass<true>).
#define EXTENT_GRID_KERNEL(name)                                                               \
  __global__ void __launch_bounds__(kGridThreads, kGridMinBlocks)                              \
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

// Launch `kernel` (a CELL_GRID_KERNEL or EXTENT_GRID_KERNEL) on the b clouds
// of `w`, a cluster of cs blocks (1 to kGridClusterMax) a cloud; a launch
// the card refuses returns its error.
template <typename Kernel>
static cudaError_t launch_cell_grid(Kernel kernel, const float* cent, const float* xyz,
                                    const CellWs& w, int b, int n, int c, int gmax, float r2,
                                    int cs, cudaStream_t stream) {
  if (cs < 1 || cs > kGridClusterMax || gmax < 1 || gmax > kGridMax) return cudaErrorInvalidValue;
  const size_t smem = 4 * sizeof(int) * static_cast<size_t>(cell_table(gmax));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, b);
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, cent, xyz, w.spts, w.sidx, w.starts, w.corder, w.grid,
                           n, c, gmax, r2);
  return err != cudaSuccess ? err : cudaGetLastError();
}

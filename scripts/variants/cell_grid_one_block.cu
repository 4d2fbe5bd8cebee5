// PR 19's grid pass of the cell grid (rows 2a, 4a, 5a and 12 of PERF.md),
// kept as a variant and timed against the package's cluster pass by
// scripts/kernel_variants.py (`cell_grid`, and `knn_grid` through
// knn_cull_ldg.cu): one block of kGridThreads threads a cloud reduces the
// extent and maxima, counts the points into a shared histogram, scans it,
// scatters, and does the same for the centroids; B = 20 clouds keep 20 of
// the card's 132 SMs busy. Its grid is the cluster pass's bit for bit (the
// same float operations on the same extent and maxima), its order inside a
// cell another.
//
// Built from this file alone (nvcc -I csrc): it includes csrc/cell_grid.cuh,
// so its library also holds the package's pass, under kernel names of its
// own, and the harness times both in one process.
#include "cell_grid.cuh"

// In-place exclusive scan of a[0, len) (len <= 4 * kGridThreads) by the
// whole block. `warp_sums` holds 32 ints.
__device__ void one_block_exclusive_scan(int* a, int len, int* warp_sums) {
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

// PR 19's grid pass of one cloud (blockIdx.x), run by a whole block of
// kGridThreads threads: the grid parameters, the points in cell order with
// their indices and each cell's start (cells past gx * gy start at n), and
// the centroids in cell order. kByExtent: the cells from the extent alone
// and M in place of rc2 (kNN; r2 is not read).
template <bool kByExtent = false>
__device__ __forceinline__ void cell_grid_pass_one_block(const float* __restrict__ cent,
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
  one_block_exclusive_scan(hist, cells, warp_sums);
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
  one_block_exclusive_scan(hist, cells, warp_sums);
  int* co = corder + static_cast<size_t>(b) * c;
  for (int i = t; i < c; i += kGridThreads) co[atomicAdd(&hist[cell_of(cb[3 * i], cb[3 * i + 1])], 1)] = i;
}


// The two passes under this library's own kernel names: PR 19's one block a
// cloud (radius form and extent form), and the package's cluster pass.
#define ONE_BLOCK_GRID_KERNEL(name, by_extent)                                                 \
  __global__ void __launch_bounds__(kGridThreads)                                              \
  name(const float* __restrict__ cent, const float* __restrict__ xyz,                          \
       float4* __restrict__ spts, int* __restrict__ sidx, int* __restrict__ starts,            \
       int* __restrict__ corder, int* __restrict__ grid, int n, int c, int gmax, float r2) {   \
    cell_grid_pass_one_block<by_extent>(cent, xyz, spts, sidx, starts, corder, grid, n, c,     \
                                        gmax, r2);                                             \
  }
ONE_BLOCK_GRID_KERNEL(one_block_grid_kernel, false)
ONE_BLOCK_GRID_KERNEL(one_block_extent_grid_kernel, true)
CELL_GRID_KERNEL(cluster_grid_kernel)
EXTENT_GRID_KERNEL(cluster_extent_grid_kernel)

// PR 19's launch: one block a cloud.
template <typename Kernel>
static cudaError_t launch_one_block(Kernel kernel, const float* cent, const float* xyz,
                                    const CellWs& w, int b, int n, int c, int gmax, float r2,
                                    cudaStream_t stream) {
  kernel<<<b, kGridThreads, 0, stream>>>(cent, xyz, w.spts, w.sidx, w.starts, w.corder, w.grid,
                                         n, c, gmax, r2);
  return cudaGetLastError();
}

// The grid pass alone on the workspace ws (cell_grid.cuh's CellWs) of b
// clouds of n points and c centroids: PR 19's one block a cloud.
// by_extent: the cells from the extent (kNN), else from the radius r2.
extern "C" int cell_grid_one_block_launch(const float* cent, const float* xyz, int* ws, int b,
                                          int n, int c, int gmax, float r2, int by_extent,
                                          void* stream) {
  const CellWs w = carve_cells(ws, b, n, c, gmax);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_extent ? launch_one_block(one_block_extent_grid_kernel, cent, xyz, w, b, n, c, gmax,
                                      r2, s)
                   : launch_one_block(one_block_grid_kernel, cent, xyz, w, b, n, c, gmax, r2, s);
}

// ... and the package's pass, a cluster of cs blocks a cloud.
extern "C" int cell_grid_cluster_launch(const float* cent, const float* xyz, int* ws, int b,
                                        int n, int c, int gmax, float r2, int by_extent, int cs,
                                        void* stream) {
  const CellWs w = carve_cells(ws, b, n, c, gmax);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_extent ? launch_cell_grid(cluster_extent_grid_kernel, cent, xyz, w, b, n, c, gmax,
                                      r2, cs, s)
                   : launch_cell_grid(cluster_grid_kernel, cent, xyz, w, b, n, c, gmax, r2, cs, s);
}

// How many clusters of cs blocks of the package's pass (extent form, gmax
// cells a side) the current card holds at once (cudaOccupancyMaxActiveClusters),
// or -(the CUDA error).
extern "C" int cell_grid_cluster_resident(int cs, int gmax) {
  const size_t smem = 4 * sizeof(int) * static_cast<size_t>(cell_table(gmax));
  cudaError_t err = allow_smem(cluster_extent_grid_kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1);
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, cluster_extent_grid_kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

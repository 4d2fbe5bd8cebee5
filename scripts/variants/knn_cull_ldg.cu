// PR 19's design of kNN's query on the cell grid (row 2a of PERF.md), kept
// as a variant and timed against the package's by scripts/kernel_variants.py
// (`knn_grid`): the same boxes, rings and stop rule, but each row segment of
// a ring scanned pair by pair, every lane loading the source (float4 and, on
// the insert path, its index) by __ldg from device memory: one dependent
// broadcast load and a vote a pair, over segments of ~4 sources.
//
// Built from this file alone (nvcc -I csrc): it includes csrc/
// knn_interpolate.cu and cell_grid_one_block.cu beside it, so its library
// holds the package's entries, this query after the package's cluster grid
// pass (`knn_interpolate_grid_ldg_launch`) and PR 19's whole design, the
// one-block grid pass and this query (`knn_interpolate_grid_pr19_launch`).
#include "knn_interpolate.cu"
#include "cell_grid_one_block.cu"

// Score the sorted sources [lo, hi) for the lane's target: a warp vote, then
// the insert in (d2, index) order.
__device__ __forceinline__ void knn_scan_ldg(const float4* __restrict__ sp, const int* __restrict__ si,
                                         int lo, int hi, float tx, float ty, float tz, float tn,
                                         Top3& top) {
#pragma unroll 4
  for (int j = lo; j < hi; ++j) {
    const float4 p = __ldg(sp + j);
    const float d = expanded_d2_sel(tn, dot3_rn(tx, ty, tz, p.x, p.y, p.z), p.w);
    if (__any_sync(0xffffffffu, d <= top.d[2])) {  // warp-uniform; the insert is branch-free
      const int id = __ldg(si + j);
      const bool c2 = lex_less(d, id, top.d[2], top.i[2]);
      const bool c1 = lex_less(d, id, top.d[1], top.i[1]);
      const bool c0 = lex_less(d, id, top.d[0], top.i[0]);
      top.d[2] = c1 ? top.d[1] : (c2 ? d : top.d[2]);
      top.i[2] = c1 ? top.i[1] : (c2 ? id : top.i[2]);
      top.d[1] = c0 ? top.d[0] : (c1 ? d : top.d[1]);
      top.i[1] = c0 ? top.i[0] : (c1 ? id : top.i[1]);
      top.d[0] = c0 ? d : top.d[0];
      top.i[0] = c0 ? id : top.i[0];
    }
  }
}

// PR 19's query. xs (b, s, f), pt (b, t, 3) and the grid of knn_grid_kernel (sources as its
// points, targets as its centroids) -> out, idx, w as knn_kernel; `scored`
// (b, t), or NULL: the sources each target's warp scanned. Grid (ceil(t /
// kThreads), b).
__global__ void __launch_bounds__(kThreads)
knn_cull_ldg_kernel(const float* __restrict__ xs, const float* __restrict__ pt,
                const float4* __restrict__ spts, const int* __restrict__ sidx,
                const int* __restrict__ starts, const int* __restrict__ corder,
                const int* __restrict__ grid, float* __restrict__ out, int* __restrict__ idx_out,
                float* __restrict__ w_out, int* __restrict__ scored, int s, int t, int f,
                int gmax) {
  __shared__ int4 tab_i[kWarps][32];    // the picks and the target of each lane
  __shared__ float4 tab_w[kWarps][32];  // w0, w1, w2, their sum
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int first = (blockIdx.x * kWarps + warp) * 32;
  if (first >= t) return;  // no block barrier below: a warp past the end just leaves
  const bool live = first + lane < t;  // past the last target: the last again, never written
  const int ti = corder[static_cast<size_t>(b) * t + min(first + lane, t - 1)];
  const float* tp = pt + (static_cast<size_t>(b) * t + ti) * 3;
  const float tx = tp[0], ty = tp[1], tz = tp[2];
  const float tn = sq3_rn(tx, ty, tz);
  const int* gp = grid + static_cast<size_t>(b) * kGridParams;
  const float inv_h = __int_as_float(gp[2]);
  const int gx = gp[4], gy = gp[5];
  const float qx = __fmul_rn(__fsub_rn(tx, __int_as_float(gp[0])), inv_h);
  const float qy = __fmul_rn(__fsub_rn(ty, __int_as_float(gp[1])), inv_h);
  const int cx = qx > 0.0f ? static_cast<int>(fminf(qx, static_cast<float>(gx - 1))) : 0;
  const int cy = qy > 0.0f ? static_cast<int>(fminf(qy, static_cast<float>(gy - 1))) : 0;
  // the box: the warp's targets' cells, then ring by ring
  int c0 = __reduce_min_sync(0xffffffffu, cx), c1 = __reduce_max_sync(0xffffffffu, cx);
  int r0 = __reduce_min_sync(0xffffffffu, cy), r1 = __reduce_max_sync(0xffffffffu, cy);
  const int* st = starts + static_cast<size_t>(b) * (gmax * gmax + 1);
  const float4* sp = spts + static_cast<size_t>(b) * s;
  const int* si = sidx + static_cast<size_t>(b) * s;

  Top3 top;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    top.d[q] = INFINITY;
    top.i[q] = 0;
  }
  for (int row = r0; row <= r1; ++row)
    knn_scan_ldg(sp, si, st[row * gx + c0], st[row * gx + c1 + 1], tx, ty, tz, tn, top);
  const double h = 1.0 / static_cast<double>(inv_h);
  const double margin = static_cast<double>(__int_as_float(gp[3])) * kKnnMargin;
  const double slack = (fmax(fabs(static_cast<double>(qx)), fabs(static_cast<double>(qy))) + 65.0) *
                       kKnnSlack;
  while (c0 > 0 || r0 > 0 || c1 < gx - 1 || r1 < gy - 1) {  // the box does not cover the grid
    double gap = INFINITY;  // cells from the target to the box's inner sides
    if (c0 > 0) gap = fmin(gap, static_cast<double>(qx) - c0);
    if (c1 < gx - 1) gap = fmin(gap, static_cast<double>(c1 + 1) - qx);
    if (r0 > 0) gap = fmin(gap, static_cast<double>(qy) - r0);
    if (r1 < gy - 1) gap = fmin(gap, static_cast<double>(r1 + 1) - qy);
    const double lb = (gap - slack) * h;
    const bool done =
        gap > slack && static_cast<double>(top.d[2]) < lb * lb * (1.0 - kKnnMargin) - margin;
    if (__all_sync(0xffffffffu, done)) break;
    const int n0 = max(c0 - 1, 0), n1 = min(c1 + 1, gx - 1);
    const int m0 = max(r0 - 1, 0), m1 = min(r1 + 1, gy - 1);
    for (int row = m0; row <= m1; ++row) {
      const int* sr = st + row * gx;
      if (row < r0 || row > r1) {
        knn_scan_ldg(sp, si, sr[n0], sr[n1 + 1], tx, ty, tz, tn, top);
      } else {
        if (n0 < c0) knn_scan_ldg(sp, si, sr[n0], sr[c0], tx, ty, tz, tn, top);
        if (n1 > c1) knn_scan_ldg(sp, si, sr[c1 + 1], sr[n1 + 1], tx, ty, tz, tn, top);
      }
    }
    c0 = n0;
    c1 = n1;
    r0 = m0;
    r1 = m1;
  }

  const float w0 = __frcp_rn(fmaxf(top.d[0], 1e-16f));
  const float w1 = __frcp_rn(fmaxf(top.d[1], 1e-16f));
  const float w2 = __frcp_rn(fmaxf(top.d[2], 1e-16f));
  const float wsum = __fadd_rn(__fadd_rn(w0, w1), w2);
  if (live) {
    const size_t o = static_cast<size_t>(b) * 3 * t + ti;
    idx_out[o] = top.i[0];
    idx_out[o + t] = top.i[1];
    idx_out[o + 2 * t] = top.i[2];
    w_out[o] = __fdiv_rn(w0, wsum);
    w_out[o + t] = __fdiv_rn(w1, wsum);
    w_out[o + 2 * t] = __fdiv_rn(w2, wsum);
    if (scored != nullptr) {
      int cnt = 0;
      for (int row = r0; row <= r1; ++row) cnt += st[row * gx + c1 + 1] - st[row * gx + c0];
      scored[static_cast<size_t>(b) * t + ti] = cnt;
    }
  }
  tab_i[warp][lane] = make_int4(top.i[0], top.i[1], top.i[2], ti);
  tab_w[warp][lane] = make_float4(w0, w1, w2, wsum);
  __syncwarp();
  // the warp's output rows, a flat walk: element e is feature e % f of its
  // target e / f, each row's features on neighbouring lanes
  const int n_el = min(32, t - first) * f;
  const float* xb = xs + static_cast<size_t>(b) * s * f;
  float* ob = out + static_cast<size_t>(b) * t * f;
  for (int e = lane; e < n_el; e += 32) {
    const int tl = e / f, ch = e - tl * f;
    const int4 j = tab_i[warp][tl];
    const float4 v = tab_w[warp][tl];
    const float acc = __fmaf_rn(xb[static_cast<size_t>(j.z) * f + ch], v.z,
                                __fmaf_rn(xb[static_cast<size_t>(j.y) * f + ch], v.y,
                                          __fmul_rn(xb[static_cast<size_t>(j.x) * f + ch], v.x)));
    ob[static_cast<size_t>(j.w) * f + ch] = __fdiv_rn(acc, v.w);
  }
}

// xs (b, s, f), ps (b, s, 3), pt (b, t, 3) -> out, idx, w and `scored` as
// knn_interpolate_grid_launch: the package's cluster grid pass (cs blocks a
// cloud), then PR 19's query.
extern "C" int knn_interpolate_grid_ldg_launch(const float* xs, const float* ps, const float* pt,
                                               float* out, int* idx, float* w, int* ws,
                                               int* scored, int b, int s, int t, int f, int gmax,
                                               int cs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CellWs cw = carve_cells(ws, b, s, t, gmax);
  cudaError_t err = launch_cell_grid(knn_grid_kernel, pt, ps, cw, b, s, t, gmax, 0.0f, cs, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kThreads - 1) / kThreads, b);
  knn_cull_ldg_kernel<<<grid, kThreads, 0, st>>>(xs, pt, cw.spts, cw.sidx, cw.starts, cw.corder,
                                                 cw.grid, out, idx, w, scored, s, t, f, gmax);
  return cudaGetLastError();
}

// ... and PR 19's design whole: the one-block grid pass, then its query.
extern "C" int knn_interpolate_grid_pr19_launch(const float* xs, const float* ps,
                                                const float* pt, float* out, int* idx, float* w,
                                                int* ws, int* scored, int b, int s, int t, int f,
                                                int gmax, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CellWs cw = carve_cells(ws, b, s, t, gmax);
  cudaError_t err =
      launch_one_block(one_block_extent_grid_kernel, pt, ps, cw, b, s, t, gmax, 0.0f, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kThreads - 1) / kThreads, b);
  knn_cull_ldg_kernel<<<grid, kThreads, 0, st>>>(xs, pt, cw.spts, cw.sidx, cw.starts, cw.corder,
                                                 cw.grid, out, idx, w, scored, s, t, f, gmax);
  return cudaGetLastError();
}

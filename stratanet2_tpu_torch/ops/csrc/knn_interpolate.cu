// Exact 3-NN inverse-distance-squared interpolation.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_knn_kernel (pallas_call in
// _knn_pallas_raw, wrapped by knn_interpolate_pallas). It computes what the
// JAX exact path _knn_single (stratanet2_tpu/ops/knn.py:71-96) computes:
// expanded d2 = max((|t|^2 - 2 t.s) + |s|^2, 0), the three least in
// (d2, index) order (three first-argmin passes), weights 1/max(d2, 1e-16)
// from those same clamped d2, and sum_j w_j x_j / sum_j w_j, each rounded as
// XLA rounds it (fma chains, see common.cuh). The TPU kernel's hi/lo-bf16
// 11-wide dot, re-subtracted d2 and one-hot MXU gather are not carried over.
//
// Bound on the H100: issued instructions. Each target scores every source of
// its cloud: at the PROD serve and train steps 20 x 10000 x 2500 = 5.0e8
// pairs at FP1 and 20 x 2500 x 625 = 3.1e7 at FP2. The bytes (features,
// positions, outputs) are ~30 MB, ~0.01 ms at 3.35 TB/s.
//
// Design. A block of 8 warps owns a tile of targets of one cloud, kR = 1
// target a lane. Its warps form 8/W groups of W warps; the W warps of a group split
// the cloud's sources into W contiguous slices, each keeping its own top 3
// for the group's 32 targets. The block stages the sources in shared memory
// as float4 [x, y, z, |s|^2] (one broadcast LDS.128 a source), in chunks of
// at most kChunk (the whole cloud at both PROD shapes: 40 KB at FP1, 10 KB
// at FP2); a larger cloud is walked chunk by chunk, each warp taking its
// slice of every chunk. cuda_kernels.knn_slices picks W: the fewest slices
// that give the card 64 warps an SM. At FP1 W = 2: 1,580 blocks (12,640
// warps) of 44 KB of shared memory, 5 blocks (40 warps) an SM, 2.4 waves; at
// FP2 W = 8: 1,580 blocks of 11 KB, 8 blocks (64 warps) an SM, 1.5 waves.
// 40 registers a thread, no spill.
//
// The top 3 changes rarely for one lane but often for some lane of a warp (a
// lane's third best moves about 3 ln(L) times in a scan of L sources, so
// until ~100 sources into a slice almost every source moves some lane's).
// So the common path of a pair is the distance (FMUL, FFMA, FFMA,
// FFMA(-2, ab, |t|^2), FADD(+|s|^2)), one FSETP against the third best and a
// warp vote; the insert runs only when a lane of the warp keeps the source,
// as a warp-uniform branch around branch-free selects. The scan loop is 13
// SASS a pair on that path and 25 with the insert (chip_smoke.py phase 16);
// at the PROD step's 5.3e8 pairs that is an issue floor of 0.21 and 0.40 ms,
// and the kernel runs at the second. Measured on an H100 (PERF.md;
// scripts/kernel_variants.py): 0.33-0.35 ms at FP1 against the parent's
// 0.428; kR = 2 and 4 (one LDS.128 for 2 or 4 chains, but a vote over 64 or
// 128 chains) 0.349 and 0.444; a per-lane branch instead of the vote 0.340
// with more code; the scan alone, the insert cut out, 0.239. kR stays a
// constant of the code: the same loop written for one target without the r
// loops compiles the insert to 28 SASS a pair, not 25, and measured 0.347
// against 0.329 ms at FP1 and 0.057 against 0.052 at FP2.
//
// Exactness, proved here and held by chip_smoke.py (0 differing indices):
// - fma(-2, ab, a) == fsub(a, fmul(2, ab)) bit for bit while 2ab is finite
//   (common.cuh::expanded_d2_sel): doubling is exact, so both round the one
//   value a - 2ab once.
// - The vote tests the unclamped v < d[2]; a source that enters has
//   max(v, 0) < d[2], so v < d[2]: the test misses none. The insert itself
//   compares the clamped d = max(v, 0) with strict <.
// - A warp scans its sources in increasing index order and inserts with
//   strict <, so a later source never displaces an equal d2: its list is the
//   three least of its sources in (d2, index) order. Each of the three least
//   of the cloud lies in some warp's set, and fewer than three elements of
//   that set precede it in (d2, index) order (they would precede it in the
//   cloud too), so it is in that warp's list. The union of the lists thus
//   holds the cloud's three least, and a merge on (d2, index) picks them:
//   the picks of the full scan, ties (the many d2 = 0 the clamp makes among
//   them) to the lowest index. A slice with fewer than three sources keeps
//   (+inf, 0) entries, which lose to every real source (S >= 3, finite d2).
// Weights and output round as cuda_kernels.knn_interpolate_plain does
// (__frcp_rn, __fadd_rn, __fmaf_rn, __fdiv_rn). After the merge the group's
// first warp writes idx and w and a table of picks and weights; the block
// then walks its tile's output rows, which are consecutive in `out`, as flat
// values, so the source-row loads and the stores are coalesced.
//
// Dense plots: the cell grid (knn_interpolate_grid_launch; cuda_kernels.
// knn_path "grid": S >= KNN_GRID_MIN_S sources, as FP1 of plots of 65,536
// points, S = 16,384, T = 65,536: 2.15e10 pairs a step, 14 ms above; PROD
// keeps knn_kernel). Exact 3-NN needs only the sources near each target, so
// two kernels under one launch count: knn_grid_kernel, the grid pass of
// cell_grid.cuh (a cluster of cs blocks a cloud) with the cells from the
// sources' extent (gmax = min(64, isqrt(S)) a side: ~4 sources a cell at S =
// 16,384), the sources sorted by cell and the targets in cell order; then
// knn_cull_kernel, a warp for 32 targets neighbouring in cell order (8 warps
// a block, no block barrier). The warp scans a box of source cells ring by
// ring: first the bounding box of its targets' cells, then each ring around
// it, every cell once (the rows of a new ring whole, the old rows' two new
// cells). The ring's row segments are flattened by a warp prefix sum and
// staged 32 sources at a time in the warp's double buffer in shared memory
// (knn_scan_added: a coalesced 16-byte load a lane, the next tile in flight
// while the current one is scored). A source is scored by the
// vote-then-insert loop above, with two changes: sources come in cell order,
// not index order, so the insert compares (d2, index) lexicographically
// (lex_less) and the vote takes d2 <= the third best (a tie may enter by its
// index); and one vote covers kVote = 2 sources, both then inserted (each
// insert is branch-free and exact: a source that does not precede the third
// entry changes nothing). The warp's lists are then the least three of the sources scanned
// in (d2, index) order, as a set function of them; scanning more sources
// than needed never changes the result, and none is scored twice. After
// each ring a lane may stop when its third best is strictly below a proven
// lower bound on the computed d2 of every source outside the box; the warp
// stops when all lanes may (__all_sync) or when the box covers the grid.
// PR 19's scan, each row segment read pair by pair from device memory
// (__ldg into every lane), is scripts/variants/knn_cull_ldg.cu.
//
// The stop rule's bound, cell_grid.cuh's rounding argument run the other
// way (u = 2^-24, q = fl(fl(x - xmin) inv_h) as the grid pass rounds it):
// - Cells. Let the box hold columns [c0, c1]. A source in a column below c0
//   (only if c0 > 0) has q_s < c0, and one above c1 (only if c1 < gx - 1)
//   has q_s >= c1 + 1 (cell = floor(min(q, g - 1)) for q > 0, else 0; the
//   target's cell lies in [c0, c1]). q carries two roundings: |q - Q| <=
//   2.0001u |Q| for the exact Q = (x - xmin) inv_h, with |Q| < 64 for a
//   source and |Q| <= |q| (1 + 3u) for the target. So such a source lies at
//   |Q_s - Q_t| >= G_x - sl, G_x = min(q_t - c0, c1 + 1 - q_t) over the
//   sides that are not the grid's edge, sl = 2^-22 (max(|q_tx|, |q_ty|) +
//   65) (twice the rounding), and likewise in y; a source outside the box
//   is outside in x or in y, so its true xy distance, and its true 3-D
//   distance D^(1/2), is at least L = (G - sl) / inv_h, G = min(G_x, G_y).
// - Distances. With a = sq3_rn(t), b = sq3_rn(s), ab = dot3_rn(t, s) and
//   y = fl(a - 2 ab) + b: |y - D| <= (2 g3 + 2u (1 + g3)) S_ts <= 8.01u M_t,
//   S_ts = |t|^2 + |s|^2 <= M_t = the cloud's max |t|^2 + max |s|^2
//   (g3 = 3u / (1 - 3u)); E = max(fl(y), 0) >= (1 - u) y when y >= 0 and E
//   = 0 > (1 - u) D - 8.01u M_t otherwise: E >= (1 - u) D - 8.01u M_t.
//   The grid pass stores M = fl(mc + mp) (mc, mp the computed maxima of
//   |t|^2, |s|^2: M_t <= M (1 + u) / (1 - g3)); the rule takes twice the
//   margin, 16u M = M 2^-20.
// - So in double precision, LB = L^2 (1 - 2^-20) - M 2^-20 <= E for every
//   source outside the box (the double roundings of L^2 lose under 2^-50 of
//   it, inside the 2^-20). A lane whose third best d2 is strictly below LB
//   already holds its three least: every source outside has E > d2[2].
// ops/ballquery.py::knn_cells mirrors the grid and the stop rule on the CPU
// in the same operations; tests/test_torch_port_knn_grid.py holds its culled
// picks to the plain picks and JAX's, and shows a pick lost at 1 km from the
// origin when the margin and the slack are dropped.
//
// Bound on the H100: instruction issue over the pairs the boxes hold. On
// uniform dense plots (z up to 3 m) the third neighbour lies ~0.4 m off,
// about one cell of ~0.31 m, so a warp stops after two or three rings. The
// output rows of a warp's targets are written from a table of its picks
// (the targets are not consecutive in `out`): a flat walk over its 32 rows,
// a feature a lane. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/kernel_variants.py knn_grid, B=20, T = 4 S; PERF.md §6 row 2a):
// at the dense FP1 shape (S=16,384) 0.66 ms against knn_kernel's 12.9, the
// grid pass 0.086 and the query 0.57; in turns with PR 19's design
// (scripts/variants/knn_cull_ldg.cu; this query with a vote a source) 0.70
// against 0.92, PR 19's grid pass 0.16 and query 0.75. 2.34e8 pairs
// scored of 2.15e10 (1.09%, 179 sources a target); 9.9 SASS a pair that inserts
// nothing (29.4 with the insert; PR 19: 12 and 37.25). Of the query ~0.34
// ms is the scan and ~0.27 the output walk (a copy without the walk, timed
// beside it); a vote a source measured 0.63, one for 4 sources 0.60, and
// two or four times the blocks' registers, or the walk unrolled, moved
// nothing. The grid wins at every S measured, from 1,024 (0.072 against
// 0.097 ms) and PROD's FP1 (0.125 against 0.330), where knn_path
// (KNN_GRID_MIN_S) still keeps knn_kernel.
#include <math.h>

#include "cell_grid.cuh"

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 1;  // targets a lane; cuda_kernels.knn_slices and chip_smoke.py take 1
constexpr int kChunk = 4096;  // staged sources a chunk (64 KB)
constexpr int kMergeBytes = kWarps * 32 * kR * 3 * 8;  // every warp's lists

// float4 slots of the block's first region: the staged sources of a chunk,
// then the lists the merge reads (sources are no longer read by then)
__host__ __device__ __forceinline__ int region_f4(int s, int slices) {
  return max(min(s, kChunk), slices > 1 ? kMergeBytes / 16 : 0);
}

struct Top3 {
  float d[3];
  int i[3];
};

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, j) into t, kept in (d2, index) order (the merge: any order of j).
__device__ __forceinline__ void insert_lex(Top3& t, float d, int j) {
  if (!lex_less(d, j, t.d[2], t.i[2])) return;
  if (lex_less(d, j, t.d[1], t.i[1])) {
    t.d[2] = t.d[1];
    t.i[2] = t.i[1];
    if (lex_less(d, j, t.d[0], t.i[0])) {
      t.d[1] = t.d[0];
      t.i[1] = t.i[0];
      t.d[0] = d;
      t.i[0] = j;
    } else {
      t.d[1] = d;
      t.i[1] = j;
    }
  } else {
    t.d[2] = d;
    t.i[2] = j;
  }
}

// xs (b, s, f), ps (b, s, 3), pt (b, t, 3); grid (ceil(t / tile), b) with
// tile = (kWarps / slices) * 32 * kR targets.
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ xs, const float* __restrict__ ps,
           const float* __restrict__ pt, float* __restrict__ out, int* __restrict__ idx_out,
           float* __restrict__ w_out, int s, int t, int f, int slices) {
  extern __shared__ float4 stage[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / slices, slice = warp % slices;
  const int b = blockIdx.y;
  const int t0 = (blockIdx.x * (kWarps / slices) + group) * 32 * kR;

  float tx[kR], ty[kR], tz[kR], tn[kR];
  Top3 top[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float* tp = pt + (static_cast<size_t>(b) * t + min(t0 + lane + 32 * r, t - 1)) * 3;
    tx[r] = tp[0];
    ty[r] = tp[1];
    tz[r] = tp[2];
    tn[r] = sq3_rn(tx[r], ty[r], tz[r]);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      top[r].d[q] = INFINITY;
      top[r].i[q] = 0;
    }
  }

  const float* pb = ps + static_cast<size_t>(b) * s * 3;
  for (int base = 0; base < s; base += kChunk) {
    const int cnt = min(kChunk, s - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* p = pb + 3 * static_cast<size_t>(base + j);
      const float x = p[0], y = p[1], z = p[2];
      stage[j] = make_float4(x, y, z, sq3_rn(x, y, z));
    }
    __syncthreads();
    const int per = (cnt + slices - 1) / slices;
    const int j1 = min(cnt, (slice + 1) * per);
#pragma unroll 2
    for (int j = slice * per; j < j1; ++j) {
      const float4 p = stage[j];
      float v[kR];
      bool hit = false;  // v < d[2] is implied by max(v, 0) < d[2]: a superset
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        v[r] = __fadd_rn(__fmaf_rn(-2.0f, dot3_rn(tx[r], ty[r], tz[r], p.x, p.y, p.z), tn[r]),
                         p.w);
        hit |= v[r] < top[r].d[2];
      }
      if (__any_sync(0xffffffffu, hit)) {  // warp-uniform; the insert is branch-free
        const int id = base + j;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          Top3& tr = top[r];
          const float d = fmaxf(v[r], 0.0f);
          const bool c2 = d < tr.d[2], c1 = d < tr.d[1], c0 = d < tr.d[0];
          tr.d[2] = c1 ? tr.d[1] : (c2 ? d : tr.d[2]);
          tr.i[2] = c1 ? tr.i[1] : (c2 ? id : tr.i[2]);
          tr.d[1] = c0 ? tr.d[0] : (c1 ? d : tr.d[1]);
          tr.i[1] = c0 ? tr.i[0] : (c1 ? id : tr.i[1]);
          tr.d[0] = c0 ? d : tr.d[0];
          tr.i[0] = c0 ? id : tr.i[0];
        }
      }
    }
  }

  // the group's first warp merges its other warps' lists through shared
  // memory (after the barrier the staged sources are no longer read), then
  // writes idx and w and the tile's table of picks and weights
  const int tile = (kWarps / slices) * 32 * kR;
  float2* lists = reinterpret_cast<float2*>(stage);  // [warp][r][q][lane] (d, index bits)
  int4* tab_i = reinterpret_cast<int4*>(stage + region_f4(s, slices));
  float4* tab_w = reinterpret_cast<float4*>(tab_i + tile);
  if (slices > 1) {
    __syncthreads();
    if (slice > 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          lists[((warp * kR + r) * 3 + q) * 32 + lane] =
              make_float2(top[r].d[q], __int_as_float(top[r].i[q]));
    }
    __syncthreads();
    if (slice == 0) {
      for (int o = 1; o < slices; ++o) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float2 e = lists[(((warp + o) * kR + r) * 3 + q) * 32 + lane];
            insert_lex(top[r], e.x, __float_as_int(e.y));
          }
      }
    }
  }
  if (slice == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float w0 = __frcp_rn(fmaxf(top[r].d[0], 1e-16f));
      const float w1 = __frcp_rn(fmaxf(top[r].d[1], 1e-16f));
      const float w2 = __frcp_rn(fmaxf(top[r].d[2], 1e-16f));
      const float wsum = __fadd_rn(__fadd_rn(w0, w1), w2);
      const int tl = group * 32 * kR + 32 * r + lane;  // target in the tile
      tab_i[tl] = make_int4(top[r].i[0], top[r].i[1], top[r].i[2], 0);
      tab_w[tl] = make_float4(w0, w1, w2, wsum);
      if (t0 + 32 * r + lane < t) {
        const size_t o = static_cast<size_t>(b) * 3 * t + t0 + 32 * r + lane;
        idx_out[o] = top[r].i[0];
        idx_out[o + t] = top[r].i[1];
        idx_out[o + 2 * t] = top[r].i[2];
        w_out[o] = __fdiv_rn(w0, wsum);
        w_out[o + t] = __fdiv_rn(w1, wsum);
        w_out[o + 2 * t] = __fdiv_rn(w2, wsum);
      }
    }
  }
  __syncthreads();

  // the output rows of the tile's targets are consecutive in `out`: the
  // block walks their values flat, element e being feature e % f of target
  // e / f, so loads of source rows and stores are coalesced
  const int first = blockIdx.x * tile;
  const int n_el = min(tile, t - first) * f;
  const float* xb = xs + static_cast<size_t>(b) * s * f;
  float* ob = out + (static_cast<size_t>(b) * t + first) * f;
#pragma unroll 4
  for (int e = threadIdx.x; e < n_el; e += kThreads) {
    const int tl = e / f, ch = e - tl * f;
    const int4 j = tab_i[tl];
    const float4 v = tab_w[tl];
    const float acc = __fmaf_rn(xb[static_cast<size_t>(j.z) * f + ch], v.z,
                                __fmaf_rn(xb[static_cast<size_t>(j.y) * f + ch], v.y,
                                          __fmul_rn(xb[static_cast<size_t>(j.x) * f + ch], v.x)));
    ob[e] = __fdiv_rn(acc, v.w);
  }
}

// xs (b, s, f), ps (b, s, 3), pt (b, t, 3) -> out (b, t, f), idx (b, 3, t)
// i32, w (b, 3, t) normalised weights; `slices` (1, 2, 4 or 8) warps split
// each target group's sources.
extern "C" int knn_interpolate_launch(const float* xs, const float* ps, const float* pt,
                                      float* out, int* idx, float* w, int b, int s, int t,
                                      int f, int slices, void* stream) {
  if (slices != 1 && slices != 2 && slices != 4 && slices != 8) return cudaErrorInvalidValue;
  const int tile = (kWarps / slices) * 32 * kR;
  const size_t smem =
      16 * static_cast<size_t>(region_f4(s, slices)) + 32 * static_cast<size_t>(tile);
  cudaError_t err = allow_smem(knn_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + tile - 1) / tile, b);
  knn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(xs, ps, pt, out, idx,
                                                                          w, s, t, f, slices);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Dense plots: the cell grid (see the header)
// ---------------------------------------------------------------------------

EXTENT_GRID_KERNEL(knn_grid_kernel)

constexpr double kKnnMargin = 0x1p-20;  // cuda_kernels.KNN_MARGIN: 16u, in units of M
constexpr double kKnnSlack = 0x1p-22;   // cuda_kernels.KNN_SLACK: q's rounding a unit of |q|

constexpr int kTile = 32;  // sources a staged tile of knn_cull_kernel: one a lane
constexpr int kVote = 2;  // staged sources a warp vote of knn_cull_kernel covers

// Insert (d, id) into top in (d2, index) order, branch-free: top is
// unchanged unless (d, id) precedes its third entry, so a source that the
// vote let through needlessly changes nothing.
__device__ __forceinline__ void insert_sel(Top3& top, float d, int id) {
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

// The sorted sources that the box of cells [n0, n1] x [m0, m1] (columns x
// rows) adds to the box [c0, c1] x [r0, r1] (no box: r0 > r1), scored for
// the lane's target: a warp vote, then the insert in (d2, index) order.
// Row m0 + k gives segments 2 k and 2 k + 1 (ranges of the sorted sources):
// a row outside the old box whole and nothing, a row inside it its new left
// cells and its new right cells. Each group of 32 segments is flattened by a
// warp prefix sum over their lengths; its sources are staged 32 at a time,
// a source a lane (coalesced 16-byte loads), into the warp's double buffer
// of float4 [x, y, z, |s|^2] and index, the next tile loaded while the
// current one is scored from shared memory (one broadcast LDS.128 a pair;
// the index read on the insert path only). Tiles cross segment boundaries:
// all are full but a group's last.
__device__ __forceinline__ void knn_scan_added(const float4* __restrict__ sp,
                                               const int* __restrict__ si,
                                               const int* __restrict__ st, int gx, int n0, int n1,
                                               int m0, int m1, int c0, int c1, int r0, int r1,
                                               float tx, float ty, float tz, float tn, Top3& top,
                                               float4 (*tile_p)[kTile], int (*tile_i)[kTile],
                                               int lane) {
  const int nseg = 2 * (m1 - m0 + 1);
  for (int s0 = 0; s0 < nseg; s0 += 32) {
    const int sg = s0 + lane;
    int lo = 0, len = 0;
    if (sg < nseg) {
      const int row = m0 + (sg >> 1);
      int a = n0, z = n1;  // the segment's columns [a, z]
      if (row >= r0 && row <= r1) {
        if (sg & 1)
          a = c1 + 1;
        else
          z = c0 - 1;
      } else if (sg & 1) {
        z = a - 1;
      }
      if (a <= z) {
        lo = __ldg(st + row * gx + a);
        len = __ldg(st + row * gx + z + 1) - lo;
      }
    }
    const int incl = warp_incl_scan(len, lane);
    const int excl = incl - len;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    // the sorted position of flat source f < total: in the last segment
    // whose first flat source is at most f (empty segments share theirs
    // with the next one, so never hold it)
    auto locate = [&](int f) {
      int k = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(0xffffffffu, excl, k + step) <= f) k += step;
      return __shfl_sync(0xffffffffu, lo, k) + f - __shfl_sync(0xffffffffu, excl, k);
    };
    __syncwarp();  // the previous group's tiles are no longer read
    int buf = 0;
    {
      const int j = locate(lane);
      if (lane < total) {
        tile_p[0][lane] = __ldg(sp + j);
        tile_i[0][lane] = __ldg(si + j);
      }
    }
    for (int f0 = 0; f0 < total; f0 += kTile) {
      __syncwarp();  // tile f0 staged, and the other buffer no longer read
      const int f = f0 + kTile + lane;
      const int j = locate(f);
      const bool more = f < total;
      float4 np = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int ni = 0;
      if (more) {  // the next tile, in flight while this one is scored
        np = __ldg(sp + j);
        ni = __ldg(si + j);
      }
      const float4* tp = tile_p[buf];
      const int* ti = tile_i[buf];
      const int m = min(kTile, total - f0);
      int k = 0;
#pragma unroll 4
      for (; k + kVote <= m; k += kVote) {
        float d[kVote];
        bool hit = false;
#pragma unroll
        for (int v = 0; v < kVote; ++v) {
          const float4 p = tp[k + v];
          d[v] = expanded_d2_sel(tn, dot3_rn(tx, ty, tz, p.x, p.y, p.z), p.w);
          hit |= d[v] <= top.d[2];
        }
        if (__any_sync(0xffffffffu, hit)) {  // warp-uniform; each insert branch-free
#pragma unroll
          for (int v = 0; v < kVote; ++v) insert_sel(top, d[v], ti[k + v]);
        }
      }
      if constexpr (kVote > 1) {
        for (; k < m; ++k) {  // the tile's last sources, a vote each
          const float4 p = tp[k];
          const float d = expanded_d2_sel(tn, dot3_rn(tx, ty, tz, p.x, p.y, p.z), p.w);
          if (__any_sync(0xffffffffu, d <= top.d[2])) insert_sel(top, d, ti[k]);
        }
      }
      buf ^= 1;
      if (more) {
        tile_p[buf][lane] = np;
        tile_i[buf][lane] = ni;
      }
    }
  }
}

// xs (b, s, f), pt (b, t, 3) and the grid of knn_grid_kernel (sources as its
// points, targets as its centroids) -> out, idx, w as knn_kernel; `scored`
// (b, t), or NULL: the sources each target's warp scanned. Grid (ceil(t /
// kThreads), b).
__global__ void __launch_bounds__(kThreads)
knn_cull_kernel(const float* __restrict__ xs, const float* __restrict__ pt,
                const float4* __restrict__ spts, const int* __restrict__ sidx,
                const int* __restrict__ starts, const int* __restrict__ corder,
                const int* __restrict__ grid, float* __restrict__ out, int* __restrict__ idx_out,
                float* __restrict__ w_out, int* __restrict__ scored, int s, int t, int f,
                int gmax) {
  __shared__ float4 tile_p[kWarps][2][kTile];  // each warp's staged sources, double-buffered
  __shared__ int tile_i[kWarps][2][kTile];
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
  knn_scan_added(sp, si, st, gx, c0, c1, r0, r1, 0, -1, 1, 0, tx, ty, tz, tn, top, tile_p[warp],
                 tile_i[warp], lane);
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
    knn_scan_added(sp, si, st, gx, n0, n1, m0, m1, c0, c1, r0, r1, tx, ty, tz, tn, top,
                   tile_p[warp], tile_i[warp], lane);
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

// xs (b, s, f), ps (b, s, 3), pt (b, t, 3) -> out (b, t, f), idx (b, 3, t),
// w (b, 3, t) as knn_interpolate_launch, on the cell grid: the grid pass
// (ws: cell_grid.cuh's workspace of b clouds of s points and t centroids,
// gmax = min(64, isqrt(s)), a cluster of cs blocks a cloud), then the query;
// `scored` (b, t) i32 or NULL.
extern "C" int knn_interpolate_grid_launch(const float* xs, const float* ps, const float* pt,
                                           float* out, int* idx, float* w, int* ws, int* scored,
                                           int b, int s, int t, int f, int gmax, int cs,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CellWs cw = carve_cells(ws, b, s, t, gmax);
  cudaError_t err = launch_cell_grid(knn_grid_kernel, pt, ps, cw, b, s, t, gmax, 0.0f, cs, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kThreads - 1) / kThreads, b);
  knn_cull_kernel<<<grid, kThreads, 0, st>>>(xs, pt, cw.spts, cw.sidx, cw.starts, cw.corder,
                                             cw.grid, out, idx, w, scored, s, t, f, gmax);
  return cudaGetLastError();
}

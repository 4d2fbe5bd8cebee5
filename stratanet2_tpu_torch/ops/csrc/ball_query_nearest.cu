// Nearest fixed-K ball query: per centroid, the k points of least expanded
// d2 within the radius, in ascending order of (d2, index); slots past the
// in-radius count give idx 0 and mask 0.
//
// Replaces: the selection of stratanet2_tpu/ops/ballquery.py::
// _ball_query_single (:104-138, `method="nearest"`), which scores the same
// d2 and takes jax.lax.approx_min_k of it in XLA (no Pallas kernel; on a
// TPU over bf16 scores). It computes what the plain
// stratanet2_tpu_torch/ops/ballquery.py::ball_query_nearest computes: exact
// float32 distances, rounded as XLA rounds them (common.cuh), and a stable
// order by (d2, index).
//
// Keys: a candidate is the 64-bit key (bits(d2) << 32) | index. The bit
// patterns of non-negative floats order like their values, so the keys
// order by (d2, index) exactly and are distinct. The sign bit is cleared
// first: a -0.0 would otherwise sort after every positive distance. The k
// least keys of a set are one set in one order whatever order the points
// are scanned in, so the kernel may visit them in any order.
//
// Bound on the H100: instruction issue, and only over the pairs that can
// matter. Brute force scores every point of a cloud for every centroid
// (20 x 2500 x 10000 = 5.0e8 pairs at SA1 of a PROD step), though the
// radius (sqrt(2) m at SA1, sqrt(8) m at SA2, over a 20 m plot) holds a
// few percent of them. So a prep kernel sorts each cloud into a grid of xy
// cells of side h >= the culling radius r_c, and the query kernel scores
// only the 3 x 3 cells around its centroid's cell.
//
// Two launches, one count (cuda_kernels.ball_query_nearest):
//   nearest_grid_kernel, one block of 1024 threads a cloud, no host sync:
//     reduces the cloud's xy extent, max |p|^2 over its points and max |c|^2
//     over its centroids; picks r_c and h (below); counts its points into
//     cells with shared-memory atomics, scans the counts into each cell's
//     start, and scatters the points in cell order as float4
//     [x, y, z, |p|^2] (|p|^2 as sq3_rn) beside their original indices; then
//     sorts the centroids by cell the same way, so that the 8 warps of a
//     query block take neighbouring centroids and read neighbouring ranges.
//     The order inside a cell follows the atomics and is not fixed; nothing
//     downstream depends on it. The grid has at most gmax x gmax cells,
//     gmax = min(64, isqrt(N)) from the shapes, so the wrapper sizes the
//     workspace with torch.empty and no value is read back.
//   ball_query_nearest_kernel<kPer>, one warp a centroid (8 a block, in the
//     centroids' cell order): scans the rows cy, cy - 1, cy + 1 of its cell
//     block, each row's three cells one contiguous range of the sorted
//     points (row-major cells), 32 points at a time, a point a lane, loaded
//     straight from global memory (LDG.128, through L1). A lane whose point
//     is within the radius and whose key is below the warp's running k-th
//     key appends it to the warp's buffer of 32 (ballot and prefix count); a
//     full buffer is merged into the warp's sorted top-k list in shared
//     memory (merge_top). kPer = ceil(k / 32) sizes the merge's list.
//
// The invariant: EVERY POINT THAT THE PLAIN VERSION ADMITS IS SCORED. The
// plain version admits p for c when E = max(fl(fl(a - 2 ab) + b), 0) <= r2,
// with a = sq3_rn(c), b = sq3_rn(p), ab = dot3_rn(c, p), u = 2^-24. Its true
// squared distance D = |c - p|^2 can exceed r2 by the rounding of that
// cancellation, which grows with |c|^2 + |p|^2 (one ulp of |p|^2 is
// 0.125 m^2 at 1 km from the origin):
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
// The merge: every in-radius point whose key is below the running k-th key
// goes through the buffer, so a centroid merges at most ceil(in-radius /
// 32) + 1 times, however its points arrive (descending distance is the
// worst order); the middle row goes first, since it holds the nearest
// points, so the k-th key drops early. Crowded cells make the ranges long
// (towards brute force), never inexact.
//
// No shared-memory staging of the window: a block's window (the 3 x 3 cells
// of 8 neighbouring centroids, ~450 points, ~9 KB at SA1) is read by its 8
// warps and stays in L1, and the loads are one LDG.128 a pair beside ~17
// other instructions. Measured, the scan (the query without its merges)
// moves its 2.0e7 pairs x 16 B at SA1 in ~0.064 ms: ~5 TB/s from L1 and,
// at ~9 KB a block, under 1 TB/s from L2, both well below what those
// caches serve, so the loads do not set the pace; staging would add block
// barriers between warps whose ranges differ.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phases 17a
// and 16, scripts/kernel_variants.py ball_query_nearest; PERF.md §6 row
// 12): 0.237 ms a nearest serve step (SA1 0.167, SA2 0.070), against the
// brute-force design's 0.947 before it; the grid pass 0.035 + 0.011 of
// it; 2.45e7 pairs scored of 5.31e8; 17.5 SASS a pair that inserts
// nothing, an issue floor of 0.0128 ms; the merges about half the query
// (a copy that never merges: 0.099 / 0.032 ms a site); 48-64 registers,
// no spill.
#include "common.cuh"

constexpr int kNearWarps = 8;
constexpr int kNearThreads = 32 * kNearWarps;
constexpr int kNearMaxK = 128;   // cuda_kernels.NEAREST_MAX_K
constexpr int kNearBuf = 32;     // candidates a warp holds before it merges
constexpr int kGridThreads = 1024;
constexpr int kGridMax = 64;     // cuda_kernels.NEAREST_GRID_MAX: cells a side at most
constexpr int kGridParams = 6;   // ints a cloud: xmin, ymin, inv_h, rc2 (float bits), gx, gy
constexpr unsigned long long kNone = ~0ull;  // above every key: an empty slot

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

// One block a cloud: the grid parameters, the points in cell order with
// their indices and each cell's start (cells past gx * gy start at n), and
// the centroids in cell order.
__global__ void __launch_bounds__(kGridThreads)
nearest_grid_kernel(const float* __restrict__ cent, const float* __restrict__ xyz,
                    float4* __restrict__ spts, int* __restrict__ sidx, int* __restrict__ starts,
                    int* __restrict__ corder, int* __restrict__ grid, int n, int c, int gmax,
                    float r2) {
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
      const float s = __fadd_rn(__fadd_rn(v[5], v[4]), r2);
      const float rc2 = __fadd_rn(r2, __fmul_rn(s, 9.5367431640625e-07f /* 2^-20 */));
      const float rc = __fsqrt_rn(rc2);
      const float inv_h = fminf(__fdiv_rn(1.0f, __fmul_rn(rc, 1.0009765625f /* 1 + 2^-10 */)),
                                __fdiv_rn(static_cast<float>(gmax) - 0.5f, fmaxf(ex, ey)));
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

// Merge the `cnt` unsorted keys of `buf` into the sorted list `top` of k
// keys (empty slots kNone, at the end), keeping the k least; k <= 32 kPer.
// Keys are distinct, so the rank of a key in the union is unique: list key
// i goes to i + #(buffer keys below it), buffer key s to #(list keys below
// it) + #(buffer keys below it). Every place < k is written once: the empty
// slots of the list, each with all cnt buffer keys below it, fill the
// places past the real keys. Not inlined, so that the scan loop stays one
// loop.
template <int kPer>
__device__ __noinline__ void merge_top(unsigned long long* top, const unsigned long long* buf,
                                       int cnt, int k, int lane) {
  const unsigned long long s = lane < cnt ? buf[lane] : kNone;
  unsigned long long e[kPer];
  int re[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    e[q] = i < k ? top[i] : kNone;
    re[q] = 0;
  }
  int rs = 0;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const unsigned long long u = __shfl_sync(~0u, s, t);
    rs += u < s;
#pragma unroll
    for (int q = 0; q < kPer; ++q) re[q] += u < e[q];
  }
  int pos = 0;  // list keys below s: a binary search of the sorted list
#pragma unroll
  for (int step = 32 * kPer; step >= 1; step >>= 1) {
    if (pos + step <= k && top[pos + step - 1] < s) pos += step;
  }
  __syncwarp();  // every lane has read the list
  if (lane < cnt && pos + rs < k) top[pos + rs] = s;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    if (i < k && i + re[q] < k) top[i + re[q]] = e[q];
  }
  __syncwarp();
}

template <int kPer>
__global__ void __launch_bounds__(kNearThreads)
ball_query_nearest_kernel(const float* __restrict__ cent, const float4* __restrict__ spts,
                          const int* __restrict__ sidx, const int* __restrict__ starts,
                          const int* __restrict__ corder, const int* __restrict__ grid,
                          int* __restrict__ idx, uint8_t* __restrict__ mask, int n, int c, int k,
                          int gmax, float r2) {
  extern __shared__ unsigned long long smem[];  // per warp: top[k], buf[32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int slot = blockIdx.x * kNearWarps + warp;
  if (slot >= c) return;  // no block barrier below: a warp past the end just leaves
  unsigned long long* top = smem + static_cast<size_t>(warp) * (k + kNearBuf);
  unsigned long long* buf = top + k;

  const int ci = corder[static_cast<size_t>(b) * c + slot];
  const float* cp = cent + (static_cast<size_t>(b) * c + ci) * 3;
  const float cx = cp[0], cy = cp[1], cz = cp[2];
  const float cn = sq3_rn(cx, cy, cz);
  const int* gp = grid + static_cast<size_t>(b) * kGridParams;
  const float inv_h = __int_as_float(gp[2]);
  const int gx = gp[4], gy = gp[5];
  const int ccx = cell_coord(__fsub_rn(cx, __int_as_float(gp[0])), inv_h, gx);
  const int ccy = cell_coord(__fsub_rn(cy, __int_as_float(gp[1])), inv_h, gy);
  const int* st = starts + static_cast<size_t>(b) * (gmax * gmax + 1);
  const float4* sp = spts + static_cast<size_t>(b) * n;
  const int* si = sidx + static_cast<size_t>(b) * n;

  for (int i = lane; i < k; i += 32) top[i] = kNone;
  __syncwarp();
  unsigned long long kth = kNone;  // the list's k-th key, warp-uniform
  int cnt = 0;                     // keys in buf, warp-uniform
  const unsigned below = (1u << lane) - 1;

  for (int rr = 0; rr < 3; ++rr) {  // rows cy, cy - 1, cy + 1
    const int row = ccy + (rr == 0 ? 0 : rr == 1 ? -1 : 1);
    if (row < 0 || row >= gy) continue;
    const int lo = st[row * gx + max(ccx - 1, 0)];
    const int hi = st[row * gx + min(ccx + 1, gx - 1) + 1];
    for (int j0 = lo; j0 < hi; j0 += 32) {
      const int j = j0 + lane;
      unsigned long long key = kNone;
      if (j < hi) {
        const float4 p = __ldg(sp + j);
        const float d2 = expanded_d2_sel(cn, dot3_rn(cx, cy, cz, p.x, p.y, p.z), p.w);
        if (d2 <= r2) {
          key = (static_cast<unsigned long long>(__float_as_uint(d2) & 0x7fffffffu) << 32) |
                static_cast<unsigned>(__ldg(si + j));
        }
      }
      bool want = key < kth;
      unsigned ballot = __ballot_sync(~0u, want);
      if (ballot == 0) continue;
      if (cnt + __popc(ballot) > kNearBuf) {
        merge_top<kPer>(top, buf, cnt, k, lane);
        cnt = 0;
        kth = top[k - 1];
        want = key < kth;
        ballot = __ballot_sync(~0u, want);
      }
      if (want) buf[cnt + __popc(ballot & below)] = key;
      cnt += __popc(ballot);
      __syncwarp();
    }
  }
  if (cnt > 0) merge_top<kPer>(top, buf, cnt, k, lane);
  int* ib = idx + (static_cast<size_t>(b) * c + ci) * k;
  uint8_t* mb = mask + (static_cast<size_t>(b) * c + ci) * k;
  for (int i = lane; i < k; i += 32) {
    const unsigned long long key = top[i];
    const bool ok = key != kNone;
    ib[i] = ok ? static_cast<int>(key & 0xffffffffu) : 0;
    mb[i] = ok ? 1 : 0;
  }
}

// The workspace `ws`, ints (cuda_kernels._nearest_layout names the same parts):
// spts (b, n) float4, sidx (b, n), starts (b, gmax^2 + 1), corder (b, c),
// grid (b, kGridParams).
struct NearestWs {
  float4* spts;
  int *sidx, *starts, *corder, *grid;
};

static NearestWs carve(int* ws, int b, int n, int c, int gmax) {
  NearestWs w;
  const size_t bn = static_cast<size_t>(b) * n;
  w.spts = reinterpret_cast<float4*>(ws);
  w.sidx = ws + 4 * bn;
  w.starts = w.sidx + bn;
  w.corder = w.starts + static_cast<size_t>(b) * (gmax * gmax + 1);
  w.grid = w.corder + static_cast<size_t>(b) * c;
  return w;
}

static cudaError_t launch_grid(const float* cent, const float* xyz, const NearestWs& w, int b,
                               int n, int c, int gmax, float r2, cudaStream_t stream) {
  nearest_grid_kernel<<<b, kGridThreads, 0, stream>>>(cent, xyz, w.spts, w.sidx, w.starts,
                                                      w.corder, w.grid, n, c, gmax, r2);
  return cudaGetLastError();
}

template <int kPer>
static cudaError_t launch_query(const float* cent, const NearestWs& w, int* idx, uint8_t* mask,
                                int b, int n, int c, int k, int gmax, float r2,
                                cudaStream_t stream) {
  const size_t smem = sizeof(unsigned long long) * kNearWarps * static_cast<size_t>(k + kNearBuf);
  cudaError_t err = allow_smem(ball_query_nearest_kernel<kPer>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kNearWarps - 1) / kNearWarps, b);
  ball_query_nearest_kernel<kPer><<<grid, kNearThreads, smem, stream>>>(
      cent, w.spts, w.sidx, w.starts, w.corder, w.grid, idx, mask, n, c, k, gmax, r2);
  return cudaGetLastError();
}

// cent (b, c, 3), xyz (b, n, 3) -> idx (b, c, k) i32, mask (b, c, k) u8
// (a torch.bool tensor); 1 <= k <= min(n, kNearMaxK), 1 <= gmax <= kGridMax.
extern "C" int ball_query_nearest_launch(const float* cent, const float* xyz, int* idx,
                                         uint8_t* mask, int* ws, int b, int n, int c, int k,
                                         int gmax, float r2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const NearestWs w = carve(ws, b, n, c, gmax);
  cudaError_t err = launch_grid(cent, xyz, w, b, n, c, gmax, r2, s);
  if (err != cudaSuccess) return err;
  if (k <= 32) return launch_query<1>(cent, w, idx, mask, b, n, c, k, gmax, r2, s);
  if (k <= 64) return launch_query<2>(cent, w, idx, mask, b, n, c, k, gmax, r2, s);
  return launch_query<kNearMaxK / 32>(cent, w, idx, mask, b, n, c, k, gmax, r2, s);
}

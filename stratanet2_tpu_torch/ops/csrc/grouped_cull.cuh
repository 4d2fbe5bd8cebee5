// The grouped selection's long-group path on the cell grid (cell_grid.cuh),
// shared by ball_query.cu (idx and mask) and sa_fused_eval.cu (a pick table
// that its apply kernel reads): per centroid and per group of g = ceil(N/K)
// consecutive points, the group's first point of least expanded d2, valid
// iff d2 <= r^2, as stratanet2_tpu/ops/ballquery.py:71-101 picks it.
//
// Exactness. When a group's pick is valid it is the least key
// (bits(d2) << 32) | index over the group's admitted points (d2 <= r^2):
// the bit patterns of non-negative floats order like their values, so the
// keys order by (d2, index) and the least is the first point of least d2
// (the sign bit is cleared first, so -0.0 ties with +0.0 and the index
// decides, as argmin over the group does). A least key is a set function:
// the scan may visit the points in any order. Every admitted point lies in
// the 3 x 3 cells around its centroid's (cell_grid.cuh's invariant), so
// scanning those cells alone gives the same least key, bit for bit, as the
// whole group. A group with no admitted point, an empty group past N and a
// ragged last group's missing points leave the slot at kNoKey: idx 0 and
// mask false (-1 in the pick table).
//
// Bound on the H100: instruction issue over the pairs the cells hold. At
// the dense plots' SA1 (B=20 x N=65,536, C=16,384, K=32, r=sqrt(2) over a
// 20 m plot) the cells are ~1.42 m, 15 x 15 of ~290 points, and a centroid
// scores ~2,650 points: 8.7e8 pairs (4.0%) of the 2.15e10 that the
// whole-group scan scores. Every scored pair costs its distance and
// compare; a pair within the radius (19% of them: the ball is 3-D, the
// plots 3 m high) also a slot read, and the few keys below their slot a
// fold.
//
// Design: grouped_cull_kernel<PICKS>, a warp for kCullCents = 2 centroids
// taken in cell order (corder), 8 warps a block, so a block's warps read
// neighbouring ranges, which stay in L1. Each centroid has a slot table of
// kw <= kCullSlots 64-bit keys (groups g0 .. g0 + kw - 1) in shared memory.
// The warp scans every row of the cells around its centroids' (3 rows of 3
// cells when they share a cell, as most neighbours in cell order do; the
// bounding rows and columns when they do not), each row one contiguous range
// of the sorted points, a point a lane: LDG.128 of [x, y, z, |p|^2] and its
// index, its group by a multiply-high (no integer divide), then for each
// centroid the distance and, within the radius, a read of the slot's high
// word, the d2 bits of its key. Only a key at or below them goes on to the
// fold, a 64-bit min in shared memory. The warp then writes its centroids'
// slots. No block barrier: a warp past the last centroid just leaves. More
// than kCullSlots groups (K > 1,792 with groups past 1,816 points: N > 3.2e6
// a cloud) take ceil(K / kCullSlots) windows of groups, a block's warps
// each; every window rescans the cells.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/kernel_variants.py
// selection, random centroids; PERF.md §6 rows 4a and 5a): at the dense
// SA1 shape the query takes 1.22 ms beside the grid pass's 0.20, the
// whole ball query 1.43 against the earlier chunked scan of all pairs at 11.10
// (the SA eval path 1.81 against 10.07-10.24), the same outputs bit for
// bit. Its loop issues 23.25 SASS a scored pair in all and 16.75 on the
// path of a pair that folds nothing (chip_smoke.py's selection_floor).
// Where the cells hold most of the cloud it loses its edge: 90% of the
// points in 5% of the plot 8.6 ms against 11.2, a radius over the whole
// plot (one cell, B=2) 2.35 against 1.14. Tried and not kept (one call
// each, beside the kept design): one centroid a warp (1.42 ms against
// 1.23), four (1.31), two points a lane loaded ahead (1.26); the fold out
// of line (2.67 against 1.39: the calls' overhead) and the slot read
// through a generic pointer (1.36 against 1.26: the shared address
// recomputed in the loop).
#pragma once

#include "cell_grid.cuh"

constexpr int kCullWarps = 8;
constexpr int kCullThreads = 32 * kCullWarps;
constexpr int kCullCents = 2;     // centroids a warp: each loaded point is scored for each
constexpr int kCullSlots = 1792;  // cuda_kernels.CULL_SLOTS: 8 warps x 2 tables fill 224 KB
constexpr unsigned long long kNoKey = ~0ull;  // above every key: an empty slot

// i / g for 0 <= i < 2^31 and g >= 1 as a multiply-high and a shift: with
// l = ceil(log2 g) and m = ceil(2^(31 + l) / g) < 2^32, i m / 2^(31 + l) =
// i / g + e with 0 <= e < i / 2^(31 + l) < 2^-l <= 1 / g, so the floor is
// exact; and (2 i) m / 2^32 = i m / 2^31 (2 i < 2^32), so the quotient is
// umulhi(2 i, m) >> l.
struct GroupDiv {
  unsigned m;
  int l;
};

__device__ __forceinline__ GroupDiv group_div(int g) {
  GroupDiv d;
  d.l = 32 - __clz(g - 1);
  d.m = static_cast<unsigned>(((1ull << (31 + d.l)) + g - 1) / static_cast<unsigned>(g));
  return d;
}

__device__ __forceinline__ int group_of(int i, GroupDiv d) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(i) << 1, d.m) >> d.l);
}

// Slots are addressed by their 32-bit shared-memory address. The table's
// base comes from an opaque instruction, so that it stays in a register: a
// plain cvta is recomputed inside the scan loop, from the block's cluster
// id, at every slot it addresses.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  unsigned a;
  asm volatile("{ .reg .u64 t; cvta.to.shared.u64 t, %1; cvt.u32.u64 %0, t; }" : "=r"(a) : "l"(p));
  return a;
}

// The slot's high word: its key's d2 bits (a fold may be changing it).
__device__ __forceinline__ unsigned slot_d2_bits(unsigned slot) {
  unsigned v;
  asm volatile("ld.volatile.shared.u32 %0, [%1+4];" : "=r"(v) : "r"(slot));
  return v;
}

// The slot becomes min(slot, key): on an H100 a compare-and-swap loop,
// nested in the scan loop (out of line, the calls cost the scan about
// twice its time; PERF.md §6).
__device__ __forceinline__ void fold_key(unsigned slot, unsigned long long key) {
  asm volatile("red.shared.min.u64 [%0], %1;" ::"r"(slot), "l"(key) : "memory");
}

// cent (b, c, 3) and the grid `w` of cell_grid.cuh -> with PICKS, pick
// (b, c, k) i32 (-1 where a group has no admitted point); without, idx
// (b, c, k) i32 (0 there) and mask (b, c, k) u8. Grid (ceil(c / 16) x
// windows, b), kw slots a centroid.
template <bool PICKS>
__global__ void __launch_bounds__(kCullThreads)
grouped_cull_kernel(const float* __restrict__ cent, const float4* __restrict__ spts,
                    const int* __restrict__ sidx, const int* __restrict__ starts,
                    const int* __restrict__ corder, const int* __restrict__ grid,
                    int* __restrict__ idx, uint8_t* __restrict__ mask, int n, int c, int k,
                    int g, int gmax, int kw, float r2) {
  extern __shared__ unsigned long long cull_slots[];  // per warp: kCullCents tables of kw keys
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int wins = (k + kw - 1) / kw, win = blockIdx.x % wins;
  const int first = ((blockIdx.x / wins) * kCullWarps + warp) * kCullCents;
  if (first >= c) return;
  const int g0 = win * kw, nk = min(kw, k - g0);
  unsigned long long* keys = cull_slots + static_cast<size_t>(warp) * kCullCents * kw;
  for (int i = lane; i < kCullCents * kw; i += 32) keys[i] = kNoKey;
  __syncwarp();
  const unsigned keys_at = shared_addr(keys), table = 8u * kw;  // centroid r's table at r * table

  const int* gp = grid + static_cast<size_t>(b) * kGridParams;
  const float xmin = __int_as_float(gp[0]), ymin = __int_as_float(gp[1]);
  const float inv_h = __int_as_float(gp[2]);
  const int gx = gp[4], gy = gp[5];
  float cx[kCullCents], cy[kCullCents], cz[kCullCents], cn[kCullCents];
  int ci[kCullCents];
  int rlo = gy, rhi = 0, clo = gx, chi = 0;  // the warp's centroids' cells: rows and columns
#pragma unroll
  for (int r = 0; r < kCullCents; ++r) {
    // past the last centroid: the last again, scored and never written
    ci[r] = corder[static_cast<size_t>(b) * c + min(first + r, c - 1)];
    const float* cp = cent + (static_cast<size_t>(b) * c + ci[r]) * 3;
    cx[r] = cp[0];
    cy[r] = cp[1];
    cz[r] = cp[2];
    cn[r] = sq3_rn(cx[r], cy[r], cz[r]);
    const int ccx = cell_coord(__fsub_rn(cx[r], xmin), inv_h, gx);
    const int ccy = cell_coord(__fsub_rn(cy[r], ymin), inv_h, gy);
    rlo = min(rlo, ccy);
    rhi = max(rhi, ccy);
    clo = min(clo, ccx);
    chi = max(chi, ccx);
  }
  const int* st = starts + static_cast<size_t>(b) * (gmax * gmax + 1);
  const float4* sp = spts + static_cast<size_t>(b) * n;
  const int* si = sidx + static_cast<size_t>(b) * n;
  const GroupDiv gd = group_div(g);
  const int col0 = max(clo - 1, 0), col1 = min(chi + 1, gx - 1);

  // every row of the cells around the warp's centroids' (3 rows and 3
  // cells when they share a cell), each row one range of the sorted points
  for (int row = max(rlo - 1, 0); row <= min(rhi + 1, gy - 1); ++row) {
    const int lo = st[row * gx + col0], hi = st[row * gx + col1 + 1];
    for (int j = lo + lane; j < hi; j += 32) {
      const float4 p = __ldg(sp + j);
      const int pj = __ldg(si + j);
      const int grp = group_of(pj, gd) - g0;
      const bool live = static_cast<unsigned>(grp) < static_cast<unsigned>(nk);
      const unsigned at = keys_at + 8u * grp;  // the group's slot of centroid 0
#pragma unroll
      for (int r = 0; r < kCullCents; ++r) {
        const float d2 = expanded_d2_sel(cn[r], dot3_rn(cx[r], cy[r], cz[r], p.x, p.y, p.z), p.w);
        const unsigned bits = __float_as_uint(d2) & 0x7fffffffu;
        // only a key whose d2 bits are at or below the slot's can be below
        // it; the fold decides ties
        if (live && d2 <= r2 && bits <= slot_d2_bits(at + r * table))
          fold_key(at + r * table,
                   (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned>(pj));
      }
    }
  }
  __syncwarp();  // every fold of the warp is seen
#pragma unroll
  for (int r = 0; r < kCullCents; ++r) {
    if (first + r >= c) break;
    const size_t o = (static_cast<size_t>(b) * c + ci[r]) * k + g0;
    for (int i = lane; i < nk; i += 32) {
      const unsigned long long key = keys[r * kw + i];
      const bool ok = key != kNoKey;
      const int pick = static_cast<int>(key & 0xffffffffu);
      if constexpr (PICKS) {
        idx[o + i] = ok ? pick : -1;
      } else {
        idx[o + i] = ok ? pick : 0;
        mask[o + i] = ok ? 1 : 0;
      }
    }
  }
}

// The query on the grid `w` that a CELL_GRID_KERNEL built; k groups of
// ceil(n / k) points.
template <bool PICKS>
static cudaError_t launch_grouped_cull(const float* cent, const CellWs& w, int* idx,
                                       uint8_t* mask, int b, int n, int c, int k, int gmax,
                                       float r2, cudaStream_t stream) {
  const int kw = min(k, kCullSlots), per = kCullWarps * kCullCents;
  const size_t smem = sizeof(unsigned long long) * per * static_cast<size_t>(kw);
  cudaError_t err = allow_smem(grouped_cull_kernel<PICKS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + per - 1) / per * ((k + kw - 1) / kw), b);
  grouped_cull_kernel<PICKS><<<grid, kCullThreads, smem, stream>>>(
      cent, w.spts, w.sidx, w.starts, w.corder, w.grid, idx, mask, n, c, k, (n + k - 1) / k,
      gmax, kw, r2);
  return cudaGetLastError();
}

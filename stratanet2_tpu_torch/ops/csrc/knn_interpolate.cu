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
#include <math.h>

#include "common.cuh"

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

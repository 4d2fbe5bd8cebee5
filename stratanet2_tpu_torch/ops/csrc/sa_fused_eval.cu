// Fused set-abstraction interior, eval mode: grouped ball query, gather of
// the per-point projection q, relu(q_j - cterm_c)*a1 + c1, the optional
// second layer relu(h@W2 + b2)*a2 + c2, and the max over the K picks.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_sa_kernel (pallas_call in
// sa_fused_eval). Selection is exactly the JAX grouped ball query
// (stratanet2_tpu/ops/ballquery.py:71-101): K groups of g = ceil(N/K)
// consecutive points; per centroid and group the first point of least
// expanded d2, valid iff d2 <= r^2. The TPU kernel's hi/lo-bf16 distance
// dots, packed min/argmin keys and one-hot MXU gathers are not carried
// over: Hopper gathers q rows with indexed loads.
//
// Bound on the H100: instruction issue in the selection. Every centroid
// scores every point of its cloud: 20 x 2500 x 10000 = 5.0e8 pairs per
// serve step at SA1 and 3.1e7 at SA2, 10.06 SASS instructions each (the
// selection loop of both instances is ball_query.cu's, 161 instructions for
// 16 pairs): an issue floor of 0.160 ms a serve step at 1980 MHz. The apply
// phase runs only for valid picks (~1.4e6 at SA1, K*C*(C1 + 2*C1*C2)
// operations a cloud), and the bytes are a few tens of MB.
//
// Design: one block of 8 warps per (tile of 64 centroids, cloud): the max
// over the K groups needs all of a centroid's picks in one block.
// 1. Select (common.cuh's select_tile, shared with ball_query.cu): the warps
//    split the K groups, each staging its group as float4 [x, y, z, |p|^2]
//    in its own slice of shared memory; a lane holds 2 centroids. Each pick
//    goes to a (64, K) int32 table in shared memory, -1 for none.
// 2. One block barrier, then apply: 4 threads a centroid (adjacent lanes),
//    each taking every 4th slot. A valid pick's q row and the centroid's
//    cterm row are read as float4 from device memory (q lives in L2), the
//    layer-1 affine and layer 2 run in registers with W2 read from shared
//    memory as float4 broadcasts, and the running max stays in registers.
//    The 4 partial maxima meet by two __shfl_xor_sync (max is exact in any
//    order) and the first lane stores the row. Layer 2 stays on CUDA cores
//    in FP32 as an fma chain over the input channel: TF32 would break the
//    1e-4 tolerance against the plain version, and the epilogue is a small
//    part of the work. Layer 1 rounds as the plain version (sub, max, mul,
//    add, each rounded once).
// ptxas: 89 registers (SA1 instance) and 97 (SA2), no spills; the apply
// phase's registers hold the kernel to 2 blocks (16 warps) an SM. Measured
// on an H100 (chip_smoke.py's serve profile, device ms a step, against
// 0.332-0.333): registers capped for 3 or 4 blocks an SM (80 or 64, with
// spills) 0.343 and 0.370; a cluster of 4 blocks a tile, each selecting a
// quarter of the groups and applying a quarter of the centroids with the
// picks read through distributed shared memory, 0.350. Neither is kept.
//   SA1: grid (40, 20) = 800 blocks, 49 KB shared memory each (staging
//        8 x 313 x 16 B, picks 64 x 32 x 4 B); 6.06 blocks a SM, so the
//        last round is one block (~13%) longer on some SMs.
//   SA2: grid (10, 20) = 200 blocks, 21 KB each; 1.5 blocks a SM.
// A group longer than the staging slice that the shared memory left by the
// parameters and the pick table allows (cuda_kernels.sa_fused_eval_max_g:
// 1741 points at SA1's plan, K = 32; the dense plots of subsample_size
// 65,536 have g = 2048) takes the cell grid (`sa_fused_eval_grid_launch`,
// one count, three kernels): sa_grid_kernel, the grid pass of
// cell_grid.cuh; grouped_cull_kernel<true> of grouped_cull.cuh, which
// scores only each centroid's 3 x 3 cells and writes a (b, c, k) int32
// pick table to device memory, the same picks bit for bit; then
// sa_apply_kernel, the apply phase below unchanged, on tiles of 64
// centroids taken in cell order (corder), so the warps of a block read
// neighbouring q rows, each row written back at its centroid's own index.
// Equal picks give equal rows: the layers round alike and the max over
// slots is exact in any order. The earlier design for those groups, streamed
// through the staging slice in chunks, is
// scripts/variants/selection_chunked.cu.
#include <math.h>

#include "grouped_cull.cuh"

constexpr float kNeg = -3.4e38f;
constexpr int kParts = kSelThreads / kSelTile;  // threads a centroid in the apply phase

template <int C1, int C2, bool TWO>
struct Prm {
  static constexpr int kSize = 2 * C1 + (TWO ? C1 * C2 + 3 * C2 : 0);
  static constexpr int kPadded = (kSize + 3) / 4 * 4;
};

// The apply phase of centroid ci (none when ci >= c) by its kParts threads
// (adjacent lanes; this one is `part`): for each valid pick(s) (>= 0) of its
// slots s = part, part + kParts, ..., the q row's layer 1 (and layer 2 with
// TWO), the running max, the parts' maxima met by shuffles and the row
// stored by part 0. sp holds the parameters (16-byte aligned). Every lane
// of the warp must call it (the shuffles).
template <int C1, int C2, bool TWO, typename Pick>
__device__ __forceinline__ void sa_apply(const float* __restrict__ q,
                                         const float* __restrict__ cterm, const float* sp,
                                         float* __restrict__ out, int b, int n, int c, int k,
                                         int ci, int part, Pick pick) {
  float acc[C2];
#pragma unroll
  for (int o = 0; o < C2; ++o) acc[o] = kNeg;
  if (ci < c) {
    const size_t row = static_cast<size_t>(b) * c + ci;
    float ct[C1];
    const float4* ct4 = reinterpret_cast<const float4*>(cterm + row * C1);
#pragma unroll
    for (int i = 0; i < C1 / 4; ++i) {
      const float4 v = ct4[i];
      ct[4 * i] = v.x;
      ct[4 * i + 1] = v.y;
      ct[4 * i + 2] = v.z;
      ct[4 * i + 3] = v.w;
    }
    const float* a1 = sp;
    const float* c1 = sp + C1;
    const float4* qb = reinterpret_cast<const float4*>(q + static_cast<size_t>(b) * n * C1);
    for (int s = part; s < k; s += kParts) {
      const int p = pick(s);
      if (p < 0) continue;  // no point of this group within the radius
      float h[C1];
      const float4* qr = qb + static_cast<size_t>(p) * (C1 / 4);
#pragma unroll
      for (int i = 0; i < C1 / 4; ++i) {
        const float4 v = qr[i];
        h[4 * i] = v.x;
        h[4 * i + 1] = v.y;
        h[4 * i + 2] = v.z;
        h[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < C1; ++i)
        h[i] = __fadd_rn(__fmul_rn(fmaxf(__fsub_rn(h[i], ct[i]), 0.f), a1[i]), c1[i]);
      if constexpr (TWO) {
        const float4* w2 = reinterpret_cast<const float4*>(sp + 2 * C1);  // (C1, C2) row-major
        const float* b2 = sp + 2 * C1 + C1 * C2;
        const float* a2 = b2 + C2;
        const float* c2 = a2 + C2;
        float u[C2];
#pragma unroll
        for (int i = 0; i < C1; ++i) {
#pragma unroll
          for (int o4 = 0; o4 < C2 / 4; ++o4) {
            const float4 w = w2[i * (C2 / 4) + o4];
            const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int o = 4 * o4 + e;
              u[o] = i == 0 ? __fmul_rn(h[0], wv[e]) : __fmaf_rn(h[i], wv[e], u[o]);
            }
          }
        }
#pragma unroll
        for (int o = 0; o < C2; ++o) {
          const float y = __fadd_rn(__fmul_rn(fmaxf(__fadd_rn(u[o], b2[o]), 0.f), a2[o]), c2[o]);
          acc[o] = fmaxf(acc[o], y);
        }
      } else {
#pragma unroll
        for (int o = 0; o < C2; ++o) acc[o] = fmaxf(acc[o], h[o]);
      }
    }
  }
#pragma unroll
  for (int m = 1; m < kParts; m <<= 1) {
#pragma unroll
    for (int o = 0; o < C2; ++o) acc[o] = fmaxf(acc[o], __shfl_xor_sync(0xffffffffu, acc[o], m));
  }
  if (ci < c && part == 0) {
    float4* ob = reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * c + ci) * C2);
#pragma unroll
    for (int o = 0; o < C2 / 4; ++o)
      ob[o] = make_float4(acc[4 * o], acc[4 * o + 1], acc[4 * o + 2], acc[4 * o + 3]);
  }
}

template <int C1, int C2, bool TWO>
__global__ void __launch_bounds__(kSelThreads)
sa_kernel(const float* __restrict__ q, const float* __restrict__ xyz,
          const float* __restrict__ cent, const float* __restrict__ cterm,
          const float* __restrict__ prm, float* __restrict__ out, int n, int c,
          int k, int g, float r2) {
  using P = Prm<C1, C2, TWO>;
  extern __shared__ float4 smem4[];
  float4* stage = smem4;  // select: kSelWarps x g packed points
  float* sp = reinterpret_cast<float*>(smem4 + kSelWarps * static_cast<size_t>(g));
  int* picks = reinterpret_cast<int*>(sp + P::kPadded);  // (kSelTile, k)

  const int b = blockIdx.y, c0 = blockIdx.x * kSelTile;
  for (int i = threadIdx.x; i < P::kSize; i += kSelThreads) sp[i] = prm[i];
  select_tile(cent + static_cast<size_t>(b) * c * 3, xyz + static_cast<size_t>(b) * n * 3, n, c,
              c0, 0, k, g, r2, stage, [&](int ci, int grp, bool ok, int pick) {
                picks[(ci - c0) * k + grp] = ok ? pick : -1;
              });
  __syncthreads();

  const int cl = threadIdx.x / kParts, part = threadIdx.x % kParts;
  sa_apply<C1, C2, TWO>(q, cterm, sp, out, b, n, c, k, c0 + cl, part,
                        [&](int s) { return picks[cl * k + s]; });
}

CELL_GRID_KERNEL(sa_grid_kernel)

// The apply phase on the pick table (b, c, k) of grouped_cull_kernel<true>:
// tile blockIdx.x of 64 centroids in cell order.
template <int C1, int C2, bool TWO>
__global__ void __launch_bounds__(kSelThreads)
sa_apply_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                const float* __restrict__ prm, const int* __restrict__ picks,
                const int* __restrict__ corder, float* __restrict__ out, int n, int c, int k) {
  using P = Prm<C1, C2, TWO>;
  __shared__ __align__(16) float sp[P::kPadded];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < P::kSize; i += kSelThreads) sp[i] = prm[i];
  __syncthreads();
  const int slot = blockIdx.x * kSelTile + threadIdx.x / kParts, part = threadIdx.x % kParts;
  const int ci = slot < c ? corder[static_cast<size_t>(b) * c + slot] : c;
  const int* pk = picks + (static_cast<size_t>(b) * c + min(ci, c - 1)) * k;
  sa_apply<C1, C2, TWO>(q, cterm, sp, out, b, n, c, k, ci, part,
                        [&](int s) { return __ldg(pk + s); });
}

template <int C1, int C2, bool TWO>
static cudaError_t launch(const float* q, const float* xyz, const float* cent,
                          const float* cterm, const float* prm, float* out, int b,
                          int n, int c, int k, int g, float r2, cudaStream_t stream) {
  using P = Prm<C1, C2, TWO>;
  const size_t smem = sizeof(float4) * kSelWarps * static_cast<size_t>(g) +
                      sizeof(float) * P::kPadded + sizeof(int) * kSelTile * static_cast<size_t>(k);
  const dim3 grid((c + kSelTile - 1) / kSelTile, b);
  cudaError_t err = allow_smem(sa_kernel<C1, C2, TWO>, smem);
  if (err != cudaSuccess) return err;
  sa_kernel<C1, C2, TWO><<<grid, kSelThreads, smem, stream>>>(q, xyz, cent, cterm, prm, out, n,
                                                              c, k, g, r2);
  return cudaGetLastError();
}

template <int C1, int C2, bool TWO>
static cudaError_t launch_grid_path(const float* q, const float* xyz, const float* cent,
                                    const float* cterm, const float* prm, float* out, int* ws,
                                    int* picks, int b, int n, int c, int k, int gmax, float r2,
                                    int cs, cudaStream_t stream) {
  const CellWs w = carve_cells(ws, b, n, c, gmax);
  cudaError_t err = launch_cell_grid(sa_grid_kernel, cent, xyz, w, b, n, c, gmax, r2, cs, stream);
  if (err != cudaSuccess) return err;
  err = launch_grouped_cull<true>(cent, w, picks, nullptr, b, n, c, k, gmax, r2, stream);
  if (err != cudaSuccess) return err;
  sa_apply_kernel<C1, C2, TWO><<<dim3((c + kSelTile - 1) / kSelTile, b), kSelThreads, 0,
                                 stream>>>(q, cterm, prm, picks, w.corder, out, n, c, k);
  return cudaGetLastError();
}

// q (b, n, c1), xyz (b, n, 3), cent (b, c, 3), cterm (b, c, c1), prm packed
// [a1, c1, (W2 (c1, c2), b2, a2, c2)] -> out (b, c, c2); q, cterm and out
// 16-byte aligned; g = ceil(n / k) <= sa_fused_eval_max_g, each group
// staged whole. Instances: SA1 (16 -> 16, two layers) and SA2 (32, one
// layer).
extern "C" int sa_fused_eval_launch(const float* q, const float* xyz, const float* cent,
                                    const float* cterm, const float* prm, float* out,
                                    int b, int n, int c, int k, int g, int c1, int c2,
                                    int two_layer, float r2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c1 == 16 && c2 == 16 && two_layer)
    return launch<16, 16, true>(q, xyz, cent, cterm, prm, out, b, n, c, k, g, r2, st);
  if (c1 == 32 && c2 == 32 && !two_layer)
    return launch<32, 32, false>(q, xyz, cent, cterm, prm, out, b, n, c, k, g, r2, st);
  return cudaErrorInvalidValue;
}

// The same on the cell grid, for any g: ws is the grid's workspace
// (cell_grid.cuh's CellWs, cuda_kernels._cell_layout), picks a (b, c, k)
// int32 scratch, gmax the grid's cells a side at most, cs the grid pass's
// blocks a cloud.
extern "C" int sa_fused_eval_grid_launch(const float* q, const float* xyz, const float* cent,
                                         const float* cterm, const float* prm, float* out,
                                         int* ws, int* picks, int b, int n, int c, int k,
                                         int gmax, int c1, int c2, int two_layer, float r2,
                                         int cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c1 == 16 && c2 == 16 && two_layer)
    return launch_grid_path<16, 16, true>(q, xyz, cent, cterm, prm, out, ws, picks, b, n, c, k,
                                          gmax, r2, cs, st);
  if (c1 == 32 && c2 == 32 && !two_layer)
    return launch_grid_path<32, 32, false>(q, xyz, cent, cterm, prm, out, ws, picks, b, n, c, k,
                                           gmax, r2, cs, st);
  return cudaErrorInvalidValue;
}

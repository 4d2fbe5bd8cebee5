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
// 1741 points at SA1's plan, K = 32) streams through it in chunks of that
// length (common.cuh's select_tile): the dense plots of subsample_size
// 65,536 (g = 2048), at one block an SM.
#include <math.h>

#include "common.cuh"

constexpr float kNeg = -3.4e38f;
constexpr int kParts = kSelThreads / kSelTile;  // threads a centroid in the apply phase

template <int C1, int C2, bool TWO>
struct Prm {
  static constexpr int kSize = 2 * C1 + (TWO ? C1 * C2 + 3 * C2 : 0);
  static constexpr int kPadded = (kSize + 3) / 4 * 4;
};

template <int C1, int C2, bool TWO, bool CHUNKED>
__global__ void __launch_bounds__(kSelThreads)
sa_kernel(const float* __restrict__ q, const float* __restrict__ xyz,
          const float* __restrict__ cent, const float* __restrict__ cterm,
          const float* __restrict__ prm, float* __restrict__ out, int n, int c,
          int k, int g, int gc, float r2) {
  using P = Prm<C1, C2, TWO>;
  extern __shared__ float4 smem4[];
  float4* stage = smem4;  // select: kSelWarps x gc packed points
  float* sp = reinterpret_cast<float*>(smem4 + kSelWarps * static_cast<size_t>(gc));
  int* picks = reinterpret_cast<int*>(sp + P::kPadded);  // (kSelTile, k)

  const int b = blockIdx.y, c0 = blockIdx.x * kSelTile;
  for (int i = threadIdx.x; i < P::kSize; i += kSelThreads) sp[i] = prm[i];
  select_tile<CHUNKED>(cent + static_cast<size_t>(b) * c * 3,
                       xyz + static_cast<size_t>(b) * n * 3, n, c, c0, 0, k, g, gc, r2,
                       stage, [&](int ci, int grp, bool ok, int pick) {
                         picks[(ci - c0) * k + grp] = ok ? pick : -1;
                       });
  __syncthreads();

  const int cl = threadIdx.x / kParts, part = threadIdx.x % kParts;
  const int ci = c0 + cl;
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
      const int p = picks[cl * k + s];
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
static cudaError_t launch(const float* q, const float* xyz, const float* cent,
                          const float* cterm, const float* prm, float* out, int b,
                          int n, int c, int k, int g, int gc, float r2, cudaStream_t stream) {
  using P = Prm<C1, C2, TWO>;
  const size_t smem = sizeof(float4) * kSelWarps * static_cast<size_t>(gc) +
                      sizeof(float) * P::kPadded + sizeof(int) * kSelTile * static_cast<size_t>(k);
  const dim3 grid((c + kSelTile - 1) / kSelTile, b);
  cudaError_t err;
  if (gc < g) {
    err = allow_smem(sa_kernel<C1, C2, TWO, true>, smem);
    if (err != cudaSuccess) return err;
    sa_kernel<C1, C2, TWO, true><<<grid, kSelThreads, smem, stream>>>(q, xyz, cent, cterm, prm,
                                                                     out, n, c, k, g, gc, r2);
  } else {
    err = allow_smem(sa_kernel<C1, C2, TWO, false>, smem);
    if (err != cudaSuccess) return err;
    sa_kernel<C1, C2, TWO, false><<<grid, kSelThreads, smem, stream>>>(q, xyz, cent, cterm, prm,
                                                                      out, n, c, k, g, gc, r2);
  }
  return cudaGetLastError();
}

// q (b, n, c1), xyz (b, n, 3), cent (b, c, 3), cterm (b, c, c1), prm packed
// [a1, c1, (W2 (c1, c2), b2, a2, c2)] -> out (b, c, c2); q, cterm and out
// 16-byte aligned; g = ceil(n / k), gc <= g the points a warp stages at
// once (cuda_kernels.sel_chunk). Instances: SA1 (16 -> 16, two layers) and
// SA2 (32, one layer).
extern "C" int sa_fused_eval_launch(const float* q, const float* xyz, const float* cent,
                                    const float* cterm, const float* prm, float* out,
                                    int b, int n, int c, int k, int g, int gc, int c1, int c2,
                                    int two_layer, float r2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c1 == 16 && c2 == 16 && two_layer)
    return launch<16, 16, true>(q, xyz, cent, cterm, prm, out, b, n, c, k, g, gc, r2, st);
  if (c1 == 32 && c2 == 32 && !two_layer)
    return launch<32, 32, false>(q, xyz, cent, cterm, prm, out, b, n, c, k, g, gc, r2, st);
  return cudaErrorInvalidValue;
}

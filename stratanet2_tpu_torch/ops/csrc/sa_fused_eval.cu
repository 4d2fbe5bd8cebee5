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
// over: Hopper gathers with an indexed shared-memory load.
//
// Bound on the H100: arithmetic. Every centroid scores every point of its
// cloud (~9 flops each: 2.5e9 centroid-point pairs per serve step at SA1),
// while the bytes are a few tens of MB; the K-slot epilogue is a small
// fraction (SA1: K*C*(C1 + 2*C1*C2) per cloud).
//
// Design: one block per (cloud, tile of 128 centroids), one thread per
// centroid. The block walks the K groups; each group's xyz, |p|^2 and q rows
// are staged in shared memory (SA1: 313 x (4 + 17) x 4 B = 26 KB) and read
// by all threads as broadcasts, so device memory is read once per block.
// q rows are padded to C1+1 floats so that the threads' scattered winner
// reads spread over the banks. The centroid's cterm, the running max and
// the layer-1 activations stay in registers; the folded BN affines and W2
// (16x16) sit in shared memory. The d2 arithmetic uses _rn intrinsics in the
// JAX rounding (common.cuh), so the picks equal the plain version's; the
// per-group pick is common.cuh's group_nearest, shared with ball_query.cu.
#include <math.h>

#include "common.cuh"

constexpr int kThreads = 128;
constexpr float kNeg = -3.4e38f;

template <int C1, int C2, bool TWO>
__global__ void __launch_bounds__(kThreads)
sa_kernel(const float* __restrict__ q, const float* __restrict__ xyz,
          const float* __restrict__ cent, const float* __restrict__ cterm,
          const float* __restrict__ prm, float* __restrict__ out, int n, int c,
          int k, int g, float r2) {
  constexpr int kPrm = 2 * C1 + (TWO ? C1 * C2 + 3 * C2 : 0);
  constexpr int kRow = C1 + 1;  // padded q row in shared memory
  extern __shared__ float smem[];
  float* sp = smem;              // a1 | c1 | W2 (C1 x C2, row-major) | b2 | a2 | c2
  float* gx = smem + kPrm;       // group tile: x, y, z, |p|^2, q rows
  float* gy = gx + g;
  float* gz = gy + g;
  float* gn = gz + g;
  float* gq = gn + g;

  const int b = blockIdx.y;
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = ci < c;
  for (int i = threadIdx.x; i < kPrm; i += blockDim.x) sp[i] = prm[i];

  const size_t row = static_cast<size_t>(b) * c + (active ? ci : 0);
  const float cx = cent[row * 3], cy = cent[row * 3 + 1], cz = cent[row * 3 + 2];
  float ct[C1];
#pragma unroll
  for (int i = 0; i < C1; ++i) ct[i] = cterm[row * C1 + i];
  const float cn = sq3_rn(cx, cy, cz);
  float acc[C2];
#pragma unroll
  for (int o = 0; o < C2; ++o) acc[o] = kNeg;

  const float* xb = xyz + static_cast<size_t>(b) * n * 3;
  const float* qb = q + static_cast<size_t>(b) * n * C1;
  for (int grp = 0; grp < k; ++grp) {
    const int first = grp * g;
    const int cnt = max(0, min(g, n - first));  // ragged or empty last groups
    __syncthreads();  // the previous group's tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const float x = xb[3 * (first + j)];
      const float y = xb[3 * (first + j) + 1];
      const float z = xb[3 * (first + j) + 2];
      gx[j] = x;
      gy[j] = y;
      gz[j] = z;
      gn[j] = sq3_rn(x, y, z);
    }
    for (int e = threadIdx.x; e < cnt * C1; e += blockDim.x) {
      gq[(e / C1) * kRow + e % C1] = qb[static_cast<size_t>(first) * C1 + e];
    }
    __syncthreads();
    if (!active) continue;

    float dmin;
    int jmin;
    group_nearest(cx, cy, cz, cn, gx, gy, gz, gn, cnt, dmin, jmin);
    if (!(dmin <= r2)) continue;  // no point of this group within the radius

    const float* qs = gq + jmin * kRow;
    float h[C1];
#pragma unroll
    for (int i = 0; i < C1; ++i) h[i] = fmaxf(qs[i] - ct[i], 0.f) * sp[i] + sp[C1 + i];
    if constexpr (TWO) {
      const float* w2 = sp + 2 * C1;
      const float* b2 = w2 + C1 * C2;
      const float* a2 = b2 + C2;
      const float* c2 = a2 + C2;
#pragma unroll
      for (int o = 0; o < C2; ++o) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < C1; ++i) s += h[i] * w2[i * C2 + o];
        acc[o] = fmaxf(acc[o], fmaxf(s + b2[o], 0.f) * a2[o] + c2[o]);
      }
    } else {
#pragma unroll
      for (int o = 0; o < C2; ++o) acc[o] = fmaxf(acc[o], h[o]);
    }
  }
  if (active) {
    float* ob = out + (static_cast<size_t>(b) * c + ci) * C2;
#pragma unroll
    for (int o = 0; o < C2; ++o) ob[o] = acc[o];
  }
}

template <int C1, int C2, bool TWO>
static cudaError_t launch(const float* q, const float* xyz, const float* cent,
                          const float* cterm, const float* prm, float* out, int b,
                          int n, int c, int k, int g, float r2, cudaStream_t stream) {
  constexpr int kPrm = 2 * C1 + (TWO ? C1 * C2 + 3 * C2 : 0);
  const size_t smem = sizeof(float) * (kPrm + static_cast<size_t>(g) * (4 + C1 + 1));
  cudaError_t err = allow_smem(sa_kernel<C1, C2, TWO>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kThreads - 1) / kThreads, b);
  sa_kernel<C1, C2, TWO><<<grid, kThreads, smem, stream>>>(q, xyz, cent, cterm, prm, out,
                                                           n, c, k, g, r2);
  return cudaGetLastError();
}

// q (b, n, c1), xyz (b, n, 3), cent (b, c, 3), cterm (b, c, c1), prm packed
// [a1, c1, (W2 (c1, c2), b2, a2, c2)] -> out (b, c, c2). Instances: SA1
// (16 -> 16, two layers) and SA2 (32, one layer).
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

// The earlier design of the grouped selection's long groups (rows 4a and 5a of
// PERF.md), kept as a variant and timed against the package's cell-grid
// design by scripts/kernel_variants.py (`selection`): a group longer than a
// warp's staging slice (cuda_kernels.BQ_MAX_G, sa_fused_eval_max_g) streams
// through it in chunks of gc points in index order, each centroid's (dmin,
// jmin) carried across chunks with the same strict <, so the pick is the
// group's first point of least d2; every centroid scores every point of its
// cloud, and the slices fill the shared memory, one block an SM.
//
// Built from this file alone: it includes csrc/ball_query.cu and
// csrc/sa_fused_eval.cu (nvcc -I csrc), so its library also holds the
// package's entries, and the harness times both designs in one process.
#include "ball_query.cu"
#include "sa_fused_eval.cu"

// common.cuh's select_tile with the chunk loop: `stage` holds
// kSelWarps * gc float4, gc < g points of a group at a time.
template <typename Emit>
__device__ __forceinline__ void select_tile_chunked(const float* __restrict__ cent_b,
                                                    const float* __restrict__ xb, int n, int c,
                                                    int c0, int grp0, int grp1, int g, int gc,
                                                    float r2, float4* stage, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float cx[kSelR], cy[kSelR], cz[kSelR], cn[kSelR];
#pragma unroll
  for (int r = 0; r < kSelR; ++r) {
    const int ci = min(c0 + lane + 32 * r, c - 1);  // past the end: computed, never emitted
    cx[r] = cent_b[3 * ci];
    cy[r] = cent_b[3 * ci + 1];
    cz[r] = cent_b[3 * ci + 2];
    cn[r] = sq3_rn(cx[r], cy[r], cz[r]);
  }
  float4* mine = stage + static_cast<size_t>(warp) * gc;
  for (int grp = grp0 + warp; grp < grp1; grp += kSelWarps) {
    const int first = grp * g;
    const int cnt = max(0, min(g, n - first));
    float dmin[kSelR];
    int jmin[kSelR];
#pragma unroll
    for (int r = 0; r < kSelR; ++r) {
      dmin[r] = INFINITY;  // an empty group: no chunk, ok = false
      jmin[r] = 0;
    }
    for (int j0 = 0; j0 < cnt; j0 += gc) {
      const int m = min(gc, cnt - j0);
      __syncwarp();  // the warp's previous chunk is no longer read
      for (int j = lane; j < m; j += 32) {
        const float* p = xb + 3 * static_cast<size_t>(first + j0 + j);
        const float x = p[0], y = p[1], z = p[2];
        mine[j] = make_float4(x, y, z, sq3_rn(x, y, z));
      }
      __syncwarp();
      float cmin[kSelR];
      int cj[kSelR];
      group_nearest(cx, cy, cz, cn, mine, m, cmin, cj);
#pragma unroll
      for (int r = 0; r < kSelR; ++r) {
        if (cmin[r] < dmin[r]) {  // strict: an equal d2 of a later chunk loses
          dmin[r] = cmin[r];
          jmin[r] = j0 + cj[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSelR; ++r) {
      const int ci = c0 + lane + 32 * r;
      if (ci < c) emit(ci, grp, dmin[r] <= r2, first + jmin[r]);
    }
  }
}

__global__ void __launch_bounds__(kSelThreads)
ball_query_chunked_kernel(const float* __restrict__ cent, const float* __restrict__ xyz,
                          int* __restrict__ idx, uint8_t* __restrict__ mask, int n, int c, int k,
                          int g, int gc, float r2) {
  extern __shared__ float4 stage[];
  const int b = blockIdx.y;
  const int tiles = (c + kSelTile - 1) / kSelTile;
  const int c0 = (blockIdx.x % tiles) * kSelTile, grp0 = (blockIdx.x / tiles) * kSelWarps;
  int* ib = idx + static_cast<size_t>(b) * c * k;
  uint8_t* mb = mask + static_cast<size_t>(b) * c * k;
  select_tile_chunked(cent + static_cast<size_t>(b) * c * 3, xyz + static_cast<size_t>(b) * n * 3,
                      n, c, c0, grp0, min(grp0 + kSelWarps, k), g, gc, r2, stage,
                      [&](int ci, int grp, bool ok, int pick) {
                        const size_t o = static_cast<size_t>(ci) * k + grp;
                        ib[o] = ok ? pick : 0;
                        mb[o] = ok ? 1 : 0;
                      });
}

template <int C1, int C2, bool TWO>
__global__ void __launch_bounds__(kSelThreads)
sa_chunked_kernel(const float* __restrict__ q, const float* __restrict__ xyz,
                  const float* __restrict__ cent, const float* __restrict__ cterm,
                  const float* __restrict__ prm, float* __restrict__ out, int n, int c, int k,
                  int g, int gc, float r2) {
  using P = Prm<C1, C2, TWO>;
  extern __shared__ float4 smem4[];
  float4* stage = smem4;  // select: kSelWarps x gc packed points
  float* sp = reinterpret_cast<float*>(smem4 + kSelWarps * static_cast<size_t>(gc));
  int* picks = reinterpret_cast<int*>(sp + P::kPadded);  // (kSelTile, k)

  const int b = blockIdx.y, c0 = blockIdx.x * kSelTile;
  for (int i = threadIdx.x; i < P::kSize; i += kSelThreads) sp[i] = prm[i];
  select_tile_chunked(cent + static_cast<size_t>(b) * c * 3, xyz + static_cast<size_t>(b) * n * 3,
                      n, c, c0, 0, k, g, gc, r2, stage, [&](int ci, int grp, bool ok, int pick) {
                        picks[(ci - c0) * k + grp] = ok ? pick : -1;
                      });
  __syncthreads();

  const int cl = threadIdx.x / kParts, part = threadIdx.x % kParts;
  sa_apply<C1, C2, TWO>(q, cterm, sp, out, b, n, c, k, c0 + cl, part,
                        [&](int s) { return picks[cl * k + s]; });
}

// The chunked ball_query_launch past BQ_MAX_G: chunks of gc points.
extern "C" int ball_query_chunked_launch(const float* cent, const float* xyz, int* idx,
                                         uint8_t* mask, int b, int n, int c, int k, int g, int gc,
                                         float r2, void* stream) {
  const size_t smem = sizeof(float4) * kSelWarps * static_cast<size_t>(gc);
  const dim3 grid((c + kSelTile - 1) / kSelTile * ((k + kSelWarps - 1) / kSelWarps), b);
  cudaError_t err = allow_smem(ball_query_chunked_kernel, smem);
  if (err != cudaSuccess) return err;
  ball_query_chunked_kernel<<<grid, kSelThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cent, xyz, idx, mask, n, c, k, g, gc, r2);
  return cudaGetLastError();
}

template <int C1, int C2, bool TWO>
static cudaError_t launch_chunked(const float* q, const float* xyz, const float* cent,
                                  const float* cterm, const float* prm, float* out, int b, int n,
                                  int c, int k, int g, int gc, float r2, cudaStream_t stream) {
  using P = Prm<C1, C2, TWO>;
  const size_t smem = sizeof(float4) * kSelWarps * static_cast<size_t>(gc) +
                      sizeof(float) * P::kPadded + sizeof(int) * kSelTile * static_cast<size_t>(k);
  cudaError_t err = allow_smem(sa_chunked_kernel<C1, C2, TWO>, smem);
  if (err != cudaSuccess) return err;
  sa_chunked_kernel<C1, C2, TWO><<<dim3((c + kSelTile - 1) / kSelTile, b), kSelThreads, smem,
                                   stream>>>(q, xyz, cent, cterm, prm, out, n, c, k, g, gc, r2);
  return cudaGetLastError();
}

// The chunked sa_fused_eval_launch past sa_fused_eval_max_g: chunks of gc points.
extern "C" int sa_fused_eval_chunked_launch(const float* q, const float* xyz, const float* cent,
                                            const float* cterm, const float* prm, float* out,
                                            int b, int n, int c, int k, int g, int gc, int c1,
                                            int c2, int two_layer, float r2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c1 == 16 && c2 == 16 && two_layer)
    return launch_chunked<16, 16, true>(q, xyz, cent, cterm, prm, out, b, n, c, k, g, gc, r2, st);
  if (c1 == 32 && c2 == 32 && !two_layer)
    return launch_chunked<32, 32, false>(q, xyz, cent, cterm, prm, out, b, n, c, k, g, gc, r2,
                                         st);
  return cudaErrorInvalidValue;
}

// Shared by every kernel library of ops/csrc/ (each .cu builds into its own
// shared library with a plain C interface, loaded with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Launch errors (too many threads, too much shared memory) are reported by
// cudaGetLastError() right after the launch, not by a later synchronize:
// every entry point returns it and the Python wrapper raises on non-zero.
extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 3-term sums of products as the JAX CPU path (XLA) rounds them: a chain of
// fused multiply-adds, fma(z, z', fma(y, y', x*x')), each rounded once. The
// plain PyTorch versions compute the same (stratanet2_tpu_torch/ops/
// distance.py); explicit intrinsics keep nvcc from choosing another order,
// since a distance that rounds differently can change a near-tie pick.
__device__ __forceinline__ float dot3_rn(float ax, float ay, float az, float bx,
                                         float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

__device__ __forceinline__ float sq3_rn(float x, float y, float z) {
  return dot3_rn(x, y, z, x, y, z);
}

// Expanded squared distance max((|a|^2 - 2 a.b) + |b|^2, 0), the form of
// stratanet2_tpu/ops/ballquery.py:76-88 and knn.py:79-86.
__device__ __forceinline__ float expanded_d2_rn(float a_sq, float ab, float b_sq) {
  return fmaxf(__fadd_rn(__fsub_rn(a_sq, __fmul_rn(2.0f, ab)), b_sq), 0.0f);
}

// expanded_d2_rn in one instruction less: fma(-2, ab, a_sq) equals
// fsub(a_sq, fmul(2, ab)) bit for bit whenever fmul(2, ab) is finite
// (|ab| < 2^127, i.e. coordinates below ~9e18 in magnitude). Doubling is
// exact in binary floating point, subnormals included, so both forms round
// the one exact value a_sq - 2*ab once, to nearest even. (chip_smoke.py
// holds both selection kernels to the plain version, which rounds the
// two-step form: 0 differing picks.)
__device__ __forceinline__ float expanded_d2_sel(float a_sq, float ab, float b_sq) {
  return fmaxf(__fadd_rn(__fmaf_rn(-2.0f, ab, a_sq), b_sq), 0.0f);
}

// The grouped ball query's selection, shared by ball_query.cu and
// sa_fused_eval.cu so that the standalone query and the fused SA interior
// cannot pick differently; both pick as stratanet2_tpu/ops/ballquery.py:71-101.
//
// A block owns a tile of kSelTile centroids of one cloud and a range of the
// K groups of g = ceil(N/K) consecutive points (all K in the fused SA
// kernel, 8 in the standalone query). Its kSelWarps warps split the range
// (warp w takes groups w, w + kSelWarps, ...) and need no block barrier: a
// warp stages its group into its own slice of shared memory, packed as
// float4 [x, y, z, |p|^2] (one broadcast load a point), with __syncwarp
// around it. Lane l holds the kSelR centroids l + 32 r of the tile in
// registers, so each staged point feeds kSelR independent distance chains.
// The slice holds gc points (the wrapper's cuda_kernels.sel_chunk: gc = g
// when the block's shared memory holds kSelWarps whole groups, as at every
// PROD shape). A longer group streams through the slice in chunks of gc
// points in index order, carrying each centroid's (dmin, jmin) across
// chunks with the same strict <, so the pick is still the group's first
// point of least d2, as jnp.argmin over the group.
constexpr int kSelWarps = 8;
constexpr int kSelThreads = 32 * kSelWarps;
constexpr int kSelR = 2;
constexpr int kSelTile = 32 * kSelR;

// Per centroid r, the first point of least expanded d2 (strict <, in index
// order) among `cnt` staged points; an empty group leaves dmin = +inf.
__device__ __forceinline__ void group_nearest(const float (&cx)[kSelR], const float (&cy)[kSelR],
                                              const float (&cz)[kSelR], const float (&cn)[kSelR],
                                              const float4* __restrict__ pts, int cnt,
                                              float (&dmin)[kSelR], int (&jmin)[kSelR]) {
#pragma unroll
  for (int r = 0; r < kSelR; ++r) {
    dmin[r] = INFINITY;
    jmin[r] = 0;
  }
#pragma unroll 8
  for (int j = 0; j < cnt; ++j) {
    const float4 p = pts[j];
#pragma unroll
    for (int r = 0; r < kSelR; ++r) {
      const float d2 = expanded_d2_sel(cn[r], dot3_rn(cx[r], cy[r], cz[r], p.x, p.y, p.z), p.w);
      if (d2 < dmin[r]) {
        dmin[r] = d2;
        jmin[r] = j;
      }
    }
  }
}

// Runs the selection of the block's tile (centroids c0 .. c0 + kSelTile of
// the cloud at cent_b (c, 3), points xb (n, 3)) over groups grp0 .. grp1 - 1
// and calls emit(ci, grp, ok, pick) once for each centroid ci < c and group
// grp, from the lane that owns ci: ok iff the group's least d2 is <= r2, pick
// its point's index in the cloud. A ragged last group is searched over its
// real points only; an empty one gives ok = false. `stage` holds
// kSelWarps * gc float4: gc = g without CHUNKED (one pass a group, the
// kernels' PROD instances, compiled as before chunking existed), gc < g
// with it (chunks of gc points a group).
template <bool CHUNKED, typename Emit>
__device__ __forceinline__ void select_tile(const float* __restrict__ cent_b,
                                            const float* __restrict__ xb, int n, int c, int c0,
                                            int grp0, int grp1, int g, int gc, float r2,
                                            float4* stage, Emit emit) {
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
  if (!CHUNKED) gc = g;
  float4* mine = stage + static_cast<size_t>(warp) * gc;
  for (int grp = grp0 + warp; grp < grp1; grp += kSelWarps) {
    const int first = grp * g;
    const int cnt = max(0, min(g, n - first));
    float dmin[kSelR];
    int jmin[kSelR];
    if constexpr (!CHUNKED) {
      __syncwarp();  // the warp's previous group is no longer read
      for (int j = lane; j < cnt; j += 32) {
        const float* p = xb + 3 * static_cast<size_t>(first + j);
        const float x = p[0], y = p[1], z = p[2];
        mine[j] = make_float4(x, y, z, sq3_rn(x, y, z));
      }
      __syncwarp();
      group_nearest(cx, cy, cz, cn, mine, cnt, dmin, jmin);
    } else {
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
    }
#pragma unroll
    for (int r = 0; r < kSelR; ++r) {
      const int ci = c0 + lane + 32 * r;
      if (ci < c) emit(ci, grp, dmin[r] <= r2, first + jmin[r]);
    }
  }
}

// Inclusive sum over the warp's lanes (all 32 must call it).
__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(~0u, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Opt in to dynamic shared memory above the 48 KB default (once per size).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

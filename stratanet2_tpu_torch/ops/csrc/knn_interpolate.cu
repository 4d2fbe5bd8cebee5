// Exact 3-NN inverse-distance-squared interpolation.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_knn_kernel (pallas_call in
// _knn_pallas_raw, wrapped by knn_interpolate_pallas). It computes what the
// JAX exact path _knn_single (stratanet2_tpu/ops/knn.py:71-96) computes:
// expanded d2 = max((|t|^2 - 2 t.s) + |s|^2, 0), the three least in
// (d2, index) order (three first-argmin passes), weights 1/max(d2, 1e-16)
// from those same clamped d2, and sum_j w_j x_j / sum_j w_j, each rounded as
// XLA rounds it (fma chains, see common.cuh). The TPU
// kernel's hi/lo-bf16 11-wide dot, re-subtracted d2 and one-hot MXU gather
// are not carried over.
//
// Bound on the H100: arithmetic. Each target scores every source of its
// cloud (~9 flops per pair: 1.25e9 pairs at FP1 of the serve step); the
// bytes (features, positions, outputs) are tens of MB.
//
// Design: one thread per target, 256 targets per block. Sources stream
// through shared memory in tiles of 1024 (x, y, z, |s|^2, 16 KB) read as
// broadcasts; each thread keeps a running top-3 in registers, inserting with
// strict < in index order, so ties keep the lowest index as the argmin
// passes do. d2 uses _rn intrinsics in the JAX rounding. The feature
// gather and the output rows are then done warp-cooperatively: the warp
// walks its 32 targets and its lanes cover the F features of each, so the
// reads of source rows and the writes of output rows are coalesced.
#include <math.h>

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ xs, const float* __restrict__ ps,
           const float* __restrict__ pt, float* __restrict__ out,
           int* __restrict__ idx_out, float* __restrict__ w_out, int s, int t, int f) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], sn[kTile];
  const int b = blockIdx.y;
  const int ti = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = ti < t;
  const float* tp = pt + (static_cast<size_t>(b) * t + (active ? ti : 0)) * 3;
  const float tx = tp[0], ty = tp[1], tz = tp[2];
  const float tn = sq3_rn(tx, ty, tz);

  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  const float* pb = ps + static_cast<size_t>(b) * s * 3;
  for (int base = 0; base < s; base += kTile) {
    const int cnt = min(kTile, s - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const float x = pb[3 * (base + j)], y = pb[3 * (base + j) + 1],
                  z = pb[3 * (base + j) + 2];
      sx[j] = x;
      sy[j] = y;
      sz[j] = z;
      sn[j] = sq3_rn(x, y, z);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float d = expanded_d2_rn(tn, dot3_rn(tx, ty, tz, sx[j], sy[j], sz[j]), sn[j]);
      if (d < d2) {
        const int id = base + j;
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = id;
          } else {
            d1 = d;
            i1 = id;
          }
        } else {
          d2 = d;
          i2 = id;
        }
      }
    }
  }

  const float w0 = __frcp_rn(fmaxf(d0, 1e-16f));
  const float w1 = __frcp_rn(fmaxf(d1, 1e-16f));
  const float w2 = __frcp_rn(fmaxf(d2, 1e-16f));
  const float wsum = __fadd_rn(__fadd_rn(w0, w1), w2);
  if (active) {
    const size_t o = static_cast<size_t>(b) * 3 * t + ti;
    idx_out[o] = i0;
    idx_out[o + t] = i1;
    idx_out[o + 2 * t] = i2;
    w_out[o] = __fdiv_rn(w0, wsum);
    w_out[o + t] = __fdiv_rn(w1, wsum);
    w_out[o + 2 * t] = __fdiv_rn(w2, wsum);
  }

  // warp-cooperative gather: lanes cover the features of one target at a time
  const int lane = threadIdx.x & 31;
  const float* xb = xs + static_cast<size_t>(b) * s * f;
  const int warp_first = ti - lane;
  for (int l = 0; l < 32; ++l) {
    const int tl = warp_first + l;
    const int j0 = __shfl_sync(0xffffffffu, i0, l);
    const int j1 = __shfl_sync(0xffffffffu, i1, l);
    const int j2 = __shfl_sync(0xffffffffu, i2, l);
    const float v0 = __shfl_sync(0xffffffffu, w0, l);
    const float v1 = __shfl_sync(0xffffffffu, w1, l);
    const float v2 = __shfl_sync(0xffffffffu, w2, l);
    const float vs = __shfl_sync(0xffffffffu, wsum, l);
    if (tl >= t) break;  // the same for every lane of the warp
    float* ob = out + (static_cast<size_t>(b) * t + tl) * f;
    for (int ch = lane; ch < f; ch += 32) {
      const float acc = __fmaf_rn(
          xb[static_cast<size_t>(j2) * f + ch], v2,
          __fmaf_rn(xb[static_cast<size_t>(j1) * f + ch], v1,
                    __fmul_rn(xb[static_cast<size_t>(j0) * f + ch], v0)));
      ob[ch] = __fdiv_rn(acc, vs);
    }
  }
}

// xs (b, s, f), ps (b, s, 3), pt (b, t, 3) -> out (b, t, f), idx (b, 3, t)
// i32, w (b, 3, t) normalised weights.
extern "C" int knn_interpolate_launch(const float* xs, const float* ps, const float* pt,
                                      float* out, int* idx, float* w, int b, int s,
                                      int t, int f, void* stream) {
  const dim3 grid((t + kThreads - 1) / kThreads, b);
  knn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(xs, ps, pt, out, idx,
                                                                       w, s, t, f);
  return cudaGetLastError();
}

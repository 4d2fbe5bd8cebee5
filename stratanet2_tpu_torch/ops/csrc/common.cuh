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

// The grouped ball query's pick in one group of `cnt` points staged in
// shared memory (x, y, z, |p|^2 as separate arrays): the first point of
// least expanded d2 (strict <, in index order). The caller tests dmin <= r^2;
// an empty group leaves dmin = +inf. Shared by ball_query.cu and
// sa_fused_eval.cu, so the standalone query and the fused SA interior pick
// alike, and both as stratanet2_tpu/ops/ballquery.py:71-101 does.
__device__ __forceinline__ void group_nearest(float cx, float cy, float cz, float cn,
                                              const float* gx, const float* gy,
                                              const float* gz, const float* gn, int cnt,
                                              float& dmin, int& jmin) {
  dmin = INFINITY;
  jmin = 0;
  for (int j = 0; j < cnt; ++j) {
    const float d2 = expanded_d2_rn(cn, dot3_rn(cx, cy, cz, gx[j], gy[j], gz[j]), gn[j]);
    if (d2 < dmin) {
      dmin = d2;
      jmin = j;
    }
  }
}

// Opt in to dynamic shared memory above the 48 KB default (once per size).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

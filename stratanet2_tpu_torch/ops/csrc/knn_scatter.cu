// Weighted scatter-add, the backward of kNN interpolation and of row gathers:
// dx[b, idx[b, j, t], :] += w[b, j, t] * g[b, t, :] into a zeroed dx.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_knn_scatter_kernel
// (pallas_call in _knn_scatter_pallas), which backs both the kNN VJP
// (FP2, FP1: k = 3, the forward's normalised weights) and, through
// scatter_add_pallas, the VJP of gather_rows (SA2's gather of the
// pre-projected rows: k = 1, w = ones, passed here as a null pointer). The
// TPU kernel's one-hot MXU matmuls and hi/lo-bf16 operands exist because
// TPU scatters serialise; they are not carried over.
//
// Bound on the H100: bytes. A call reads g (B, T, F) and idx/w (B, k, T)
// once and writes dx (B, S, F) once (FP1 of the PROD train step: 27 + 4.8 +
// 6.8 MB; SA2's gather: 102 + 3.2 + 6.4 MB), against 2 operations per
// contribution.
//
// Design: one thread per element of g (b, t, f), so neighbouring threads
// read neighbouring cotangents and add into neighbouring features of the
// same destination row; each thread adds its k weighted values with float
// atomicAdd into device memory (red.global.add.f32). The order of the adds
// is not fixed, so two runs may differ in the last bits of a sum; the plain
// version accumulates in float64 and chip_smoke.py holds the kernel to the
// float32 error bound of a sum in any order. Indices outside [0, S) are
// skipped (the plain version raises on them).
#include "common.cuh"

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
knn_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                   const float* __restrict__ g, float* __restrict__ dx, int s, int t,
                   int f, int k, size_t total) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const size_t bt = e / f;
  const int ch = static_cast<int>(e - bt * f);
  const int b = static_cast<int>(bt / t);
  const int ti = static_cast<int>(bt - static_cast<size_t>(b) * t);
  const float gv = g[e];
  for (int j = 0; j < k; ++j) {
    const size_t o = (static_cast<size_t>(b) * k + j) * t + ti;
    const int si = idx[o];
    if (si < 0 || si >= s) continue;
    const float v = w ? __fmul_rn(w[o], gv) : gv;
    atomicAdd(dx + (static_cast<size_t>(b) * s + si) * f + ch, v);
  }
}

// idx (b, k, t) i32, w (b, k, t) f32 or null (ones), g (b, t, f) -> dx
// (b, s, f), zeroed here first.
extern "C" int knn_scatter_launch(const int* idx, const float* w, const float* g, float* dx,
                                  int b, int k, int t, int s, int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dx, 0, sizeof(float) * b * static_cast<size_t>(s) * f, st);
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(b) * t * f;
  if (total == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  knn_scatter_kernel<<<blocks, kThreads, 0, st>>>(idx, w, g, dx, s, t, f, k, total);
  return cudaGetLastError();
}

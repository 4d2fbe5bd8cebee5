// Farthest point sampling, one block per row (a cloud or a cloud part).
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_fps_kernel (pallas_call in
// fps_pallas_batched). It computes what the JAX exact path _fps_lax
// (stratanet2_tpu/ops/fps.py:107-131) computes, index for index: the TPU
// kernel's packed distance/index keys, which truncate distances, are not
// carried over.
//
// Bound on the H100: latency. The S-1 picks of a row are sequential, each a
// pass over the row's N points and a block-wide argmax; at the serve
// geometry (N=5000 per part, S=1250) the whole launch does ~0.1 GFLOP and
// moves a few MB, far from both rooflines. What costs is the per-step
// chain: the point pass, the warp shuffles and two barriers.
//
// Design: the row's xyz and running min-d2 live in shared memory for the
// whole loop (16 B per point, ~80 KB at N=5000, opted in above 48 KB), so
// device memory is read once. Each thread owns the points tid, tid+T, ...
// and keeps its local argmax in registers while updating them (strict >, so
// the lowest index wins within a thread); warp shuffles and one pass over
// the per-warp winners in shared memory finish the argmax, ties to the
// lowest index as jnp.argmax. d2 = fma(dz, dz, fma(dy, dy, dx*dx)) with
// _rn intrinsics, rounded as _fps_lax rounds it on XLA, so the picks are
// the reference's.
#include <math.h>
#include <limits.h>

#include "common.cuh"

constexpr int kThreads = 512;

__device__ __forceinline__ void argmax_step(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int n, int s) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* mind = pz + n;
  __shared__ float warp_v[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  __shared__ int picked;

  const int row = blockIdx.x;
  const float* x = xyz + static_cast<size_t>(row) * n * 3;
  int* o = out + static_cast<size_t>(row) * s;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    px[i] = x[3 * i];
    py[i] = x[3 * i + 1];
    pz[i] = x[3 * i + 2];
    mind[i] = INFINITY;
  }
  int last = start[row];
  if (threadIdx.x == 0) o[0] = last;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int step = 1; step < s; ++step) {
    const float lx = px[last], ly = py[last], lz = pz[last];
    float best_v = -1.0f;  // every running min-d2 is >= 0
    int best_i = INT_MAX;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float d2 = sq3_rn(__fsub_rn(px[i], lx), __fsub_rn(py[i], ly),
                              __fsub_rn(pz[i], lz));
      const float m = fminf(mind[i], d2);
      mind[i] = m;
      if (m > best_v) {
        best_v = m;
        best_i = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      argmax_step(best_v, best_i, __shfl_down_sync(0xffffffffu, best_v, off),
                  __shfl_down_sync(0xffffffffu, best_i, off));
    }
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < n_warps ? warp_v[lane] : -1.0f;
      best_i = lane < n_warps ? warp_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        argmax_step(best_v, best_i, __shfl_down_sync(0xffffffffu, best_v, off),
                    __shfl_down_sync(0xffffffffu, best_i, off));
      }
      if (lane == 0) {
        picked = best_i;
        o[step] = best_i;
      }
    }
    __syncthreads();
    last = picked;
  }
}

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32.
extern "C" int fps_launch(const float* xyz, const int* start, int* out, int rows,
                          int n, int s, void* stream) {
  const size_t smem = static_cast<size_t>(n) * 4 * sizeof(float);
  cudaError_t err = allow_smem(fps_kernel, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, start, out, n, s);
  return cudaGetLastError();
}

// A design variant of csrc/fps.cu's long rows, timed against its cluster
// path by scripts/kernel_variants.py (`fps`): one block of 1024 threads a
// row, as fps_kernel, with the row's first 16,384 points staged in shared
// memory (16 a thread, their running minima in registers) and every point
// past them read from device memory (the row stays in L2), their running
// minima in registers up to 32,768 points (TAIL = 16 a thread) and past
// that in a device-memory scratch md (rows, N), as fps_cluster_kernel<8, 0>
// keeps them. The same picks as fps_kernel and _fps_lax, index for index:
// a thread takes its shared points, then its streamed ones, in increasing
// index, with the strict >, and the block argmax is fps_kernel's.
//
// Built from this file alone: it includes csrc/fps.cu (nvcc -I csrc), so
// its library also holds fps_cluster_launch, and the harness times both
// entries in one process.
#include "fps.cu"

template <int TAIL>
__global__ void __launch_bounds__(kThreads, 1)
fps_stream_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                  int* __restrict__ out, float* __restrict__ md, int n, int s) {
  constexpr int kHead = kMaxPts * kThreads;  // points staged in shared memory
  extern __shared__ float sxyz[];            // (kHead, 3), zero past n
  __shared__ unsigned win_bits[2][kWarps];
  __shared__ unsigned win_idx[2][kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x = xyz + static_cast<size_t>(row) * n * 3;
  float* m = md + static_cast<size_t>(row) * n;
  int* o = out + static_cast<size_t>(row) * s;
  const int head = min(n, kHead);
  for (int j = tid; j < 3 * kHead; j += kThreads) sxyz[j] = j < 3 * head ? x[j] : 0.0f;

  float mind[kMaxPts];
  float tmind[TAIL > 0 ? TAIL : 1];
#pragma unroll
  for (int k = 0; k < kMaxPts; ++k) mind[k] = tid + k * kThreads < n ? INFINITY : -1.0f;
  if constexpr (TAIL > 0) {
#pragma unroll
    for (int k = 0; k < TAIL; ++k) tmind[k] = kHead + tid + k * kThreads < n ? INFINITY : -1.0f;
  } else {
    for (int i = kHead + tid; i < n; i += kThreads) m[i] = INFINITY;
  }
  __syncthreads();
  int last = start[row];
  if (tid == 0) o[0] = last;

  for (int step = 1; step < s; ++step) {
    const float* lp = last < kHead ? sxyz + 3 * last : x + 3 * static_cast<size_t>(last);
    const float lx = lp[0], ly = lp[1], lz = lp[2];
    float best = -1.0f;
    int best_i = 0;
#pragma unroll
    for (int k = 0; k < kMaxPts; ++k) {
      const int i = tid + k * kThreads;
      const float d2 = sq3_rn(__fsub_rn(sxyz[3 * i], lx), __fsub_rn(sxyz[3 * i + 1], ly),
                              __fsub_rn(sxyz[3 * i + 2], lz));
      mind[k] = fminf(mind[k], d2);
      if (mind[k] > best) {
        best = mind[k];
        best_i = i;
      }
    }
    if constexpr (TAIL > 0) {
#pragma unroll
      for (int k = 0; k < TAIL; ++k) {
        const int i = kHead + tid + k * kThreads;
        const bool in = i < n;
        const float* p = x + 3 * static_cast<size_t>(in ? i : 0);
        const float d2 = sq3_rn(__fsub_rn(p[0], lx), __fsub_rn(p[1], ly), __fsub_rn(p[2], lz));
        tmind[k] = fminf(tmind[k], d2);  // -1 (no point) stays below every d2
        if (tmind[k] > best) {
          best = tmind[k];
          best_i = i;
        }
      }
    } else {
#pragma unroll 4
      for (int i = kHead + tid; i < n; i += kThreads) {
        const float* p = x + 3 * static_cast<size_t>(i);
        const float d2 = sq3_rn(__fsub_rn(p[0], lx), __fsub_rn(p[1], ly), __fsub_rn(p[2], lz));
        const float mi = fminf(m[i], d2);
        m[i] = mi;
        if (mi > best) {
          best = mi;
          best_i = i;
        }
      }
    }
    const bool has = best >= 0.0f;
    const unsigned bits = has ? __float_as_uint(best) : 0u;
    const unsigned idx = has ? static_cast<unsigned>(best_i) : UINT_MAX;
    const unsigned wbits = __reduce_max_sync(0xffffffffu, bits);
    const unsigned widx = __reduce_min_sync(0xffffffffu, bits == wbits ? idx : UINT_MAX);
    const int par = step & 1;
    if (lane == 0) {
      win_bits[par][warp] = wbits;
      win_idx[par][warp] = widx;
    }
    __syncthreads();
    const unsigned sbits = win_bits[par][lane];
    const unsigned sidx = win_idx[par][lane];
    const unsigned gbits = __reduce_max_sync(0xffffffffu, sbits);
    last = static_cast<int>(__reduce_min_sync(0xffffffffu, sbits == gbits ? sidx : UINT_MAX));
    if (tid == 0) o[step] = last;
  }
}

template <int TAIL>
cudaError_t launch_stream(const float* xyz, const int* start, int* out, float* md, int rows,
                          int n, int s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * kMaxPts * kThreads;
  cudaError_t err = allow_smem(fps_stream_kernel<TAIL>, smem);
  if (err != cudaSuccess) return err;
  fps_stream_kernel<TAIL><<<rows, kThreads, smem, stream>>>(xyz, start, out, md, n, s);
  return cudaGetLastError();
}

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32, one block
// a row, n > 16384; md (rows, n) f32 scratch, read only past 32768 points.
extern "C" int fps_stream_launch(const float* xyz, const int* start, int* out, float* md,
                                 int rows, int n, int s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 2 * kMaxPts * kThreads) return launch_stream<kMaxPts>(xyz, start, out, md, rows, n, s, st);
  return launch_stream<0>(xyz, start, out, md, rows, n, s, st);
}

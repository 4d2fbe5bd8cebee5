// Farthest point sampling, one block of 1024 threads per row (a cloud or a
// cloud part).
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_fps_kernel (pallas_call in
// fps_pallas_batched). It computes what the JAX exact path _fps_lax
// (stratanet2_tpu/ops/fps.py:107-131) computes, index for index: d2 =
// fma(dz, dz, fma(dy, dy, dx*dx)) with _rn intrinsics on __fsub_rn
// differences, the running min by fminf, the pick the first maximum (lowest
// index). The TPU kernel's packed distance/index keys, which truncate
// distances, are not carried over.
//
// Bound on the H100: latency. The S-1 picks of a row are sequential; the
// whole launch does ~0.1 GFLOP and moves a few MB (chip_smoke.py's bound, ~0.04
// ms at the serve geometry, is out of reach for a dependent chain). A pick
// costs the length of its chain: the point update, the block-wide argmax and
// the barriers in it.
//
// Design: the chain is cut to one barrier and four warp reductions a pick.
// - Each thread owns the points tid + k*1024, k < PTS (a compile-time count:
//   5 at SA1's parts of N=5000, 3 at SA2's N=2500), fully unrolled. Up to
//   kRegPts points a thread, x, y, z and the running min all live in
//   registers; above it (N > 8192) x, y, z are read from shared memory and
//   only the running min stays in registers.
// - The row's xyz is staged once in shared memory, (n, 3) as in device
//   memory and zero-padded to PTS*1024 points, and read there only for the
//   winner's coordinates (and, above kRegPts, for the point pass: a stride
//   of 3 words is free of bank conflicts).
// - Argmax by redux.sync: every running min is +0 or more and finite, so
//   its float bits order as uint32. A warp takes __reduce_max_sync of the
//   bits, then __reduce_min_sync of the index over the lanes that hold the
//   max (two instructions, not five levels of shuffles). Within a thread the
//   strict > over ascending indices keeps the lowest index; a thread with no
//   point offers bits 0 with index UINT_MAX, which never wins.
// - One __syncthreads a pick: lane 0 of each warp writes (bits, index) to
//   slot `warp` of the buffer of parity step & 1; after the barrier every
//   warp reads the 32 slots and reduces them with the same two
//   instructions, so every thread knows the winner without a second
//   barrier. The parity makes one barrier enough: a warp writes the buffer
//   of step & 1 again at step + 2, after the barrier of step + 1, which no
//   warp passes before every warp has read the buffer of step.
// - One SM issues the whole point update (~10 instructions a point), and at
//   SA1 that is half of a pick. Spreading a row over a thread block cluster
//   (its winners through distributed shared memory, one barrier.cluster
//   arrive.release / wait.acquire a pick) was 2.3x slower on the H100 even
//   with one block a cluster: that barrier costs far more than
//   __syncthreads (PERF.md, Findings).
#include <limits.h>
#include <math.h>

#include "common.cuh"

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRegPts = 8;   // points a thread up to which x, y, z stay in registers
constexpr int kMaxPts = 16;  // points a thread at most: N <= 16384 (the wrapper checks)

template <int PTS, bool XYZ_IN_REGS>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int n, int s) {
  extern __shared__ float sxyz[];  // (PTS * kThreads, 3), zero past n
  __shared__ unsigned win_bits[2][kWarps];
  __shared__ unsigned win_idx[2][kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x = xyz + static_cast<size_t>(row) * n * 3;
  int* o = out + static_cast<size_t>(row) * s;
  for (int j = tid; j < 3 * PTS * kThreads; j += kThreads) sxyz[j] = j < 3 * n ? x[j] : 0.0f;
  __syncthreads();

  float px[PTS], py[PTS], pz[PTS], mind[PTS];
#pragma unroll
  for (int k = 0; k < PTS; ++k) {
    const int i = tid + k * kThreads;
    if (XYZ_IN_REGS) {
      px[k] = sxyz[3 * i];
      py[k] = sxyz[3 * i + 1];
      pz[k] = sxyz[3 * i + 2];
    }
    mind[k] = i < n ? INFINITY : -1.0f;  // -1: no point here, never picked
  }
  int last = start[row];
  if (tid == 0) o[0] = last;

  for (int step = 1; step < s; ++step) {
    const float lx = sxyz[3 * last], ly = sxyz[3 * last + 1], lz = sxyz[3 * last + 2];
    float best = -1.0f;
    int best_k = 0;
#pragma unroll
    for (int k = 0; k < PTS; ++k) {
      const int i = tid + k * kThreads;
      const float xk = XYZ_IN_REGS ? px[k] : sxyz[3 * i];
      const float yk = XYZ_IN_REGS ? py[k] : sxyz[3 * i + 1];
      const float zk = XYZ_IN_REGS ? pz[k] : sxyz[3 * i + 2];
      const float d2 = sq3_rn(__fsub_rn(xk, lx), __fsub_rn(yk, ly), __fsub_rn(zk, lz));
      mind[k] = fminf(mind[k], d2);
      if (mind[k] > best) {
        best = mind[k];
        best_k = k;
      }
    }
    const bool has = best >= 0.0f;
    const unsigned bits = has ? __float_as_uint(best) : 0u;
    const unsigned idx = has ? static_cast<unsigned>(tid + best_k * kThreads) : UINT_MAX;
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

template <int PTS>
cudaError_t launch_pts(const float* xyz, const int* start, int* out, int rows, int n, int s,
                       cudaStream_t stream) {
  constexpr bool kRegs = PTS <= kRegPts;
  const size_t smem = sizeof(float) * 3 * PTS * kThreads;
  cudaError_t err = allow_smem(fps_kernel<PTS, kRegs>, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PTS, kRegs><<<rows, kThreads, smem, stream>>>(xyz, start, out, n, s);
  return cudaGetLastError();
}

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32; 1 <= n <= 16384.
extern "C" int fps_launch(const float* xyz, const int* start, int* out, int rows, int n, int s,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((n + kThreads - 1) / kThreads) {
    case 1: return launch_pts<1>(xyz, start, out, rows, n, s, st);
    case 2: return launch_pts<2>(xyz, start, out, rows, n, s, st);
    case 3: return launch_pts<3>(xyz, start, out, rows, n, s, st);
    case 4: return launch_pts<4>(xyz, start, out, rows, n, s, st);
    case 5: return launch_pts<5>(xyz, start, out, rows, n, s, st);
    case 6: return launch_pts<6>(xyz, start, out, rows, n, s, st);
    case 7: return launch_pts<7>(xyz, start, out, rows, n, s, st);
    case 8: return launch_pts<8>(xyz, start, out, rows, n, s, st);
    case 9: return launch_pts<9>(xyz, start, out, rows, n, s, st);
    case 10: return launch_pts<10>(xyz, start, out, rows, n, s, st);
    case 11: return launch_pts<11>(xyz, start, out, rows, n, s, st);
    case 12: return launch_pts<12>(xyz, start, out, rows, n, s, st);
    case 13: return launch_pts<13>(xyz, start, out, rows, n, s, st);
    case 14: return launch_pts<14>(xyz, start, out, rows, n, s, st);
    case 15: return launch_pts<15>(xyz, start, out, rows, n, s, st);
    case kMaxPts: return launch_pts<kMaxPts>(xyz, start, out, rows, n, s, st);
    default: return cudaErrorInvalidValue;
  }
}

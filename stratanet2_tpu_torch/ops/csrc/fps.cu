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
//   __syncthreads (PERF.md, Findings). So rows of up to 16,384 points (every
//   row of the PROD steps) take fps_kernel, one block a row, and only longer
//   rows take fps_cluster_kernel below.
#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// Long rows (N > 16384): a thread-block cluster of cs blocks a row.
//
// The same picks as fps_kernel (and _fps_lax), index for index. Block r of
// a row's cluster owns the contiguous slice [r len, (r + 1) len) of its
// points; the wrapper takes cs the least power of two (at most 8, the
// portable cluster size) with cs * 16384 >= N, so len <= 16384 and the
// slice is staged in the block's shared memory with its running minimum in
// registers, as in fps_kernel (PTS points a thread). A row too long for 8
// such slices (N > 131072) runs with PTS = 0: x, y, z are read from device
// memory (the row stays in L2) and the running minimum lives in the
// wrapper's scratch `md` (rows, N), each thread reading and writing only its
// own points.
//
// A pick: the point update and the warp argmax as in fps_kernel; lane 0 of
// each warp writes its warp's (bits, index) and the winner's x, y, z to its
// block's record slot of the step's parity; one cluster barrier
// (barrier.cluster arrive.release / wait.acquire); then lane l of every warp
// reads slot l of each of the CS blocks through distributed shared memory,
// keeps the larger bits (the lower index on equal bits), and the warp
// reduces its lanes with __reduce_max_sync / __reduce_min_sync, so every
// thread of the cluster holds the winner and its coordinates without a
// second barrier. Slices are contiguous and indices global, so the lowest
// index among equal maxima is the row's first maximum. The parity makes one
// barrier a pick enough: a warp rewrites its slot of parity p at step + 2,
// after the barrier of step + 1, which no thread passes before every thread
// of the cluster has read the slots of step.
//
// Bound on the H100: latency, as fps_kernel, plus the cluster barrier in
// every pick's chain (an earlier design with one barrier.cluster a pick was
// 2.3x slower than fps_kernel at N = 10000, PERF.md); chip_smoke.py's
// dense phase gives its time a pick. One block a row with the points past
// its shared memory read from L2 instead (scripts/variants/fps_one_block.cu,
// timed by scripts/kernel_variants.py fps on an H100 at 700 W) took 3.66
// against the cluster's 2.82 us a pick at 40 rows of 32,768 points and
// 28.5 against 15.4 at one row of 200,000, so rows past 16,384 points take
// the cluster. The cluster size is a template argument (__cluster_dims__,
// an instance for each of CS = 2, 4, 8 and PTS), so the loop over the CS
// blocks' records unrolls and a plain <<<>>> launch takes it.
template <int CS, int PTS>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                   int* __restrict__ out, float* __restrict__ md, int n, int s, int len) {
  extern __shared__ float sxyz[];  // PTS > 0: the block's slice (PTS * kThreads, 3), zero past it
  __shared__ unsigned rec_bits[2][kWarps];
  __shared__ unsigned rec_idx[2][kWarps];
  __shared__ float4 rec_pos[2][kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x / CS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = min(n, rank * len), hi = min(n, lo + len);
  const float* x = xyz + row * n * 3;
  float* m = PTS > 0 ? nullptr : md + row * n;  // the row's running minima (PTS == 0)
  int* o = out + row * s;

  float mind[PTS > 0 ? PTS : 1];
  if constexpr (PTS > 0) {
    const float* xs = x + static_cast<size_t>(lo) * 3;
    const int real = 3 * (hi - lo);
    for (int j = tid; j < 3 * PTS * kThreads; j += kThreads) sxyz[j] = j < real ? xs[j] : 0.0f;
#pragma unroll
    for (int k = 0; k < PTS; ++k) mind[k] = lo + tid + k * kThreads < hi ? INFINITY : -1.0f;
  } else {
    for (int i = lo + tid; i < hi; i += kThreads) m[i] = INFINITY;
  }
  cluster.sync();  // slices staged, and every block of the cluster is running

  int last = start[row];
  float lx = x[3 * static_cast<size_t>(last)], ly = x[3 * static_cast<size_t>(last) + 1],
        lz = x[3 * static_cast<size_t>(last) + 2];
  if (rank == 0 && tid == 0) o[0] = last;

  for (int step = 1; step < s; ++step) {
    float best = -1.0f;
    int best_i = 0;
    if constexpr (PTS > 0) {
#pragma unroll
      for (int k = 0; k < PTS; ++k) {
        const int i = tid + k * kThreads;
        const float d2 = sq3_rn(__fsub_rn(sxyz[3 * i], lx), __fsub_rn(sxyz[3 * i + 1], ly),
                                __fsub_rn(sxyz[3 * i + 2], lz));
        mind[k] = fminf(mind[k], d2);
        if (mind[k] > best) {
          best = mind[k];
          best_i = lo + i;
        }
      }
    } else {
      for (int i = lo + tid; i < hi; i += kThreads) {
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
      float4 pos = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (widx != UINT_MAX) {
        const float* p = PTS > 0 ? sxyz + 3 * static_cast<size_t>(widx - lo)
                                 : x + 3 * static_cast<size_t>(widx);
        pos = make_float4(p[0], p[1], p[2], 0.0f);
      }
      rec_bits[par][warp] = wbits;
      rec_idx[par][warp] = widx;
      rec_pos[par][warp] = pos;
    }
    cluster.sync();
    unsigned cbits = 0u, cidx = UINT_MAX;
    float4 cpos = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const unsigned qb = cluster.map_shared_rank(&rec_bits[par][0], q)[lane];
      const unsigned qi = cluster.map_shared_rank(&rec_idx[par][0], q)[lane];
      const float4 qp = cluster.map_shared_rank(&rec_pos[par][0], q)[lane];
      if (qb > cbits || (qb == cbits && qi < cidx)) {
        cbits = qb;
        cidx = qi;
        cpos = qp;
      }
    }
    const unsigned gbits = __reduce_max_sync(0xffffffffu, cbits);
    const unsigned gidx = __reduce_min_sync(0xffffffffu, cbits == gbits ? cidx : UINT_MAX);
    const int src = __ffs(__ballot_sync(0xffffffffu, cidx == gidx)) - 1;
    last = static_cast<int>(gidx);
    lx = __shfl_sync(0xffffffffu, cpos.x, src);
    ly = __shfl_sync(0xffffffffu, cpos.y, src);
    lz = __shfl_sync(0xffffffffu, cpos.z, src);
    if (rank == 0 && tid == 0) o[step] = last;
  }
  cluster.sync();  // no block leaves while a peer may still read its records
}

template <int CS, int PTS>
cudaError_t launch_cluster(const float* xyz, const int* start, int* out, float* md, int rows,
                           int n, int s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * PTS * kThreads;
  cudaError_t err = allow_smem(fps_cluster_kernel<CS, PTS>, smem);
  if (err != cudaSuccess) return err;
  fps_cluster_kernel<CS, PTS><<<static_cast<unsigned>(rows) * CS, kThreads, smem, stream>>>(
      xyz, start, out, md, n, s, (n + CS - 1) / CS);
  return cudaGetLastError();
}

// The slice's points a thread: len = ceil(n / CS) is in (8192, 16384] for
// the wrapper's CS (9 to 16 points a thread); a shorter slice runs padded.
template <int CS>
cudaError_t launch_cs(const float* xyz, const int* start, int* out, int rows, int n, int s,
                      cudaStream_t st) {
  const int len = (n + CS - 1) / CS;
  switch (max(9, (len + kThreads - 1) / kThreads)) {
    case 9: return launch_cluster<CS, 9>(xyz, start, out, nullptr, rows, n, s, st);
    case 10: return launch_cluster<CS, 10>(xyz, start, out, nullptr, rows, n, s, st);
    case 11: return launch_cluster<CS, 11>(xyz, start, out, nullptr, rows, n, s, st);
    case 12: return launch_cluster<CS, 12>(xyz, start, out, nullptr, rows, n, s, st);
    case 13: return launch_cluster<CS, 13>(xyz, start, out, nullptr, rows, n, s, st);
    case 14: return launch_cluster<CS, 14>(xyz, start, out, nullptr, rows, n, s, st);
    case 15: return launch_cluster<CS, 15>(xyz, start, out, nullptr, rows, n, s, st);
    case kMaxPts: return launch_cluster<CS, kMaxPts>(xyz, start, out, nullptr, rows, n, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32, a cluster of
// cs (2, 4 or 8, the portable most) blocks a row. md: null when
// n <= cs * 16384 (the slices in shared memory), else (rows, n) f32 scratch
// for the running minima (cs 8).
extern "C" int fps_cluster_launch(const float* xyz, const int* start, int* out, float* md,
                                  int rows, int n, int s, int cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (md != nullptr)
    return cs == 8 ? launch_cluster<8, 0>(xyz, start, out, md, rows, n, s, st)
                   : cudaErrorInvalidValue;
  switch (cs) {
    case 2: return launch_cs<2>(xyz, start, out, rows, n, s, st);
    case 4: return launch_cs<4>(xyz, start, out, rows, n, s, st);
    case 8: return launch_cs<8>(xyz, start, out, rows, n, s, st);
    default: return cudaErrorInvalidValue;
  }
}

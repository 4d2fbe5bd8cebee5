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
// points, len = ceil(N / cs). While len <= 16384 (N <= 8 x 16384) the slice
// is staged in the block's shared memory with its running minimum in
// registers (PTS = ceil(len / 1024) points a thread); past that the cluster
// has 8 blocks and PTS = 0: x, y, z are read from device memory (the row
// stays in L2) and the running minimum lives in the wrapper's scratch `md`
// (rows, N), each thread reading and writing only its own points.
//
// Bound on the H100: latency, as fps_kernel, plus the exchange between the
// cluster's blocks in every pick's chain. PR 16's design put a cluster
// barrier (barrier.cluster arrive.release / wait.acquire over all cs x 1024
// threads) in every pick, after which every lane of every warp read cs x 3
// records through distributed shared memory: 2.82 us a pick at 40 rows of
// 32,768 points against fps_kernel's 1.41 at 16,384 points a block
// (scripts/variants/fps_cluster_barrier.cu keeps it, and
// scripts/kernel_variants.py fps times the two; PERF.md). This design takes
// the barrier and the remote loads off the chain:
// - A pick reduces within the block as fps_kernel does: the warp argmax by
//   redux.sync, lane 0 of each warp writes (bits, index) to slot `warp` of
//   the buffer of parity step & 1, one __syncthreads, then warp 0 reduces
//   the 32 slots to the block's winner.
// - Lane q < cs of warp 0 pushes the block's record (bits, global index, x,
//   y, z: 20 bytes) into slot [parity][rank] of block q's shared memory with
//   st.async, whose bytes complete the transaction count of block q's
//   mbarrier of that parity (lane 0 first arrives on its own block's
//   mbarrier, expecting cs records). Every thread then waits on its own
//   block's mbarrier for the step's phase and reads the cs records from its
//   own shared memory: a warp's lane q takes record q, and the warp reduces
//   them with __reduce_max_sync / __reduce_min_sync, so every thread holds
//   the winner and its coordinates. Slices are contiguous and indices
//   global: the lowest index among equal maxima is the row's first maximum.
// - No cluster barrier in the loop: one cluster.sync() before it (the
//   mbarriers initialised and every block running) and one after it (no
//   block leaves while a peer may still write into its shared memory). The
//   parity double buffer is enough. A block's records of parity p are
//   rewritten at step s + 2; a peer sends its record of step s + 2 only
//   after its mbarrier of step s + 1 completed, so after every block sent
//   its record of step s + 1; a block sends that record after its
//   __syncthreads of step s + 1, so after all its warps have read the
//   records of step s. By the same chain the bytes of step s + 2 never reach
//   an mbarrier before its phase of step s has completed. The warp slots
//   take fps_kernel's argument: a warp writes slot p again at step s + 2,
//   after the __syncthreads of step s + 1, which no warp passes before every
//   warp has read the slots of step s.
// The cluster size is a launch attribute (cudaLaunchKernelEx), any cs in
// [2, 8]; the wrapper (cuda_kernels.fps_path) takes it from the rows and N
// and from how many clusters of cs blocks the card holds at once
// (fps_cluster_resident, cudaOccupancyMaxActiveClusters; one block an SM):
// first the fewest waves of clusters, then the fewest points a thread, then
// the fewest blocks. Rows past what the card holds at once run in waves: a
// cluster starts when an earlier one has finished and freed its SMs. On an
// H100 (700 W; scripts/kernel_variants.py fps, PERF.md) the card holds 66,
// 39, 30, 22, 17, 15 and 15 clusters of 2 to 8 such blocks. Against PR 16's
// design: 1.84 against 2.83 us a pick at 40 rows of 32,768 points (2
// blocks a row), 2.74 against 12.0 at 40 x 40,000 (5 blocks, two waves;
// PR 16's 4) and 5.46 against 16.9 at 1 x 200,000 (8 blocks, PTS = 0).
constexpr int kClusterMax = 8;                       // the portable cluster size
constexpr unsigned kRecBytes = 5 * sizeof(unsigned);  // a block's record: bits, index, x, y, z

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of the same shared variable in block `rank`.
__device__ __forceinline__ unsigned peer_u32(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Remote stores whose bytes complete the transaction count of `bar`, an
// mbarrier of the block that owns `addr`.
__device__ __forceinline__ void push_v4(unsigned addr, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void push_b32(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Until the phase of parity `phase` of `bar` has completed; acquire at
// cluster scope, so the peers' records it counted are visible.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned phase) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n}" ::"r"(bar),
      "r"(phase)
      : "memory");
}

template <int PTS>
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                   int* __restrict__ out, float* __restrict__ md, int n, int s, int len) {
  extern __shared__ float sxyz[];  // PTS > 0: the block's slice (PTS * kThreads, 3), zero past it
  __shared__ unsigned win_bits[2][kWarps];
  __shared__ unsigned win_idx[2][kWarps];
  __shared__ uint4 rec[2][kClusterMax];      // block q's (bits, index, x, y), by parity
  __shared__ unsigned rec_z[2][kClusterMax];  // ... and its z
  __shared__ __align__(8) unsigned long long bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cs = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const size_t row = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = min(n, static_cast<int>(rank) * len), hi = min(n, lo + len);
  const float* x = xyz + row * n * 3;
  float* m = PTS > 0 ? nullptr : md + row * n;  // the row's running minima (PTS == 0)
  int* o = out + row * s;

  if (tid == 0) {
    bar_init(smem_u32(&bar[0]), 1);
    bar_init(smem_u32(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
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
  cluster.sync();  // slices staged, mbarriers initialised, every block of the cluster running

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
      win_bits[par][warp] = wbits;
      win_idx[par][warp] = widx;
    }
    __syncthreads();
    const unsigned my_bar = smem_u32(&bar[par]);
    if (warp == 0) {  // the block's winner, pushed to every block of the cluster
      const unsigned sbits = win_bits[par][lane];
      const unsigned sidx = win_idx[par][lane];
      const unsigned bbits = __reduce_max_sync(0xffffffffu, sbits);
      const unsigned bidx = __reduce_min_sync(0xffffffffu, sbits == bbits ? sidx : UINT_MAX);
      if (lane < static_cast<int>(cs)) {
        float px = 0.0f, py = 0.0f, pz = 0.0f;
        if (bidx != UINT_MAX) {
          const float* p = PTS > 0 ? sxyz + 3 * static_cast<size_t>(bidx - lo)
                                   : x + 3 * static_cast<size_t>(bidx);
          px = p[0];
          py = p[1];
          pz = p[2];
        }
        if (lane == 0) bar_arrive_expect(my_bar, cs * kRecBytes);
        const unsigned peer_bar = peer_u32(my_bar, lane);
        push_v4(peer_u32(smem_u32(&rec[par][rank]), lane),
                make_uint4(bbits, bidx, __float_as_uint(px), __float_as_uint(py)), peer_bar);
        push_b32(peer_u32(smem_u32(&rec_z[par][rank]), lane), __float_as_uint(pz), peer_bar);
      }
    }
    bar_wait(my_bar, ((step - 1) >> 1) & 1);  // the phases of bar[par]: steps par, par + 2, ...
    uint4 r = make_uint4(0u, UINT_MAX, 0u, 0u);
    unsigned rz = 0u;
    if (lane < static_cast<int>(cs)) {
      r = rec[par][lane];
      rz = rec_z[par][lane];
    }
    const unsigned gbits = __reduce_max_sync(0xffffffffu, r.x);
    const unsigned gidx = __reduce_min_sync(0xffffffffu, r.x == gbits ? r.y : UINT_MAX);
    const int src = __ffs(__ballot_sync(0xffffffffu, r.y == gidx)) - 1;
    last = static_cast<int>(gidx);
    lx = __uint_as_float(__shfl_sync(0xffffffffu, r.z, src));
    ly = __uint_as_float(__shfl_sync(0xffffffffu, r.w, src));
    lz = __uint_as_float(__shfl_sync(0xffffffffu, rz, src));
    if (rank == 0 && tid == 0) o[step] = last;
  }
  cluster.sync();  // no block leaves while a peer may still write into its records
}

// The launch of fps_cluster_kernel<PTS> on rows x cs blocks in clusters of
// cs, or, with `resident`, how many such clusters the card holds at once.
template <int PTS>
cudaError_t launch_cluster(const float* xyz, const int* start, int* out, float* md, int rows,
                           int n, int s, int cs, cudaStream_t stream, int* resident) {
  const size_t smem = sizeof(float) * 3 * PTS * kThreads;
  cudaError_t err = allow_smem(fps_cluster_kernel<PTS>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (resident != nullptr)
    return cudaOccupancyMaxActiveClusters(resident, fps_cluster_kernel<PTS>, &cfg);
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<PTS>, xyz, start, out, md, n, s,
                           (n + cs - 1) / cs);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The instance of `pts` points a thread (0: the running minima in md).
static cudaError_t cluster_pts(const float* xyz, const int* start, int* out, float* md,
                               int rows, int n, int s, int cs, int pts, cudaStream_t st,
                               int* resident) {
  if (cs < 2 || cs > kClusterMax) return cudaErrorInvalidValue;
  switch (pts) {
    case 0: return launch_cluster<0>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 1: return launch_cluster<1>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 2: return launch_cluster<2>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 3: return launch_cluster<3>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 4: return launch_cluster<4>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 5: return launch_cluster<5>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 6: return launch_cluster<6>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 7: return launch_cluster<7>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 8: return launch_cluster<8>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 9: return launch_cluster<9>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 10: return launch_cluster<10>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 11: return launch_cluster<11>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 12: return launch_cluster<12>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 13: return launch_cluster<13>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 14: return launch_cluster<14>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case 15: return launch_cluster<15>(xyz, start, out, md, rows, n, s, cs, st, resident);
    case kMaxPts: return launch_cluster<kMaxPts>(xyz, start, out, md, rows, n, s, cs, st, resident);
    default: return cudaErrorInvalidValue;
  }
}

// Points a thread of a slice of ceil(n / cs) points in shared memory.
static int slice_pts(int n, int cs) { return ((n + cs - 1) / cs + kThreads - 1) / kThreads; }

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32, a cluster of
// cs blocks (2 to 8) a row. md: null when ceil(n / cs) <= 16384 (the slices
// in shared memory), else (rows, n) f32 scratch for the running minima.
extern "C" int fps_cluster_launch(const float* xyz, const int* start, int* out, float* md,
                                  int rows, int n, int s, int cs, void* stream) {
  return cluster_pts(xyz, start, out, md, rows, n, s, cs, md != nullptr ? 0 : slice_pts(n, cs),
                     static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of cs blocks the current card holds at once
// (cudaOccupancyMaxActiveClusters) for the instance that rows of n points
// take (with the running-minima scratch if `global`), or -(the CUDA error).
extern "C" int fps_cluster_resident(int n, int cs, int global) {
  int clusters = 0;
  const cudaError_t err = cluster_pts(nullptr, nullptr, nullptr, nullptr, 1, n, 2, cs,
                                      global ? 0 : slice_pts(n, cs), nullptr, &clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

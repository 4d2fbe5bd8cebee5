// fps_kernel and the cluster kernel (fps_cluster_kernel<PTS>, PTS > 0) as
// csrc/fps.cu had them before its exact pruning, kept as a
// variant and timed against it by scripts/kernel_variants.py (`fps`): every
// point of the row (or of the block's slice) updated every pick, each thread
// owning the points tid + k 1024 in index order, the argmax by redux.sync on
// (bits, index), one __syncthreads a pick with parity-buffered warp slots;
// the cluster's blocks exchange their winners by st.async into their peers'
// mbarrier-counted slots. The same picks as fps_kernel and _fps_lax, index
// for index. Rows past 8 x 16,384 points take the package's global path,
// which is unpruned.
//
// Built from this file alone: it includes csrc/fps.cu (nvcc -I csrc), so its
// library also holds fps_launch and fps_cluster_launch, and the harness
// times both designs in one process.
#include "fps.cu"

template <int PTS, bool XYZ_IN_REGS>
__global__ void __launch_bounds__(kThreads, 1)
fps_unpruned_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
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
__global__ void __launch_bounds__(kThreads, 1)
fps_unpruned_cluster_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
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

// Points a thread up to which the unpruned fps_kernel kept x, y, z in
// registers (the package's kRegPts is the pruned kernel's).
constexpr int kUnprunedRegPts = 8;

template <int PTS>
cudaError_t launch_unpruned(const float* xyz, const int* start, int* out, int rows, int n, int s,
                            cudaStream_t stream) {
  constexpr bool kRegs = PTS <= kUnprunedRegPts;
  const size_t smem = sizeof(float) * 3 * PTS * kThreads;
  cudaError_t err = allow_smem(fps_unpruned_kernel<PTS, kRegs>, smem);
  if (err != cudaSuccess) return err;
  fps_unpruned_kernel<PTS, kRegs><<<rows, kThreads, smem, stream>>>(xyz, start, out, n, s);
  return cudaGetLastError();
}

template <int PTS>
cudaError_t launch_unpruned_cluster(const float* xyz, const int* start, int* out, int rows, int n,
                                    int s, int cs, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * PTS * kThreads;
  cudaError_t err = allow_smem(fps_unpruned_cluster_kernel<PTS>, smem);
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
  err = cudaLaunchKernelEx(&cfg, fps_unpruned_cluster_kernel<PTS>, xyz, start, out,
                           static_cast<float*>(nullptr), n, s, (n + cs - 1) / cs);
  return err != cudaSuccess ? err : cudaGetLastError();
}

#define FPS_UNPRUNED_CASES(CALL) \
  CALL(1) CALL(2) CALL(3) CALL(4) CALL(5) CALL(6) CALL(7) CALL(8) CALL(9) CALL(10) CALL(11) \
  CALL(12) CALL(13) CALL(14) CALL(15) CALL(16)

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32; 1 <= n <= 16384.
extern "C" int fps_unpruned_launch(const float* xyz, const int* start, int* out, int rows, int n,
                                   int s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FPS_UNPRUNED_BLOCK(P) \
  case P: return launch_unpruned<P>(xyz, start, out, rows, n, s, st);
  switch ((n + kThreads - 1) / kThreads) {
    FPS_UNPRUNED_CASES(FPS_UNPRUNED_BLOCK)
    default: return cudaErrorInvalidValue;
  }
}

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32, a cluster of
// cs blocks (2 to 8) a row, each slice of ceil(n / cs) <= 16384 points in
// shared memory.
extern "C" int fps_unpruned_cluster_launch(const float* xyz, const int* start, int* out, int rows,
                                           int n, int s, int cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cs < 2 || cs > kClusterMax) return cudaErrorInvalidValue;
#define FPS_UNPRUNED_CLUSTER(P) \
  case P: return launch_unpruned_cluster<P>(xyz, start, out, rows, n, s, cs, st);
  switch (slice_pts(n, cs)) {
    FPS_UNPRUNED_CASES(FPS_UNPRUNED_CLUSTER)
    default: return cudaErrorInvalidValue;
  }
}

// A flat cluster exchange for csrc/fps.cu's fps_cluster_kernel, kept as a
// variant and timed against the package by scripts/kernel_variants.py
// (`fps`). No block barrier in the pick's loop: every warp pushes its own
// record to every block of its cluster and every warp reduces all of them.
// It measured slower than the package's exchange (a __syncthreads, warp 0's
// reduce and push of the block's winner) on an H100 (PERF.md §6):
// each warp's cs pushes and every warp's reduce of cs x warps records cost
// more than the barrier they replace. The same picks as the package, index
// for index: the warps' points, boxes and skip test are the package's
// (WarpPoints, one box a warp).
//
// The exchange:
// - Each warp, right after its skip test (and its update if it needed
//   one), pushes its record (bits, row index, and its best point's x, y, z
//   from its own sorted slice: 20 bytes) into slot [parity][rank][warp] of
//   every block of its cluster, lane q to block q, with st.async, whose
//   bytes complete the transaction count of block q's mbarrier of that
//   parity. The block's thread 0 arrives on its own mbarrier each pick,
//   expecting cs x warps records. A warp that skipped pushes its cached
//   record at once, so only the warps that update stand on the chain.
// - Every warp waits on its own block's mbarrier for the step's phase and
//   reduces the cs x warps records of its own shared memory (a few a lane,
//   by bits then index, then __reduce_max_sync / __reduce_min_sync), so
//   every thread holds the winner and its coordinates. Slices are
//   contiguous and indices of the row: the lowest index among equal maxima
//   is the row's first maximum.
// - The parity: a warp pushes into the slots and mbarrier of parity p again
//   at step s + 2, only after waiting on the phase of step s + 1 (of the
//   other parity) on its own block, which completes only when every warp of
//   every block of the cluster has pushed its record of step s + 1; each
//   warp pushed that record after it had read the records of step s. So no
//   slot of parity p is overwritten before every warp of its block has read
//   it, and no byte of step s + 2 reaches an mbarrier whose phase of step s
//   has not completed. Thread 0's arrival of step s + 2 comes after its own
//   wait on step s + 1 as well.
// - One cluster.sync() before the loop (the mbarriers initialised and every
//   block running) and one after it (no block leaves while a peer may still
//   write into its shared memory).
// Shared memory grows by the slots, cs x warps records of 20 bytes a parity
// (10 KB at 8 blocks of 1024 threads): a slice of 16,384 points still fits.
//
// Its entry `fps_flat_cluster_launch` takes fps_cluster_launch's arguments
// without the running-minima scratch (slices in shared memory only). Built
// from this file alone: it includes csrc/fps.cu (nvcc -I csrc), so its
// library also holds the package's entries.
#include "fps.cu"

// Every warp's record of every block of the cluster, by parity, and the
// block's two mbarriers.
template <int W>
struct FlatSlots {
  uint4 rec[2][kClusterMax][W];       // warp w of block q's (bits, index, x, y)
  unsigned rec_z[2][kClusterMax][W];  // ... and its z
  unsigned long long bar[2];
};

template <int PTS, int THREADS>
__global__ void __launch_bounds__(THREADS, kThreads / THREADS)
fps_flat_cluster_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                        int* __restrict__ out, unsigned long long* __restrict__ stats, int n,
                        int s, int len) {
  constexpr int W = THREADS / 32;
  extern __shared__ float sxyz[];  // the block's slice (PTS * THREADS, 3) in sorted order
  __shared__ float red[4][W];
  __shared__ __align__(16) FlatSlots<W> cl;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cs = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const size_t row = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = min(n, static_cast<int>(rank) * len), hi = min(n, lo + len);
  const float* x = xyz + row * n * 3;
  int* o = out + row * s;

  if (tid == 0) {
    bar_init(smem_u32(&cl.bar[0]), 1);
    bar_init(smem_u32(&cl.bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  unsigned okey[PTS];
  sort_slice<PTS, THREADS>(x + static_cast<size_t>(lo) * 3, hi - lo, sxyz,
                           reinterpret_cast<unsigned*>(sxyz) + PTS * THREADS, red, okey);
  WarpPoints<PTS, (PTS <= kRegPts)> wp;
  wp.init(sxyz, okey);
  cluster.sync();  // slices sorted, mbarriers initialised, every block of the cluster running

  // lane q < cs: the warp's slot and the mbarrier of block q, parity 0
  // (parity 1 at a fixed offset of each)
  const unsigned q = lane < static_cast<int>(cs) ? lane : 0u;
  const unsigned put = peer_u32(smem_u32(&cl.rec[0][rank][warp]), q);
  const unsigned put_z = peer_u32(smem_u32(&cl.rec_z[0][rank][warp]), q);
  const unsigned put_bar = peer_u32(smem_u32(&cl.bar[0]), q);
  const unsigned my_bar = smem_u32(&cl.bar[0]);
  constexpr unsigned kRecPar = sizeof(uint4) * kClusterMax * W;  // bytes from parity 0 to 1
  constexpr unsigned kZPar = sizeof(unsigned) * kClusterMax * W;
  constexpr unsigned kBarPar = sizeof(unsigned long long);
  const unsigned expect = cs * W * kRecBytes;
  const int nrec = static_cast<int>(cs) * W;  // records a pick, rec[par] read flat

  int last = start[row];
  float lx = x[3 * static_cast<size_t>(last)], ly = x[3 * static_cast<size_t>(last) + 1],
        lz = x[3 * static_cast<size_t>(last) + 2];
  if (rank == 0 && tid == 0) o[0] = last;
  unsigned skipped = 0;
  for (int step = 1; step < s; ++step) {
    skipped += !wp.pick(sxyz, lx, ly, lz);
    const unsigned par = step & 1;
    // the warp's record, pushed to every block of the cluster
    const bool has = wp.ckey != kNone;
    const unsigned pos = has ? wp.ckey & 0xffffu : 0u;
    const unsigned idx = has ? static_cast<unsigned>(lo) + (wp.ckey >> 16) : kNone;
    const float fx = sxyz[3 * pos], fy = sxyz[3 * pos + 1], fz = sxyz[3 * pos + 2];
    if (tid == 0) bar_arrive_expect(my_bar + par * kBarPar, expect);
    if (lane < static_cast<int>(cs)) {
      push_v4(put + par * kRecPar,
              make_uint4(wp.cbits, idx, __float_as_uint(fx), __float_as_uint(fy)),
              put_bar + par * kBarPar);
      push_b32(put_z + par * kZPar, __float_as_uint(fz), put_bar + par * kBarPar);
    }
    // bar[par]'s phases: steps par, par + 2, ...
    bar_wait(my_bar + par * kBarPar, ((step - 1) >> 1) & 1);
    const uint4* rec = &cl.rec[par][0][0];
    const unsigned* rec_z = &cl.rec_z[par][0][0];
    unsigned bb = 0u, bi = kNone, bx = 0u, by = 0u, bz = 0u;
#pragma unroll
    for (int t = 0; t < kClusterMax * W / 32; ++t) {
      const int f = lane + 32 * t;
      if (f < nrec) {
        const uint4 r = rec[f];
        if (r.x > bb || (r.x == bb && r.y < bi)) {
          bb = r.x;
          bi = r.y;
          bx = r.z;
          by = r.w;
          bz = rec_z[f];
        }
      }
    }
    const unsigned gbits = __reduce_max_sync(kFull, bb);
    const unsigned gidx = __reduce_min_sync(kFull, bb == gbits ? bi : kNone);
    const int src = __ffs(__ballot_sync(kFull, bi == gidx)) - 1;
    lx = __uint_as_float(__shfl_sync(kFull, bx, src));
    ly = __uint_as_float(__shfl_sync(kFull, by, src));
    lz = __uint_as_float(__shfl_sync(kFull, bz, src));
    last = static_cast<int>(gidx);
    if (rank == 0 && tid == 0) o[step] = last;
  }
  count_skips(stats, wp.real, skipped, s);
  cluster.sync();  // no block leaves while a peer may still write into its records
}

// The instance of `pts` points a thread (PTS .. 1 tried in turn) and
// THREADS a block, on rows x cs blocks in clusters of cs.
template <int THREADS, int PTS = kMaxPts>
cudaError_t launch_flat(int pts, const float* xyz, const int* start, int* out,
                        unsigned long long* stats, int rows, int n, int s, int cs,
                        cudaStream_t stream) {
  if constexpr (PTS == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (pts != PTS)
      return launch_flat<THREADS, PTS - 1>(pts, xyz, start, out, stats, rows, n, s, cs, stream);
    const auto kernel = fps_flat_cluster_kernel<PTS, THREADS>;
    const size_t smem = slice_smem<PTS, THREADS>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess && THREADS < kThreads)  // two blocks an SM: all of its shared memory
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned>(cs);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * cs);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, xyz, start, out, stats, n, s, (n + cs - 1) / cs);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

// fps_cluster_launch's arguments without md: cs blocks (1 to 8) of
// `threads` (1024 or 512) a row, each slice of ceil(n / cs) points at most
// 16 a thread; stats null or 2 u64 (added to).
extern "C" int fps_flat_cluster_launch(const float* xyz, const int* start, int* out,
                                       unsigned long long* stats, int rows, int n, int s, int cs,
                                       int threads, void* stream) {
  if (cs < 1 || cs > kClusterMax) return cudaErrorInvalidValue;
  const int pts = slice_pts(n, cs, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads == kThreads) return launch_flat<kThreads>(pts, xyz, start, out, stats, rows, n, s,
                                                        cs, st);
  if (threads == kPairThreads) return launch_flat<kPairThreads>(pts, xyz, start, out, stats, rows,
                                                                n, s, cs, st);
  return cudaErrorInvalidValue;
}

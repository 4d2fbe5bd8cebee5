// PR 16's design of csrc/fps.cu's long rows, kept as a variant and timed
// against the package's design by scripts/kernel_variants.py (`fps`): a
// cluster of CS = 2, 4 or 8 blocks a row (the least power of two with
// CS x 16384 >= N; a compile-time cluster size, __cluster_dims__), each
// warp's winner with its x, y, z in a parity-buffered record slot of its
// block, one cluster barrier (barrier.cluster arrive.release / wait.acquire
// over all CS x 1024 threads) a pick, then every lane of every warp reading
// the CS blocks' slots through distributed shared memory (map_shared_rank).
// The same picks as fps_kernel and _fps_lax, index for index; past 131,072
// points (PTS = 0) x, y, z come from device memory and the running minima
// from the scratch md (rows, N).
//
// Built from this file alone: it includes csrc/fps.cu (nvcc -I csrc), so
// its library also holds fps_cluster_launch, and the harness times both
// entries in one process.
#include "fps.cu"

template <int CS, int PTS>
__global__ void __cluster_dims__(CS, 1, 1) __launch_bounds__(kThreads, 1)
fps_barrier_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
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
cudaError_t launch_barrier(const float* xyz, const int* start, int* out, float* md, int rows,
                           int n, int s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * PTS * kThreads;
  cudaError_t err = allow_smem(fps_barrier_kernel<CS, PTS>, smem);
  if (err != cudaSuccess) return err;
  fps_barrier_kernel<CS, PTS><<<static_cast<unsigned>(rows) * CS, kThreads, smem, stream>>>(
      xyz, start, out, md, n, s, (n + CS - 1) / CS);
  return cudaGetLastError();
}

// The slice's points a thread: len = ceil(n / CS) is in (8192, 16384] for
// the wrapper's CS (9 to 16 points a thread); a shorter slice runs padded.
template <int CS>
cudaError_t launch_barrier_cs(const float* xyz, const int* start, int* out, int rows, int n, int s,
                      cudaStream_t st) {
  const int len = (n + CS - 1) / CS;
  switch (max(9, (len + kThreads - 1) / kThreads)) {
    case 9: return launch_barrier<CS, 9>(xyz, start, out, nullptr, rows, n, s, st);
    case 10: return launch_barrier<CS, 10>(xyz, start, out, nullptr, rows, n, s, st);
    case 11: return launch_barrier<CS, 11>(xyz, start, out, nullptr, rows, n, s, st);
    case 12: return launch_barrier<CS, 12>(xyz, start, out, nullptr, rows, n, s, st);
    case 13: return launch_barrier<CS, 13>(xyz, start, out, nullptr, rows, n, s, st);
    case 14: return launch_barrier<CS, 14>(xyz, start, out, nullptr, rows, n, s, st);
    case 15: return launch_barrier<CS, 15>(xyz, start, out, nullptr, rows, n, s, st);
    case kMaxPts: return launch_barrier<CS, kMaxPts>(xyz, start, out, nullptr, rows, n, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32, a cluster of
// cs (2, 4 or 8, the portable most) blocks a row. md: null when
// n <= cs * 16384 (the slices in shared memory), else (rows, n) f32 scratch
// for the running minima (cs 8).
extern "C" int fps_barrier_launch(const float* xyz, const int* start, int* out, float* md,
                                  int rows, int n, int s, int cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (md != nullptr)
    return cs == 8 ? launch_barrier<8, 0>(xyz, start, out, md, rows, n, s, st)
                   : cudaErrorInvalidValue;
  switch (cs) {
    case 2: return launch_barrier_cs<2>(xyz, start, out, rows, n, s, st);
    case 4: return launch_barrier_cs<4>(xyz, start, out, rows, n, s, st);
    case 8: return launch_barrier_cs<8>(xyz, start, out, rows, n, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// Sub-boxes in the warp's update of csrc/fps.cu's fps_kernel, kept as a
// variant and timed against the package by scripts/kernel_variants.py
// (`fps`; a SOURCE `@kSubPts=2` or `@kSubBranch=1` sets a constant). It
// measured slower than the package's one box a warp at every size tried on
// an H100 (PERF.md §6): every warp runs the skip test each pick,
// and with 32 warps on an SM each instruction on that path costs ~8 issue
// cycles a pick; the ballot and the sub-boxes' reductions cost more than the
// updates they save. The same picks as the package, index for index.
//
// The design. A warp's points k in [g SUB, (g + 1) SUB) of every lane, 32
// SUB consecutive sorted points, form its sub-box g (SUB = kSubPts, or PTS
// when PTS is smaller: one box a warp). Lane g holds sub-box g's box [lo,
// hi] in x, y and z, reduced once, and M, the max bits of its members'
// running minima. A pick tests every sub-box at once, a lane each, with
// csrc/fps.cu's gap D = sq3_rn(g) and its rule D >= M; a __ballot_sync
// gathers the sub-boxes that fail it, and only their points are updated:
// each point's update predicated on its sub-box's bit and every sub-box's
// M reduced afresh (kSubBranch 0), or a branch a sub-box, each updated and
// reduced in its own (kSubBranch 1, the first design). The warp's record is
// the max of its sub-boxes' M and the least key among the points that hold
// it.
//
// Exact: csrc/fps.cu's step 3 proves, for any box [lo, hi] and winner l,
// that every member's rounded d2 >= D (rounding to nearest is monotone and
// symmetric, each fma of nonnegative terms rounds an exact value at least
// the box's). It holds box by box: with D >= M >= every member's running
// minimum m of a sub-box, fminf(m, d2) = m for each of them, so none of its
// minima moves and its M stands; a warp's record from its sub-boxes' M (a
// skipped one's as it stood) is the warp's max and least key. An infinite D
// or d2 keeps the order; a sub-box with no point has an empty box (D =
// +inf) and M = 0. (tests/test_torch_port_fps_pruned.py holds D <= every
// member's d2 on random sub-boxes, and its plain mirror of this design
// checks at every pick that a skipped sub-box's minima would not have
// moved.)
//
// Its entry `fps_sub_launch` takes fps_launch's arguments with a 4-u64
// counter: the warp updates skipped and possible, then the sub-box updates
// skipped and possible, over the warps and sub-boxes that hold points.
// Built from this file alone: it includes csrc/fps.cu (nvcc -I csrc), so its
// library also holds the package's entries.
#include "fps.cu"

constexpr int kSubPts = 4;     // points a lane of a sub-box
constexpr int kSubBranch = 0;  // 1: a branch a sub-box instead of predicated updates

template <int PTS, bool REGS>
struct SubBoxPoints {
  static constexpr int SUB = PTS < kSubPts ? PTS : kSubPts;
  static constexpr int kSubs = (PTS + SUB - 1) / SUB;  // sub-boxes of the warp
  static_assert(kSubs <= 32, "a lane a sub-box");
  float px[REGS ? PTS : 1], py[REGS ? PTS : 1], pz[REGS ? PTS : 1];
  float mind[PTS];
  unsigned key[PTS];
  float bx0, bx1, by0, by1, bz0, bz1;  // sub-box `lane`'s box (empty past kSubs)
  unsigned mbits;                      // its max bits (0 past kSubs)
  unsigned cbits, ckey;                // the warp's record: max bits, least key holding them
  int base;                            // sorted position of the thread's point k = 0
  int subs;                            // sub-boxes that hold a point
  bool real;                           // the warp holds a point

  __device__ __forceinline__ void init(const float* sxyz, const unsigned (&okey)[PTS]) {
    const int lane = threadIdx.x & 31;
    base = (threadIdx.x >> 5) * 32 * PTS + lane;
    bx0 = by0 = bz0 = INFINITY;
    bx1 = by1 = bz1 = -INFINITY;
    unsigned k0 = kNone;
#pragma unroll
    for (int g = 0; g < kSubs; ++g) {
      float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY, z0 = INFINITY,
            z1 = -INFINITY;
#pragma unroll
      for (int k = g * SUB; k < (g + 1) * SUB && k < PTS; ++k) {
        const int j = base + 32 * k;
        key[k] = okey[k];
        mind[k] = okey[k] != kNone ? INFINITY : 0.0f;  // no point here: 0 and kNone never win
        const float x = sxyz[3 * j], y = sxyz[3 * j + 1], z = sxyz[3 * j + 2];
        if (REGS) {
          px[k] = x;
          py[k] = y;
          pz[k] = z;
        }
        if (okey[k] != kNone) {
          x0 = fminf(x0, x);
          x1 = fmaxf(x1, x);
          y0 = fminf(y0, y);
          y1 = fmaxf(y1, y);
          z0 = fminf(z0, z);
          z1 = fmaxf(z1, z);
          k0 = min(k0, okey[k]);
        }
      }
      warp_extent(x0, x1, y0, y1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        z0 = fminf(z0, __shfl_xor_sync(kFull, z0, o));
        z1 = fmaxf(z1, __shfl_xor_sync(kFull, z1, o));
      }
      if (lane == g) {
        bx0 = x0;
        bx1 = x1;
        by0 = y0;
        by1 = y1;
        bz0 = z0;
        bz1 = z1;
      }
    }
    // every minimum starts at +inf: the warp's first maximum is its least key
    ckey = __reduce_min_sync(kFull, k0);
    real = ckey != kNone;
    cbits = real ? __float_as_uint(INFINITY) : 0u;
    const bool holds = lane < kSubs && bx0 <= bx1;  // the lane's sub-box has a point
    mbits = holds ? __float_as_uint(INFINITY) : 0u;
    subs = __popc(__ballot_sync(kFull, holds));
  }

  __device__ __forceinline__ void update(const float* sxyz, int k, float lx, float ly, float lz) {
    const int j = base + 32 * k;
    const float xk = REGS ? px[k] : sxyz[3 * j];
    const float yk = REGS ? py[k] : sxyz[3 * j + 1];
    const float zk = REGS ? pz[k] : sxyz[3 * j + 2];
    const float d2 = sq3_rn(__fsub_rn(xk, lx), __fsub_rn(yk, ly), __fsub_rn(zk, lz));
    mind[k] = fminf(mind[k], d2);
  }

  // One pick from the winner (lx, ly, lz): the sub-boxes it updated (0: the
  // warp skipped it and its record stands).
  __device__ __forceinline__ int pick(const float* sxyz, float lx, float ly, float lz) {
    const int lane = threadIdx.x & 31;
    const float gx = fmaxf(fmaxf(__fsub_rn(bx0, lx), __fsub_rn(lx, bx1)), 0.0f);
    const float gy = fmaxf(fmaxf(__fsub_rn(by0, ly), __fsub_rn(ly, by1)), 0.0f);
    const float gz = fmaxf(fmaxf(__fsub_rn(bz0, lz), __fsub_rn(lz, bz1)), 0.0f);
    // lanes past kSubs: an empty box and mbits 0, never a bit
    const unsigned need = __ballot_sync(kFull, __float_as_uint(sq3_rn(gx, gy, gz)) < mbits);
    if (need == 0u) return 0;
    if constexpr (kSubBranch) {
#pragma unroll
      for (int g = 0; g < kSubs; ++g) {
        if (need & (1u << g)) {  // uniform in the warp
          float best = 0.0f;
#pragma unroll
          for (int k = g * SUB; k < (g + 1) * SUB && k < PTS; ++k) {
            update(sxyz, k, lx, ly, lz);
            best = fmaxf(best, mind[k]);
          }
          const unsigned r = __reduce_max_sync(kFull, __float_as_uint(best));
          mbits = lane == g ? r : mbits;
        }
      }
      cbits = __reduce_max_sync(kFull, mbits);
    } else {
      float best[kSubs];  // the lane's max of each sub-box's minima
#pragma unroll
      for (int g = 0; g < kSubs; ++g) best[g] = 0.0f;
#pragma unroll
      for (int k = 0; k < PTS; ++k) {
        if (need & (1u << (k / SUB))) update(sxyz, k, lx, ly, lz);
        best[k / SUB] = fmaxf(best[k / SUB], mind[k]);
      }
      unsigned m = 0u;  // each sub-box's M (independent reductions), their max
#pragma unroll
      for (int g = 0; g < kSubs; ++g) {
        const unsigned r = __reduce_max_sync(kFull, __float_as_uint(best[g]));
        mbits = lane == g ? r : mbits;
        m = max(m, r);
      }
      cbits = m;
    }
    unsigned bk = kNone;  // the least key holding the max
#pragma unroll
    for (int k = 0; k < PTS; ++k) bk = min(bk, __float_as_uint(mind[k]) == cbits ? key[k] : kNone);
    ckey = __reduce_min_sync(kFull, bk);
    return __popc(need);
  }
};

// fps_kernel with SubBoxPoints; stats as fps_sub_launch's.
template <int PTS, bool XYZ_IN_REGS>
__global__ void __launch_bounds__(kThreads, 1)
fps_sub_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ out, unsigned long long* __restrict__ stats, int n, int s) {
  extern __shared__ float sxyz[];  // (PTS * kThreads, 3) in sorted order, zero past n
  __shared__ __align__(16) unsigned hist[kSortCells];  // read as uint4 by the scan
  __shared__ float red[4][kWarps];
  __shared__ unsigned win_bits[2][kWarps];
  __shared__ unsigned win_key[2][kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x = xyz + static_cast<size_t>(row) * n * 3;
  int* o = out + static_cast<size_t>(row) * s;
  unsigned okey[PTS];
  sort_slice<PTS, kThreads>(x, n, sxyz, hist, red, okey);
  SubBoxPoints<PTS, XYZ_IN_REGS> wp;
  wp.init(sxyz, okey);

  int last = start[row];
  float lx = x[3 * last], ly = x[3 * last + 1], lz = x[3 * last + 2];
  if (tid == 0) o[0] = last;
  const unsigned put_bits = smem_u32(&win_bits[0][warp]), put_key = smem_u32(&win_key[0][warp]);
  const unsigned get_bits = smem_u32(&win_bits[0][lane]), get_key = smem_u32(&win_key[0][lane]);
  constexpr unsigned kParity = sizeof(unsigned) * kWarps;
  unsigned skipped = 0, updated = 0;
  for (int step = 1; step < s; ++step) {
    const int boxes = wp.pick(sxyz, lx, ly, lz);
    skipped += boxes == 0;
    updated += boxes;
    const unsigned off = (step & 1) * kParity;
    st_shared_if(lane == 0, put_bits + off, wp.cbits);
    st_shared_if(lane == 0, put_key + off, wp.ckey);
    __syncthreads();
    const unsigned sbits = ld_shared(get_bits + off);
    const unsigned skey = ld_shared(get_key + off);
    const unsigned gbits = __reduce_max_sync(kFull, sbits);
    const unsigned gkey = __reduce_min_sync(kFull, sbits == gbits ? skey : kNone);
    const unsigned pos = gkey & 0xffffu;
    last = static_cast<int>(gkey >> 16);
    lx = sxyz[3 * pos];
    ly = sxyz[3 * pos + 1];
    lz = sxyz[3 * pos + 2];
    st_global_if(tid == 0, o + step, last);
  }
  count_skips(stats, wp.real, skipped, s);
  if (stats != nullptr && wp.real && lane == 0) {
    const unsigned long long possible = static_cast<unsigned long long>(wp.subs) * (s - 1);
    atomicAdd(&stats[2], possible - updated);
    atomicAdd(&stats[3], possible);
  }
}

// The instance of `pts` points a thread, PTS .. 1 tried in turn.
template <int PTS>
cudaError_t launch_sub(int pts, const float* xyz, const int* start, int* out,
                       unsigned long long* stats, int rows, int n, int s, cudaStream_t stream) {
  if constexpr (PTS == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (pts != PTS) return launch_sub<PTS - 1>(pts, xyz, start, out, stats, rows, n, s, stream);
    constexpr bool kRegs = PTS <= kRegPts;
    const size_t smem = sizeof(float) * 3 * PTS * kThreads;
    cudaError_t err = allow_smem(fps_sub_kernel<PTS, kRegs>, smem);
    if (err != cudaSuccess) return err;
    fps_sub_kernel<PTS, kRegs><<<rows, kThreads, smem, stream>>>(xyz, start, out, stats, n, s);
    return cudaGetLastError();
  }
}

// fps_launch's arguments; stats null or 4 u64 (added to).
extern "C" int fps_sub_launch(const float* xyz, const int* start, int* out,
                              unsigned long long* stats, int rows, int n, int s, void* stream) {
  return launch_sub<kMaxPts>((n + kThreads - 1) / kThreads, xyz, start, out, stats, rows, n, s,
                             static_cast<cudaStream_t>(stream));
}

// fps_kernel and fps_cluster_kernel<PTS> as csrc/fps.cu had them before the
// cluster took a block size (512-thread blocks, two an SM), kept as a
// variant and timed against the package by
// scripts/kernel_variants.py (`fps`): one box a warp for all its 32 PTS
// points, and in the cluster a __syncthreads a pick, then warp 0 reduces the
// block's 32 warp records and pushes the block's winner to its peers. Its
// C entries keep their names (fps_launch, fps_cluster_launch with no block
// size, fps_cluster_resident(n, cs, global)); the harness loads each
// variant into a library of its own. The same picks as the package,
// index for index.
//
// The file as it was follows, unchanged.
//
// Farthest point sampling with exact pruning: one block of 1024 threads a
// row (a cloud or a cloud part), or a thread-block cluster a row past 16,384
// points.
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
// costs its chain: the winner's load, the point update of the warps that
// need one, the warp and block argmax and one barrier (a cluster adds its
// exchange, below).
//
// Design: exact bucket pruning. The unpruned kernels
// (scripts/variants/fps_unpruned.cu) update every point of the row on every
// pick, and that update is half of a PROD pick and ~3/4 of a dense one.
// Late in FPS a pick can lower only the running minima of the points
// within sqrt(max min-d2) of it: a few warps' worth of the row.
// 1. Sort once, in the kernel. Each block counting-sorts its row, or its
//    cluster slice, in shared memory by the Hilbert index of a
//    kSortSide x kSortSide grid of square xy cells over the slice's own
//    extent (a histogram, a block scan, a scatter of the slice's indices, then
//    x, y, z gathered in that order). Warp w owns the 32 PTS consecutive
//    sorted points j = w 32 PTS + k 32 + lane (k < PTS): a compact patch of
//    the plot (the data layer shuffles point order, so a warp's points would
//    otherwise span the plot). Each point carries the key (o << 16) | j, o
//    its index in the slice (both below 2^16: a slice has at most 16,384
//    points): every argmax takes the max of the float bits, then the least
//    key among the points that hold it, which is the least original index,
//    the first maximum. The order inside a cell follows the atomics; no pick
//    depends on it.
// 2. Each warp reduces the box [lo, hi] of its points in x, y and z once,
//    and keeps its last record in registers: M, the max bits of its running
//    minima, and the least key holding it.
// 3. A pick's skip test. From the winner l, the gap to the box on each axis,
//    g = max(__fsub_rn(lo, l), __fsub_rn(l, hi), 0), and D = sq3_rn(gx, gy,
//    gz), the distance's own fma order. If D >= M (bits compare: both are
//    +0 or more), the warp skips its update and offers its cached record.
//    Exact, with no rounding margin: take a member p on one axis, p in [lo,
//    hi]. If l < lo, p - l >= lo - l > 0, and rounding to nearest is
//    monotone, so __fsub_rn(p, l) >= __fsub_rn(lo, l) = g. If l > hi,
//    __fsub_rn(p, l) = -__fsub_rn(l, p) (rounding is symmetric) and l - p >=
//    l - hi > 0, so |__fsub_rn(p, l)| >= __fsub_rn(l, hi) = g. Otherwise g =
//    0. So |d| >= g >= 0 on each axis; the product d*d and each fma of
//    nonnegative terms are the rounding of an exact value at least as large
//    as the box's, and so no smaller: the member's d2 >= D. With D >= M >=
//    every member's running minimum m, fminf(m, d2) = m for every member:
//    no minimum moves, so the warp's max and its least key stand. An
//    infinite D or d2 keeps the order. (tests/test_torch_port_fps_pruned.py
//    holds D <= every member's d2 on random boxes, and the CPU mirror
//    `cuda_kernels.fps_pruned_mirror` checks at every pick that a skipped
//    warp's minima would not have moved.)
// 4. Every warp writes its slot every pick, skipping or not: the parity
//    double buffer below relies on it (a slot of parity p not rewritten
//    would hold a record from two picks back).
// The first ~32 picks reach every warp; later ones a few. An optional
// counter (stats, null in the wrappers' normal calls) takes the skipped
// warp updates and the updates a pick could have made, summed over the
// warps that hold points.
//
// The pick's chain, as the unpruned kernel's: every running min is +0 or
// more and finite, so its float bits order as uint32. A warp takes
// __reduce_max_sync of the bits, then __reduce_min_sync of the key over the
// lanes that hold the max. One __syncthreads a pick: lane 0 of each warp writes (bits, key)
// to slot `warp` of the buffer of parity step & 1; after the barrier every
// warp reads the 32 slots and reduces them with the same two instructions,
// so every thread knows the winner (its key holds its sorted position, so
// its x, y, z come from shared memory) without a second barrier. The parity
// makes one barrier enough: a warp writes the buffer of step & 1 again at
// step + 2, after the barrier of step + 1, which no warp passes before every
// warp has read the buffer of step. Up to kRegPts points a thread, x, y, z
// and the running min live in registers; above it x, y, z are read from
// shared memory (a stride of 3 words is free of bank conflicts) and only
// the running minima and keys stay in registers. With pruning only a few
// warps read them, and registers at 5 to 8 points cost more than the reads
// (64 registers under __launch_bounds__(1024, 1); PROD SA1's parts at 5
// points: 0.399 us a pick against 0.418 in registers; 8 points 0.415
// against 0.515, the register instance spilling; scripts/kernel_variants.py
// fps, an H100 at 700 W).
#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRegPts = 4;   // points a thread up to which x, y, z stay in registers
constexpr int kMaxPts = 16;  // points a thread at most: N <= 16384 (the wrapper checks)
constexpr int kSortSide = 64;                       // the sort's grid: kSortSide^2 xy cells
constexpr int kSortCells = kSortSide * kSortSide;   // scanned 4 a thread
constexpr unsigned kNone = UINT_MAX;                // the key of no point: never wins
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSortCells == 4 * kThreads, "the sort's scan takes 4 cells a thread");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A predicated store and a load of shared memory, and a predicated global
// store, in PTX: the pick's loop keeps its slot addresses in registers and
// its stores off any branch.
__device__ __forceinline__ void st_shared_if(bool p, unsigned addr, unsigned v) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t@q st.shared.u32 [%1], %2;\n}"
               ::"r"(static_cast<int>(p)), "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_shared(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_global_if(bool p, int* addr, int v) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t@q st.global.u32 [%1], %2;\n}"
               ::"r"(static_cast<int>(p)), "l"(addr), "r"(v) : "memory");
}

// The Hilbert index of cell (x, y) of the kSortSide x kSortSide grid.
__device__ __forceinline__ unsigned hilbert_cell(int x, int y) {
  unsigned d = 0;
#pragma unroll
  for (int s = kSortSide / 2; s > 0; s >>= 1) {
    const int rx = (x & s) > 0, ry = (y & s) > 0;
    d += static_cast<unsigned>(s * s * ((3 * rx) ^ ry));
    if (ry == 0) {
      if (rx == 1) {
        x = kSortSide - 1 - x;
        y = kSortSide - 1 - y;
      }
      const int t = x;
      x = y;
      y = t;
    }
  }
  return d;
}

__device__ __forceinline__ void warp_extent(float& x0, float& x1, float& y0, float& y1) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFull, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(kFull, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(kFull, y1, o));
  }
}

// Step 1: the m points xs (m, 3) of a slice staged into sxyz (PTS kThreads,
// 3) in Hilbert cell order, zero past m; okey[k] the key (o << 16) | j of
// the thread's point j = warp 32 PTS + k 32 + lane (kNone past m). hist
// (kSortCells) and red (4 x kWarps) are scratch; the first PTS kThreads
// words of sxyz hold the scattered indices before x, y, z overwrite them.
template <int PTS>
__device__ __forceinline__ void sort_slice(const float* __restrict__ xs, int m, float* sxyz,
                                           unsigned* hist, float (*red)[kWarps],
                                           unsigned (&okey)[PTS]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;
  for (int i = tid; i < m; i += kThreads) {
    const float x = xs[3 * i], y = xs[3 * i + 1];
    x0 = fminf(x0, x);
    x1 = fmaxf(x1, x);
    y0 = fminf(y0, y);
    y1 = fmaxf(y1, y);
  }
  warp_extent(x0, x1, y0, y1);
  if (lane == 0) {
    red[0][warp] = x0;
    red[1][warp] = x1;
    red[2][warp] = y0;
    red[3][warp] = y1;
  }
  for (int c = tid; c < kSortCells; c += kThreads) hist[c] = 0u;
  __syncthreads();
  x0 = red[0][lane];
  x1 = red[1][lane];
  y0 = red[2][lane];
  y1 = red[3][lane];
  warp_extent(x0, x1, y0, y1);  // every warp: the slice's extent
  const float ext = fmaxf(x1 - x0, y1 - y0);
  const float inv = ext > 0.0f ? kSortSide / ext : 0.0f;
  unsigned cell[PTS];
#pragma unroll
  for (int k = 0; k < PTS; ++k) {
    const int i = tid + k * kThreads;
    cell[k] = 0u;
    if (i < m) {
      const int cx = min(kSortSide - 1, static_cast<int>((xs[3 * i] - x0) * inv));
      const int cy = min(kSortSide - 1, static_cast<int>((xs[3 * i + 1] - y0) * inv));
      cell[k] = hilbert_cell(cx, cy);
      atomicAdd(&hist[cell[k]], 1u);
    }
  }
  __syncthreads();
  // the cells' starts: an exclusive scan, 4 cells a thread, then the warps'
  // totals (in red, whose values every warp read before the last barrier)
  const uint4 h = reinterpret_cast<const uint4*>(hist)[tid];
  const unsigned total = h.x + h.y + h.z + h.w;
  unsigned incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  unsigned* wsum = reinterpret_cast<unsigned*>(red[0]);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned winc = wsum[lane];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, winc, o);
    if (lane >= o) winc += v;
  }
  const unsigned before = __shfl_sync(kFull, winc, warp) - wsum[warp];
  const unsigned c0 = before + incl - total;
  reinterpret_cast<uint4*>(hist)[tid] =
      make_uint4(c0, c0 + h.x, c0 + h.x + h.y, c0 + h.x + h.y + h.z);
  __syncthreads();
  unsigned* perm = reinterpret_cast<unsigned*>(sxyz);
#pragma unroll
  for (int k = 0; k < PTS; ++k) {
    const int i = tid + k * kThreads;
    if (i < m) perm[atomicAdd(&hist[cell[k]], 1u)] = static_cast<unsigned>(i);
  }
  __syncthreads();
  const int base = warp * 32 * PTS + lane;
#pragma unroll
  for (int k = 0; k < PTS; ++k) {
    const int j = base + 32 * k;
    okey[k] = j < m ? (perm[j] << 16) | static_cast<unsigned>(j) : kNone;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PTS; ++k) {
    const int j = base + 32 * k;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (okey[k] != kNone) {
      const float* p = xs + 3 * static_cast<size_t>(okey[k] >> 16);
      px = p[0];
      py = p[1];
      pz = p[2];
    }
    sxyz[3 * j] = px;
    sxyz[3 * j + 1] = py;
    sxyz[3 * j + 2] = pz;
  }
  __syncthreads();
}

// Steps 2 and 3: a warp's points of the sorted slice, their running minima
// and keys, its box and its cached record.
template <int PTS, bool REGS>
struct WarpPoints {
  float px[REGS ? PTS : 1], py[REGS ? PTS : 1], pz[REGS ? PTS : 1];
  float mind[PTS];
  unsigned key[PTS];
  float bx0, bx1, by0, by1, bz0, bz1;  // the box of the warp's points
  unsigned cbits, ckey;                // its last record: max bits, least key holding them
  int base;                            // sorted position of the thread's point k = 0
  bool real;                           // the warp holds a point

  __device__ __forceinline__ void init(const float* sxyz, const unsigned (&okey)[PTS]) {
    base = (threadIdx.x >> 5) * 32 * PTS + (threadIdx.x & 31);
    bx0 = by0 = bz0 = INFINITY;
    bx1 = by1 = bz1 = -INFINITY;
    unsigned k0 = kNone;
#pragma unroll
    for (int k = 0; k < PTS; ++k) {
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
        bx0 = fminf(bx0, x);
        bx1 = fmaxf(bx1, x);
        by0 = fminf(by0, y);
        by1 = fmaxf(by1, y);
        bz0 = fminf(bz0, z);
        bz1 = fmaxf(bz1, z);
        k0 = min(k0, okey[k]);
      }
    }
    warp_extent(bx0, bx1, by0, by1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      bz0 = fminf(bz0, __shfl_xor_sync(kFull, bz0, o));
      bz1 = fmaxf(bz1, __shfl_xor_sync(kFull, bz1, o));
    }
    // every minimum starts at +inf: the warp's first maximum is its least key
    ckey = __reduce_min_sync(kFull, k0);
    real = ckey != kNone;
    cbits = real ? __float_as_uint(INFINITY) : 0u;
  }

  // One pick from the winner (lx, ly, lz); false if the warp skipped it.
  __device__ __forceinline__ bool pick(const float* sxyz, float lx, float ly, float lz) {
    const float gx = fmaxf(fmaxf(__fsub_rn(bx0, lx), __fsub_rn(lx, bx1)), 0.0f);
    const float gy = fmaxf(fmaxf(__fsub_rn(by0, ly), __fsub_rn(ly, by1)), 0.0f);
    const float gz = fmaxf(fmaxf(__fsub_rn(bz0, lz), __fsub_rn(lz, bz1)), 0.0f);
    if (__float_as_uint(sq3_rn(gx, gy, gz)) >= cbits) return false;  // uniform in the warp
    float best = 0.0f;  // every minimum is +0 or more
#pragma unroll
    for (int k = 0; k < PTS; ++k) {
      const int j = base + 32 * k;
      const float xk = REGS ? px[k] : sxyz[3 * j];
      const float yk = REGS ? py[k] : sxyz[3 * j + 1];
      const float zk = REGS ? pz[k] : sxyz[3 * j + 2];
      const float d2 = sq3_rn(__fsub_rn(xk, lx), __fsub_rn(yk, ly), __fsub_rn(zk, lz));
      mind[k] = fminf(mind[k], d2);
      best = fmaxf(best, mind[k]);
    }
    unsigned bk = kNone;  // the least key holding the max
#pragma unroll
    for (int k = 0; k < PTS; ++k) bk = min(bk, mind[k] == best ? key[k] : kNone);
    const unsigned bits = __float_as_uint(best);
    cbits = __reduce_max_sync(kFull, bits);
    ckey = __reduce_min_sync(kFull, bits == cbits ? bk : kNone);
    return true;
  }
};

// The skipped and possible warp updates of a launch, summed over the warps
// that hold points, into stats[0] and stats[1] when stats is not null.
__device__ __forceinline__ void count_skips(unsigned long long* stats, bool real,
                                            unsigned skipped, int s) {
  if (stats != nullptr && real && (threadIdx.x & 31) == 0) {
    atomicAdd(&stats[0], static_cast<unsigned long long>(skipped));
    atomicAdd(&stats[1], static_cast<unsigned long long>(s - 1));
  }
}

template <int PTS, bool XYZ_IN_REGS>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int* __restrict__ out,
           unsigned long long* __restrict__ stats, int n, int s) {
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
  sort_slice<PTS>(x, n, sxyz, hist, red, okey);
  WarpPoints<PTS, XYZ_IN_REGS> wp;
  wp.init(sxyz, okey);

  int last = start[row];
  float lx = x[3 * last], ly = x[3 * last + 1], lz = x[3 * last + 2];
  if (tid == 0) o[0] = last;
  // the warp's slots (written by lane 0) and the lane's slot of every warp
  const unsigned put_bits = smem_u32(&win_bits[0][warp]), put_key = smem_u32(&win_key[0][warp]);
  const unsigned get_bits = smem_u32(&win_bits[0][lane]), get_key = smem_u32(&win_key[0][lane]);
  constexpr unsigned kParity = sizeof(unsigned) * kWarps;  // bytes from parity 0's slots to 1's
  unsigned skipped = 0;
  for (int step = 1; step < s; ++step) {
    skipped += !wp.pick(sxyz, lx, ly, lz);
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
}

template <int PTS>
cudaError_t launch_pts(const float* xyz, const int* start, int* out, unsigned long long* stats,
                       int rows, int n, int s, cudaStream_t stream) {
  constexpr bool kRegs = PTS <= kRegPts;
  const size_t smem = sizeof(float) * 3 * PTS * kThreads;
  cudaError_t err = allow_smem(fps_kernel<PTS, kRegs>, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PTS, kRegs><<<rows, kThreads, smem, stream>>>(xyz, start, out, stats, n, s);
  return cudaGetLastError();
}

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32; 1 <= n <= 16384.
// stats: null, or 2 u64 that take the launch's skipped and possible warp
// updates (added to).
extern "C" int fps_launch(const float* xyz, const int* start, int* out,
                          unsigned long long* stats, int rows, int n, int s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((n + kThreads - 1) / kThreads) {
    case 1: return launch_pts<1>(xyz, start, out, stats, rows, n, s, st);
    case 2: return launch_pts<2>(xyz, start, out, stats, rows, n, s, st);
    case 3: return launch_pts<3>(xyz, start, out, stats, rows, n, s, st);
    case 4: return launch_pts<4>(xyz, start, out, stats, rows, n, s, st);
    case 5: return launch_pts<5>(xyz, start, out, stats, rows, n, s, st);
    case 6: return launch_pts<6>(xyz, start, out, stats, rows, n, s, st);
    case 7: return launch_pts<7>(xyz, start, out, stats, rows, n, s, st);
    case 8: return launch_pts<8>(xyz, start, out, stats, rows, n, s, st);
    case 9: return launch_pts<9>(xyz, start, out, stats, rows, n, s, st);
    case 10: return launch_pts<10>(xyz, start, out, stats, rows, n, s, st);
    case 11: return launch_pts<11>(xyz, start, out, stats, rows, n, s, st);
    case 12: return launch_pts<12>(xyz, start, out, stats, rows, n, s, st);
    case 13: return launch_pts<13>(xyz, start, out, stats, rows, n, s, st);
    case 14: return launch_pts<14>(xyz, start, out, stats, rows, n, s, st);
    case 15: return launch_pts<15>(xyz, start, out, stats, rows, n, s, st);
    case kMaxPts: return launch_pts<kMaxPts>(xyz, start, out, stats, rows, n, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Long rows (N > 16384): a thread-block cluster of cs blocks a row.
//
// The same picks as fps_kernel (and _fps_lax), index for index. Block r of
// a row's cluster owns the contiguous slice [r len, (r + 1) len) of its
// points, len = ceil(N / cs). While len <= 16384 (N <= 8 x 16384) the
// block sorts and prunes its slice as fps_kernel does its row (PTS =
// ceil(len / 1024) points a thread); its keys hold indices in the slice, and
// its record the row's index lo + o. Past that the cluster has 8 blocks and
// PTS = 0, the global path, unpruned: x, y, z are read from device
// memory (the row stays in L2) and the running minimum lives in the
// wrapper's scratch `md` (rows, N), each thread reading and writing only its
// own points, every point updated every pick.
//
// Bound on the H100: latency, as fps_kernel, plus the exchange between the
// cluster's blocks in every pick's chain (the design of a cluster barrier a
// pick and remote loads is scripts/variants/fps_cluster_barrier.cu):
// - A pick reduces within the block as fps_kernel does: the warp argmax by
//   redux.sync, lane 0 of each warp writes its record to slot `warp` of the
//   buffer of parity step & 1, one __syncthreads, then warp 0 reduces the
//   32 slots to the block's winner.
// - Lane q < cs of warp 0 pushes the block's record (bits, row index, x, y,
//   z: 20 bytes) into slot [parity][rank] of block q's shared memory with
//   st.async, whose bytes complete the transaction count of block q's
//   mbarrier of that parity (lane 0 first arrives on its own block's
//   mbarrier, expecting cs records). Every thread then waits on its own
//   block's mbarrier for the step's phase and reads the cs records from its
//   own shared memory: a warp's lane q takes record q, and the warp reduces
//   them with __reduce_max_sync / __reduce_min_sync, so every thread holds
//   the winner and its coordinates. Slices are contiguous and indices of
//   the row: the lowest index among equal maxima is the row's first maximum.
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
//   warp has read the slots of step s (and every warp writes its slot every
//   pick, skipping or not).
// The cluster size is a launch attribute (cudaLaunchKernelEx), any cs in
// [2, 8]; the wrapper (cuda_kernels.fps_path) takes it from the rows and N
// and from how many clusters of cs blocks the card holds at once
// (fps_cluster_resident, cudaOccupancyMaxActiveClusters; one block an SM):
// first the fewest waves of clusters, then the fewest points a thread, then
// the fewest blocks. Rows past what the card holds at once run in waves: a
// cluster starts when an earlier one has finished and freed its SMs.
constexpr int kClusterMax = 8;                       // the portable cluster size
constexpr unsigned kRecBytes = 5 * sizeof(unsigned);  // a block's record: bits, index, x, y, z

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

// The exchange state of a cluster's block: its records by parity and its
// two mbarriers.
struct ClusterSlots {
  uint4 rec[2][kClusterMax];      // block q's (bits, index, x, y), by parity
  unsigned rec_z[2][kClusterMax];  // ... and its z
  unsigned long long bar[2];
};

// Lanes q < cs of warp 0: the block's record (bits, row index idx, the point
// p's x, y, z) pushed into slot [par][rank] of block q.
__device__ __forceinline__ void push_record(ClusterSlots& cl, unsigned cs, unsigned rank, int par,
                                            unsigned bits, unsigned idx, const float* p) {
  const int lane = threadIdx.x & 31;
  if (lane >= static_cast<int>(cs)) return;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (idx != kNone) {
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  const unsigned my_bar = smem_u32(&cl.bar[par]);
  if (lane == 0) bar_arrive_expect(my_bar, cs * kRecBytes);
  const unsigned peer_bar = peer_u32(my_bar, lane);
  push_v4(peer_u32(smem_u32(&cl.rec[par][rank]), lane),
          make_uint4(bits, idx, __float_as_uint(px), __float_as_uint(py)), peer_bar);
  push_b32(peer_u32(smem_u32(&cl.rec_z[par][rank]), lane), __float_as_uint(pz), peer_bar);
}

// Every thread: waits for the cs records of `step` and reduces them to the
// row's winner, its index returned and its coordinates in (lx, ly, lz).
__device__ __forceinline__ int take_winner(ClusterSlots& cl, unsigned cs, int step, float& lx,
                                           float& ly, float& lz) {
  const int lane = threadIdx.x & 31;
  const int par = step & 1;
  // bar[par]'s phases: steps par, par + 2, ...
  bar_wait(smem_u32(&cl.bar[par]), ((step - 1) >> 1) & 1);
  uint4 r = make_uint4(0u, kNone, 0u, 0u);
  unsigned rz = 0u;
  if (lane < static_cast<int>(cs)) {
    r = cl.rec[par][lane];
    rz = cl.rec_z[par][lane];
  }
  const unsigned gbits = __reduce_max_sync(kFull, r.x);
  const unsigned gidx = __reduce_min_sync(kFull, r.x == gbits ? r.y : kNone);
  const int src = __ffs(__ballot_sync(kFull, r.y == gidx)) - 1;
  lx = __uint_as_float(__shfl_sync(kFull, r.z, src));
  ly = __uint_as_float(__shfl_sync(kFull, r.w, src));
  lz = __uint_as_float(__shfl_sync(kFull, rz, src));
  return static_cast<int>(gidx);
}

__device__ __forceinline__ void init_slots(ClusterSlots& cl) {
  if (threadIdx.x == 0) {
    bar_init(smem_u32(&cl.bar[0]), 1);
    bar_init(smem_u32(&cl.bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// PTS > 0: the block's slice sorted and pruned in shared memory.
template <int PTS>
__device__ __forceinline__ void cluster_rows_pruned(const float* __restrict__ xyz,
                                                    const int* __restrict__ start,
                                                    int* __restrict__ out,
                                                    unsigned long long* __restrict__ stats, int n,
                                                    int s, int len) {
  extern __shared__ float sxyz[];  // the block's slice (PTS * kThreads, 3) in sorted order
  __shared__ __align__(16) unsigned hist[kSortCells];  // read as uint4 by the scan
  __shared__ float red[4][kWarps];
  __shared__ unsigned win_bits[2][kWarps];
  __shared__ unsigned win_key[2][kWarps];
  __shared__ __align__(16) ClusterSlots cl;

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

  init_slots(cl);
  unsigned okey[PTS];
  sort_slice<PTS>(x + static_cast<size_t>(lo) * 3, hi - lo, sxyz, hist, red, okey);
  WarpPoints<PTS, (PTS <= kRegPts)> wp;
  wp.init(sxyz, okey);
  cluster.sync();  // slices sorted, mbarriers initialised, every block of the cluster running

  int last = start[row];
  float lx = x[3 * static_cast<size_t>(last)], ly = x[3 * static_cast<size_t>(last) + 1],
        lz = x[3 * static_cast<size_t>(last) + 2];
  if (rank == 0 && tid == 0) o[0] = last;
  unsigned skipped = 0;
  for (int step = 1; step < s; ++step) {
    skipped += !wp.pick(sxyz, lx, ly, lz);
    const int par = step & 1;
    if (lane == 0) {  // plain stores here: the PTX ones of fps_kernel measured slower in a cluster
      win_bits[par][warp] = wp.cbits;
      win_key[par][warp] = wp.ckey;
    }
    __syncthreads();
    if (warp == 0) {  // the block's winner, pushed to every block of the cluster
      const unsigned sbits = win_bits[par][lane];
      const unsigned skey = win_key[par][lane];
      const unsigned bbits = __reduce_max_sync(kFull, sbits);
      const unsigned bkey = __reduce_min_sync(kFull, sbits == bbits ? skey : kNone);
      push_record(cl, cs, rank, par, bbits,
                  bkey != kNone ? static_cast<unsigned>(lo) + (bkey >> 16) : kNone,
                  sxyz + 3 * (bkey & 0xffffu));
    }
    last = take_winner(cl, cs, step, lx, ly, lz);
    if (rank == 0 && tid == 0) o[step] = last;
  }
  count_skips(stats, wp.real, skipped, s);
  cluster.sync();  // no block leaves while a peer may still write into its records
}

// PTS == 0 (N > 8 x 16384): the global path, every point every pick.
__device__ __forceinline__ void cluster_rows_global(const float* __restrict__ xyz,
                                                    const int* __restrict__ start,
                                                    int* __restrict__ out, float* __restrict__ md,
                                                    int n, int s, int len) {
  __shared__ unsigned win_bits[2][kWarps];
  __shared__ unsigned win_idx[2][kWarps];
  __shared__ __align__(16) ClusterSlots cl;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cs = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const size_t row = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = min(n, static_cast<int>(rank) * len), hi = min(n, lo + len);
  const float* x = xyz + row * n * 3;
  float* m = md + row * n;  // the row's running minima
  int* o = out + row * s;

  init_slots(cl);
  for (int i = lo + tid; i < hi; i += kThreads) m[i] = INFINITY;
  cluster.sync();  // minima set, mbarriers initialised, every block of the cluster running

  int last = start[row];
  float lx = x[3 * static_cast<size_t>(last)], ly = x[3 * static_cast<size_t>(last) + 1],
        lz = x[3 * static_cast<size_t>(last) + 2];
  if (rank == 0 && tid == 0) o[0] = last;
  for (int step = 1; step < s; ++step) {
    float best = -1.0f;
    int best_i = 0;
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
    const bool has = best >= 0.0f;
    const unsigned bits = has ? __float_as_uint(best) : 0u;
    const unsigned idx = has ? static_cast<unsigned>(best_i) : kNone;
    const unsigned wbits = __reduce_max_sync(kFull, bits);
    const unsigned widx = __reduce_min_sync(kFull, bits == wbits ? idx : kNone);
    const int par = step & 1;
    if (lane == 0) {
      win_bits[par][warp] = wbits;
      win_idx[par][warp] = widx;
    }
    __syncthreads();
    if (warp == 0) {  // the block's winner, pushed to every block of the cluster
      const unsigned sbits = win_bits[par][lane];
      const unsigned sidx = win_idx[par][lane];
      const unsigned bbits = __reduce_max_sync(kFull, sbits);
      const unsigned bidx = __reduce_min_sync(kFull, sbits == bbits ? sidx : kNone);
      push_record(cl, cs, rank, par, bbits, bidx, x + 3 * static_cast<size_t>(bidx));
    }
    last = take_winner(cl, cs, step, lx, ly, lz);
    if (rank == 0 && tid == 0) o[step] = last;
  }
  cluster.sync();  // no block leaves while a peer may still write into its records
}

template <int PTS>
__global__ void __launch_bounds__(kThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                   int* __restrict__ out, float* __restrict__ md,
                   unsigned long long* __restrict__ stats, int n, int s, int len) {
  if constexpr (PTS > 0)
    cluster_rows_pruned<PTS>(xyz, start, out, stats, n, s, len);
  else
    cluster_rows_global(xyz, start, out, md, n, s, len);
}

// The launch of fps_cluster_kernel<PTS> on rows x cs blocks in clusters of
// cs, or, with `resident`, how many such clusters the card holds at once.
template <int PTS>
cudaError_t launch_cluster(const float* xyz, const int* start, int* out, float* md,
                           unsigned long long* stats, int rows, int n, int s, int cs,
                           cudaStream_t stream, int* resident) {
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
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<PTS>, xyz, start, out, md, stats, n, s,
                           (n + cs - 1) / cs);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The instance of `pts` points a thread (0: the running minima in md).
static cudaError_t cluster_pts(const float* xyz, const int* start, int* out, float* md,
                               unsigned long long* stats, int rows, int n, int s, int cs, int pts,
                               cudaStream_t st, int* resident) {
  if (cs < 2 || cs > kClusterMax) return cudaErrorInvalidValue;
#define FPS_CLUSTER_CASE(P) \
  case P: return launch_cluster<P>(xyz, start, out, md, stats, rows, n, s, cs, st, resident);
  switch (pts) {
    FPS_CLUSTER_CASE(0)
    FPS_CLUSTER_CASE(1)
    FPS_CLUSTER_CASE(2)
    FPS_CLUSTER_CASE(3)
    FPS_CLUSTER_CASE(4)
    FPS_CLUSTER_CASE(5)
    FPS_CLUSTER_CASE(6)
    FPS_CLUSTER_CASE(7)
    FPS_CLUSTER_CASE(8)
    FPS_CLUSTER_CASE(9)
    FPS_CLUSTER_CASE(10)
    FPS_CLUSTER_CASE(11)
    FPS_CLUSTER_CASE(12)
    FPS_CLUSTER_CASE(13)
    FPS_CLUSTER_CASE(14)
    FPS_CLUSTER_CASE(15)
    FPS_CLUSTER_CASE(kMaxPts)
    default: return cudaErrorInvalidValue;
  }
#undef FPS_CLUSTER_CASE
}

// Points a thread of a slice of ceil(n / cs) points in shared memory.
static int slice_pts(int n, int cs) { return ((n + cs - 1) / cs + kThreads - 1) / kThreads; }

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32, a cluster of
// cs blocks (2 to 8) a row. md: null when ceil(n / cs) <= 16384 (the slices
// in shared memory), else (rows, n) f32 scratch for the running minima.
// stats: null, or 2 u64 that take the skipped and possible warp updates (the
// slices in shared memory only).
extern "C" int fps_cluster_launch(const float* xyz, const int* start, int* out, float* md,
                                  unsigned long long* stats, int rows, int n, int s, int cs,
                                  void* stream) {
  return cluster_pts(xyz, start, out, md, stats, rows, n, s, cs,
                     md != nullptr ? 0 : slice_pts(n, cs), static_cast<cudaStream_t>(stream),
                     nullptr);
}

// How many clusters of cs blocks the current card holds at once
// (cudaOccupancyMaxActiveClusters) for the instance that rows of n points
// take (with the running-minima scratch if `global`), or -(the CUDA error).
extern "C" int fps_cluster_resident(int n, int cs, int global) {
  int clusters = 0;
  const cudaError_t err = cluster_pts(nullptr, nullptr, nullptr, nullptr, nullptr, 1, n, 2, cs,
                                      global ? 0 : slice_pts(n, cs), nullptr, &clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

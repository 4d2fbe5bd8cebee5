// FPS on rows past 16,384 points with one block of 1024 threads a row and no
// cluster: the row sorted once into an L2-resident device scratch, its
// running minima in shared memory. Timed against the package's cluster by
// scripts/kernel_variants.py (`fps`); the same picks as the package and
// _fps_lax, index for index. It measured slower on an H100 (PERF.md §6):
// 1.673 us a pick at 40 rows of 32,768 points against the cluster's
// ~1.08, 1.789 at 40 x 40,000: each updated sub-box waits on L2.
//
// The cluster's pick pays for the exchange between its blocks (~0.45 us of
// ~1.1 at dense SA1 on an H100). Here a pick's chain is one block's: the
// skip tests, the update of the sub-boxes that need one, a __syncthreads and
// the argmax of the warps' records. The price is that the points of an
// updated sub-box come from L2 instead of shared memory.
// - Sort: the row's points counting-sorted by the Hilbert index of the
//   kSortSide^2 xy cells over the row's extent (csrc/fps.cu's step 1, its
//   cells computed again in the scatter instead of kept in registers), then
//   written in that order to `sorted` (rows, 1024 PTS) as float4 (x, y, z,
//   the point's index as bits; kNone past n). PTS = ceil(n / 1024), rounded
//   up to an instance, up to kRowMaxPts: the minima take 4 B a point of
//   shared memory beside the sort's 16 KB histogram.
// - Warp w owns the sorted points j = w 32 PTS + k 32 + lane; sub-box g its
//   points k in [4 g, 4 g + 4) of every lane (kRowSubPts). Lane g
//   holds sub-box g's box and record: M (max bits of its minima), the least
//   key holding it and that point's x, y, z. The skip test is csrc/fps.cu's
//   step 3, a lane a sub-box; the sub-boxes that fail it are updated one
//   after the other (their float4 points from L2, their minima from and back
//   to shared memory) and their records reduced afresh; the warp's record is
//   the argmax of its lanes' sub-box records, cached while no sub-box
//   updates. Exact for the same reason as the package's: D <= every
//   member's d2, box by box.
// - One __syncthreads a pick: lane 0 of each warp writes (bits, key, x, y,
//   z) to slot `warp` of the buffer of parity step & 1; every warp then
//   reduces the 32 slots, so every thread holds the winner and its
//   coordinates (fps_kernel's parity argument).
//
// Built from this file alone: it includes csrc/fps.cu (nvcc -I csrc), so its
// library also holds the package's entries.
#include "fps.cu"

constexpr int kRowMaxPts = 48;  // points a thread at most: 49,152 minima in 192 KB
constexpr int kRowSubPts = 4;   // points a lane of a sub-box

struct RowSlot {
  unsigned bits, key;
  float x, y, z;
};

template <int PTS>
__global__ void __launch_bounds__(kThreads, 1)
fps_row_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int* __restrict__ out, float4* __restrict__ sorted,
               unsigned long long* __restrict__ stats, int n, int s) {
  constexpr int kSubs = PTS / kRowSubPts;  // sub-boxes a warp (PTS a multiple of kRowSubPts)
  static_assert(PTS % kRowSubPts == 0 && kSubs <= 32, "a lane a sub-box");
  extern __shared__ float mind[];  // (PTS * kThreads) running minima; the sort's indices first
  __shared__ __align__(16) unsigned hist[kSortCells];
  __shared__ float red[4][kWarps];
  __shared__ RowSlot slot[2][kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x = xyz + static_cast<size_t>(row) * n * 3;
  float4* srt = sorted + static_cast<size_t>(row) * PTS * kThreads;
  int* o = out + static_cast<size_t>(row) * s;

  // the sort: extent, histogram, scan, scatter, then the float4 rows
  float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;
  for (int i = tid; i < n; i += kThreads) {
    x0 = fminf(x0, x[3 * i]);
    x1 = fmaxf(x1, x[3 * i]);
    y0 = fminf(y0, x[3 * i + 1]);
    y1 = fmaxf(y1, x[3 * i + 1]);
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
  warp_extent(x0, x1, y0, y1);
  const float ext = fmaxf(x1 - x0, y1 - y0);
  const float inv = ext > 0.0f ? kSortSide / ext : 0.0f;
  auto cell_of = [&](int i) {
    const int cx = min(kSortSide - 1, static_cast<int>((x[3 * i] - x0) * inv));
    const int cy = min(kSortSide - 1, static_cast<int>((x[3 * i + 1] - y0) * inv));
    return hilbert_cell(cx, cy);
  };
  for (int i = tid; i < n; i += kThreads) atomicAdd(&hist[cell_of(i)], 1u);
  __syncthreads();
  const uint4 h = reinterpret_cast<const uint4*>(hist)[tid];
  const unsigned total = h.x + h.y + h.z + h.w;
  unsigned incl = total;
#pragma unroll
  for (int v = 1; v < 32; v <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, incl, v);
    if (lane >= v) incl += u;
  }
  unsigned* wsum = reinterpret_cast<unsigned*>(red[0]);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned winc = wsum[lane];
#pragma unroll
  for (int v = 1; v < 32; v <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, winc, v);
    if (lane >= v) winc += u;
  }
  const unsigned c0 = __shfl_sync(kFull, winc, warp) - wsum[warp] + incl - total;
  reinterpret_cast<uint4*>(hist)[tid] =
      make_uint4(c0, c0 + h.x, c0 + h.x + h.y, c0 + h.x + h.y + h.z);
  __syncthreads();
  unsigned* perm = reinterpret_cast<unsigned*>(mind);
  for (int i = tid; i < n; i += kThreads) perm[atomicAdd(&hist[cell_of(i)], 1u)] = i;
  __syncthreads();
  for (int j = tid; j < PTS * kThreads; j += kThreads) {
    float4 p = make_float4(0.0f, 0.0f, 0.0f, __uint_as_float(kNone));
    if (j < n) {
      const unsigned i = perm[j];
      p = make_float4(x[3 * i], x[3 * i + 1], x[3 * i + 2], __uint_as_float(i));
    }
    srt[j] = p;
  }
  __syncthreads();  // the block's global writes are visible to the block past it
  for (int j = tid; j < PTS * kThreads; j += kThreads) mind[j] = j < n ? INFINITY : 0.0f;

  // the warp's sub-boxes: lane g holds sub-box g's box and record
  const int base = warp * 32 * PTS + lane;
  float bx0 = INFINITY, bx1 = -INFINITY, by0 = INFINITY, by1 = -INFINITY, bz0 = INFINITY,
        bz1 = -INFINITY;
  unsigned mb = 0u, mk = kNone;  // sub-box `lane`'s max bits and least key holding them
  float mx = 0.0f, my = 0.0f, mz = 0.0f;
  for (int g = 0; g < kSubs; ++g) {
    float a0 = INFINITY, a1 = -INFINITY, q0 = INFINITY, q1 = -INFINITY, e0 = INFINITY,
          e1 = -INFINITY;
    unsigned k0 = kNone;
    float kx = 0.0f, ky = 0.0f, kz = 0.0f;
#pragma unroll
    for (int t = 0; t < kRowSubPts; ++t) {
      const int j = base + 32 * (g * kRowSubPts + t);
      const float4 p = srt[j];
      const unsigned i = __float_as_uint(p.w);
      if (i != kNone) {
        a0 = fminf(a0, p.x);
        a1 = fmaxf(a1, p.x);
        q0 = fminf(q0, p.y);
        q1 = fmaxf(q1, p.y);
        e0 = fminf(e0, p.z);
        e1 = fmaxf(e1, p.z);
        const unsigned key = (i << 16) | static_cast<unsigned>(j);
        if (key < k0) {
          k0 = key;
          kx = p.x;
          ky = p.y;
          kz = p.z;
        }
      }
    }
    warp_extent(a0, a1, q0, q1);
#pragma unroll
    for (int v = 16; v > 0; v >>= 1) {
      e0 = fminf(e0, __shfl_xor_sync(kFull, e0, v));
      e1 = fmaxf(e1, __shfl_xor_sync(kFull, e1, v));
    }
    const unsigned kmin = __reduce_min_sync(kFull, k0);
    const int src = __ffs(__ballot_sync(kFull, k0 == kmin)) - 1;
    kx = __shfl_sync(kFull, kx, src);
    ky = __shfl_sync(kFull, ky, src);
    kz = __shfl_sync(kFull, kz, src);
    if (lane == g) {
      bx0 = a0, bx1 = a1, by0 = q0, by1 = q1, bz0 = e0, bz1 = e1;
      mb = kmin != kNone ? __float_as_uint(INFINITY) : 0u;
      mk = kmin;
      mx = kx, my = ky, mz = kz;
    }
  }
  // the warp's record: every minimum is +inf, its least key
  unsigned wbits, wkey;
  float wx, wy, wz;
  auto warp_record = [&]() {
    wbits = __reduce_max_sync(kFull, mb);
    wkey = __reduce_min_sync(kFull, mb == wbits ? mk : kNone);
    const int src = __ffs(__ballot_sync(kFull, mk == wkey)) - 1;
    wx = __shfl_sync(kFull, mx, src);
    wy = __shfl_sync(kFull, my, src);
    wz = __shfl_sync(kFull, mz, src);
  };
  warp_record();
  const bool real = wkey != kNone;
  const int subs = __popc(__ballot_sync(kFull, lane < kSubs && bx0 <= bx1));
  __syncthreads();

  int last = start[row];
  float lx = x[3 * last], ly = x[3 * last + 1], lz = x[3 * last + 2];
  if (tid == 0) o[0] = last;
  unsigned skipped = 0, updated = 0;
  for (int step = 1; step < s; ++step) {
    const float gx = fmaxf(fmaxf(__fsub_rn(bx0, lx), __fsub_rn(lx, bx1)), 0.0f);
    const float gy = fmaxf(fmaxf(__fsub_rn(by0, ly), __fsub_rn(ly, by1)), 0.0f);
    const float gz = fmaxf(fmaxf(__fsub_rn(bz0, lz), __fsub_rn(lz, bz1)), 0.0f);
    unsigned need = __ballot_sync(kFull, __float_as_uint(sq3_rn(gx, gy, gz)) < mb);
    skipped += need == 0u;
    updated += __popc(need);
    if (need != 0u) {
      while (need != 0u) {  // uniform: one sub-box after the other
        const int g = __ffs(need) - 1;
        need &= need - 1u;
        float4 p[kRowSubPts];
#pragma unroll
        for (int t = 0; t < kRowSubPts; ++t) p[t] = srt[base + 32 * (g * kRowSubPts + t)];
        float best = 0.0f;
        unsigned bk = kNone;
        float px = 0.0f, py = 0.0f, pz = 0.0f;
#pragma unroll
        for (int t = 0; t < kRowSubPts; ++t) {
          const int j = base + 32 * (g * kRowSubPts + t);
          const float d2 =
              sq3_rn(__fsub_rn(p[t].x, lx), __fsub_rn(p[t].y, ly), __fsub_rn(p[t].z, lz));
          const float m = fminf(mind[j], d2);
          mind[j] = m;
          const unsigned i = __float_as_uint(p[t].w);
          const unsigned key = i != kNone ? (i << 16) | static_cast<unsigned>(j) : kNone;
          if (m > best || (m == best && key < bk)) {
            best = m;
            bk = key;
            px = p[t].x;
            py = p[t].y;
            pz = p[t].z;
          }
        }
        const unsigned bits = __float_as_uint(best);
        const unsigned r = __reduce_max_sync(kFull, bits);
        const unsigned rk = __reduce_min_sync(kFull, bits == r ? bk : kNone);
        const int src = __ffs(__ballot_sync(kFull, bk == rk && bits == r)) - 1;
        px = __shfl_sync(kFull, px, src);
        py = __shfl_sync(kFull, py, src);
        pz = __shfl_sync(kFull, pz, src);
        if (lane == g) {
          mb = r;
          mk = rk;
          mx = px, my = py, mz = pz;
        }
      }
      warp_record();
    }
    const int par = step & 1;
    if (lane == 0) slot[par][warp] = RowSlot{wbits, wkey, wx, wy, wz};
    __syncthreads();
    const RowSlot r = slot[par][lane];
    const unsigned gbits = __reduce_max_sync(kFull, r.bits);
    const unsigned gkey = __reduce_min_sync(kFull, r.bits == gbits ? r.key : kNone);
    const int src = __ffs(__ballot_sync(kFull, r.key == gkey)) - 1;
    lx = __shfl_sync(kFull, r.x, src);
    ly = __shfl_sync(kFull, r.y, src);
    lz = __shfl_sync(kFull, r.z, src);
    last = static_cast<int>(gkey >> 16);
    if (tid == 0) o[step] = last;
  }
  if (stats != nullptr && real && lane == 0) {
    const unsigned long long picks = static_cast<unsigned long long>(s - 1);
    atomicAdd(&stats[0], static_cast<unsigned long long>(skipped));
    atomicAdd(&stats[1], picks);
    atomicAdd(&stats[2], subs * picks - updated);
    atomicAdd(&stats[3], subs * picks);
  }
}

template <int PTS>
cudaError_t launch_row(const float* xyz, const int* start, int* out, float4* sorted,
                       unsigned long long* stats, int rows, int n, int s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * PTS * kThreads;
  cudaError_t err = allow_smem(fps_row_kernel<PTS>, smem);
  if (err != cudaSuccess) return err;
  fps_row_kernel<PTS><<<rows, kThreads, smem, stream>>>(xyz, start, out, sorted, stats, n, s);
  return cudaGetLastError();
}

// xyz (rows, n, 3) f32, start (rows,) i32 -> out (rows, s) i32, one block a
// row; sorted: (rows, row_pts(n) * 1024) float4 scratch; stats: null or 4
// u64 (as fps_launch's). 16,384 < n <= 49,152.
extern "C" int fps_row_launch(const float* xyz, const int* start, int* out, float* sorted,
                              unsigned long long* stats, int rows, int n, int s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* srt = reinterpret_cast<float4*>(sorted);
  const int pts = (n + kThreads - 1) / kThreads;
#define FPS_ROW_CASE(P) \
  if (pts <= P) return launch_row<P>(xyz, start, out, srt, stats, rows, n, s, st);
  FPS_ROW_CASE(20)
  FPS_ROW_CASE(24)
  FPS_ROW_CASE(28)
  FPS_ROW_CASE(32)
  FPS_ROW_CASE(36)
  FPS_ROW_CASE(40)
  FPS_ROW_CASE(kRowMaxPts)
#undef FPS_ROW_CASE
  return cudaErrorInvalidValue;
}

// Points a thread of fps_row_kernel's instance for rows of n points (the
// scratch holds rows x that x 1024 float4).
extern "C" int fps_row_pts(int n) {
  constexpr int kInstances[] = {20, 24, 28, 32, 36, 40, kRowMaxPts};
  const int pts = (n + kThreads - 1) / kThreads;
  for (int i = 0; i < 7; ++i)
    if (pts <= kInstances[i]) return kInstances[i];
  return -1;
}

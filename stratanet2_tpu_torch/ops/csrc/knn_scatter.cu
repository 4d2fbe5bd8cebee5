// Weighted scatter-add, the backward of kNN interpolation and of row gathers:
// dx[b, idx[b, j, t], :] += w[b, j, t] * g[b, t, :], rows with no
// contribution 0.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_knn_scatter_kernel (:483,
// pallas_call :560 in _knn_scatter_pallas), which backs both the kNN VJP
// (FP2, FP1: k = 3, the forward's normalised weights) and, through
// scatter_add_pallas (:578), the VJP of gather_rows (:602; SA2's gather of
// the pre-projected rows: k = 1, w = ones, passed here as a null pointer).
// The TPU kernel's one-hot MXU matmuls and hi/lo-bf16 operands exist because
// TPU scatters serialise; they are not carried over.
//
// Bound on the H100: bytes. A call reads g (B, T, F) and idx/w (B, k, T)
// once and writes dx (B, S, F) once (FP1 of the PROD train step: 27 + 4.8 +
// 6.8 MB; FP2 13 + 1.2 + 3.2 MB: 0.017 ms the two at 3.35 TB/s; the k = 1
// gather site: 102 + 3.2 + 6.4 MB), against 2 operations a contribution.
//
// Design: owner computes, one launch, no memset and no float atomics. A
// block owns `rows` consecutive rows of one cloud (grid: tiles x B) in every
// channel and is their only writer; rows is chosen so that the tiles fill
// the card once (knn_scatter_rows: 193 rows, 260 blocks at FP1 and the
// gather site, 105 at FP2). The block streams the cloud's k*T destinations
// (pair p = j*T + t; L2-resident across the cloud's tiles) in rounds of kW
// pairs:
// - compaction: a thread takes kPer consecutive pairs, counts those in the
//   tile by row and warp with shared int atomics (a count has no order), and
//   a warp scan of the threads' hits writes them, in p order, to the warp's
//   part of a stage;
// - a block scan turns the counts into each row's bucket and each warp's
//   cursor in it; each warp walks its staged pairs and places them with
//   __match_any_sync ranks, so a bucket lists its pairs in increasing p;
// - sums: a bucket is cut into chunks of kL pairs (items); warp w takes the
//   items that start in its share of the round's pairs. For 32 pairs at a
//   time a lane a pair computes the pair's g row and weight, then the warp
//   walks them kB at a time, lanes on channels (kCG groups of 32), adding
//   __fmul_rn(w, g[t, ch]) (g itself for k = 1) in bucket order with
//   __fadd_rn; at an item's end its sum goes into the tile's accumulator in
//   shared memory, or, for a hot row (more than kL pairs in the round: the
//   gather site's row 0 takes ~20% of the pairs, as masked ball-query slots
//   put them there), into a slot of its own, and after a barrier one warp
//   adds the row's slots in chunk order.
// The tile is stored once at the end, zeros included. Every row is summed
// in one order that no timing moves: 0 plus, round by round and chunk by
// chunk, each chunk's sum in p order from 0
// (cuda_kernels.knn_scatter_ordered_plain reproduces it; chip_smoke.py holds
// the kernel to it bit for bit, and two launches to each other). Indices
// outside [0, S) fall in no tile and are skipped.
//
// The cost of the design is the re-read of the destinations: every tile of
// a cloud streams all k*T of them (FP1: 120 KB a cloud for each of 13 tiles,
// from L2), and a warp pays ~20 instructions a pair in the sums.
// Measured (scripts/kernel_variants.py, device ms a launch at FP1 / FP2 /
// the gather site, NVIDIA H100 80GB HBM3 at 700 W; the parent's atomics
// 0.0703 / 0.0278 / 0.3185 in the same call): this design 0.0669 / 0.0181 /
// 0.1735. Not kept: tiles of 256 rows or fewer by powers of two (200
// blocks), 0.0765 / 0.0203 / 0.1779; one warp a chunk with loads in batches
// of 8 and no lane-parallel pair work, 0.129 / 0.034 / 0.244 at best; a lane
// an item walking whole g rows (uncoalesced), 0.185 / 0.084 / 0.624; kL =
// 128, 0.0664 / 0.0183 / 0.1947; 256 threads a block (4 an SM), 0.0893 /
// 0.0228 / 0.2534; the next batch's loads issued before this batch's sums
// (spills at 64 registers), 0.0737 / 0.0219 / 0.3326; one 64-bit scan of the
// three counts (spills), 0.0714 / 0.0190 / 0.1885; rounds of 16384 pairs
// with a 16-bit stage, 0.1035 / 0.0209 / 0.2163; 64-row tiles accumulated
// with shared-memory float atomics in no fixed order, 0.139 / 0.085 / 0.785.
#include "common.cuh"

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 8192;             // pairs a round
constexpr int kL = 64;               // contributions a chunk
constexpr int kRowsMax = 256;        // destination rows a block owns, at most
constexpr int kSMs = 132;            // SMs of an H100 SXM
constexpr int kBlocksPerSM = 2;      // blocks an SM holds by registers (64 a thread)
constexpr size_t kSmemMax = 227 * 1024, kSmemSM = 228 * 1024;  // a block's, an SM's
constexpr int kCG = 2;               // channel groups of 32 a pass over the pairs
constexpr int kB = 8;                // pairs a warp loads at once in the sums
constexpr int kPer = kW / kThreads;  // destinations a lane loads a round
constexpr int kHot = 2 * kW / kL;    // chunks of hot rows in a round, at most
static_assert(kRowsMax <= kThreads && kRowsMax <= 256, "a row a scan thread, 8 bits a row");
static_assert(kW % kThreads == 0 && kW <= (1 << 16) && kPer <= 32, "a thread's pairs; 16-bit pair numbers");
static_assert(32 % kB == 0, "a batch of 32 pairs splits into loads of kB");

// exclusive sum over the block's threads, in thread order, and the total;
// scratch holds kWarps ints and must not be in use by another scan
__device__ __forceinline__ int block_excl_scan(int v, int lane, int warp, int* scratch,
                                               int& total) {
  const int incl = warp_incl_scan(v, lane);
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int base = 0;
  total = 0;
  for (int q = 0; q < kWarps; ++q) {
    const int x = scratch[q];
    base += q < warp ? x : 0;
    total += x;
  }
  return base + incl - v;
}

// (row, chunk) items of a round, at most: a chunk of kL a row, and one more
// for each row's partial chunk
__host__ __device__ constexpr int max_items(int rows) { return rows + kW / kL; }

// shared memory of a block that owns `rows` rows of f channels
__host__ __device__ constexpr size_t smem_bytes(int rows, int f) {
  return sizeof(float) * (static_cast<size_t>(rows) * f + (kHot * f > kW ? kHot * f : kW)) +
         sizeof(unsigned short) * kW +
         sizeof(int) * (kWarps * rows + 3 * (rows + 1) + 3 * max_items(rows) + 1 + 2 * kWarps);
}

// rows a block owns: as many as fill the card once (kBlocksPerSM blocks on
// each of kSMs SMs, or fewer if shared memory holds fewer) with the cloud's
// tiles, at most kRowsMax and at least 32. More rows a tile, fewer re-reads
// of the destinations; tiles of equal count, blocks of equal work
extern "C" int knn_scatter_rows(int b, int s, int f) {
  int rows = kRowsMax;
  while (rows > 32 && smem_bytes(rows, f) > kSmemMax) rows /= 2;
  for (int pass = 0; pass < 3; ++pass) {
    const long long fit = static_cast<long long>(kSmemSM / smem_bytes(rows, f));
    const long long per_sm = fit < 1 ? 1 : fit < kBlocksPerSM ? fit : kBlocksPerSM;
    const long long tiles = per_sm * kSMs / b < 1 ? 1 : per_sm * kSMs / b;
    const long long want = (s + tiles - 1) / tiles;
    if (want < rows) rows = want < 32 ? 32 : static_cast<int>(want);
  }
  return rows;
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
knn_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                   const float* __restrict__ g, float* __restrict__ dx, int s, int t, int f,
                   int k, int rows) {
  extern __shared__ float smem[];
  const int items_max = max_items(rows);
  float* acc = smem;                                // rows x f: the tile
  float* part = acc + rows * f;                     // kHot x f: hot rows' chunk sums,
  int* stage = reinterpret_cast<int*>(part);        //   or kW (p << 8 | row) in compaction
  int* cnt = reinterpret_cast<int*>(part + max(kHot * f, kW));  // kWarps x rows
  int* start = cnt + kWarps * rows;                 // rows + 1: bucket starts
  int* cstart = start + rows + 1;                   // rows + 1: first items
  int* hstart = cstart + rows + 1;                  // rows + 1: first hot chunk slots
  int* item_d = hstart + rows + 1;                  // items_max: an item's row
  int* item_q = item_d + items_max;                 // items_max + 1: its first pair
  int* item_slot = item_q + items_max + 1;          // items_max: its hot slot, or -1
  int* wsum = item_slot + items_max;                // 2 x kWarps: the scans' warp sums
  unsigned short* sorted = reinterpret_cast<unsigned short*>(wsum + 2 * kWarps);  // kW

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * rows;
  const int ts = min(rows, s - tile0);
  const int kt = k * t;
  const int* ib = idx + static_cast<size_t>(b) * kt;
  const float* wb = kWeighted ? w + static_cast<size_t>(b) * kt : nullptr;
  const float* gb = g + static_cast<size_t>(b) * t * f;
  for (int e = tid; e < ts * f; e += kThreads) acc[e] = 0.0f;

  for (int round0 = 0; round0 < kt; round0 += kW) {
    const int rn = min(kW, kt - round0);
    // compaction: thread i takes the round's kPer consecutive pairs from
    // i * kPer and counts those that land in the tile by row (shared int
    // atomics: a count has no order); a warp scan of the threads' hits
    // places them, in order, in the warp's part of the stage
    for (int d = lane; d < ts; d += 32) cnt[warp * rows + d] = 0;
    __syncwarp();
    const int begin = warp * (kW / kWarps);
    const int mine = tid * kPer;
    int dest[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) dest[u] = mine + u < rn ? ib[round0 + mine + u] : -1;
    unsigned hits = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const unsigned dd = static_cast<unsigned>(dest[u] - tile0);
      if (dest[u] >= 0 && dd < static_cast<unsigned>(ts)) {
        hits |= 1u << u;
        dest[u] = static_cast<int>(dd);
        atomicAdd(&cnt[warp * rows + dest[u]], 1);
      }
    }
    const int n_mine = __popc(hits);
    const int incl_hits = warp_incl_scan(n_mine, lane);
    const int count = __shfl_sync(~0u, incl_hits, 31);
    int at = begin + incl_hits - n_mine;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (hits & (1u << u)) stage[at++] = ((mine + u) << 8) | dest[u];
    }
    __syncthreads();

    // scans: a thread a row; its total and chunk count packed in one int,
    // then its hot chunks (chunks of a row with more than one); the warps'
    // cursors into its bucket; the items
    int packed = 0, hot = 0;
    if (tid < ts) {
      int run = 0;
      for (int q = 0; q < kWarps; ++q) {
        const int c = cnt[q * rows + tid];
        cnt[q * rows + tid] = run;
        run += c;
      }
      const int nch = (run + kL - 1) / kL;
      packed = (run << 16) | nch;
      hot = nch > 1 ? nch : 0;
    }
    int total, n_hot;
    const int excl = block_excl_scan(packed, lane, warp, wsum, total);
    const int hexcl = block_excl_scan(hot, lane, warp, wsum + kWarps, n_hot);
    const int n_pairs = total >> 16, n_items = total & 0xFFFF;
    if (tid < ts) {
      const int st = excl >> 16, cs = excl & 0xFFFF;
      start[tid] = st;
      cstart[tid] = cs;
      hstart[tid] = hexcl;
      for (int q = 0; q < kWarps; ++q) cnt[q * rows + tid] += st;
      for (int c = 0; c < (packed & 0xFFFF); ++c) {
        item_d[cs + c] = tid;
        item_q[cs + c] = st + c * kL;
        item_slot[cs + c] = hot ? hexcl + c : -1;
      }
    }
    if (tid == 0) {
      start[ts] = n_pairs;
      cstart[ts] = n_items;
      item_q[n_items] = n_pairs;
    }
    __syncthreads();

    // placement: each warp walks its compacted pairs in order; a pair's
    // slot is its warp's cursor plus its rank among the window's peers
    for (int o = 0; o < count; o += 32) {
      const bool valid = o + lane < count;
      const int e = valid ? stage[begin + o + lane] : 0;
      const int d = e & 0xFF;
      const unsigned act = __ballot_sync(~0u, valid);
      if (valid) {
        const unsigned peers = __match_any_sync(act, d);
        const int pos = cnt[warp * rows + d] + __popc(peers & lt);
        sorted[pos] = static_cast<unsigned short>(e >> 8);
        __syncwarp(act);
        if (lane == __ffs(peers) - 1) cnt[warp * rows + d] = pos + __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();

    // sums: warp w takes the items that start in its share of the round's
    // pairs, a contiguous run of the buckets. It takes the run 32 pairs at
    // a time, a lane a pair for the pair's own work (its g row and weight),
    // then walks them kB at a time (all their loads first) with lanes on
    // channels; a chunk's sum goes out when its last pair is in
    int lo = 0, hi = 0;
    {
      const int t_lo = (warp * n_pairs + kWarps - 1) / kWarps;
      const int t_hi = ((warp + 1) * n_pairs + kWarps - 1) / kWarps;
      for (int i0 = 0; i0 < n_items; i0 += 32) {
        const int q = i0 + lane < n_items ? item_q[i0 + lane] : n_pairs;
        lo += __popc(__ballot_sync(~0u, q < t_lo));
        hi += __popc(__ballot_sync(~0u, q < t_hi));
      }
    }
    for (int c0 = 0; c0 < f && lo < hi; c0 += 32 * kCG) {
      int item = lo, next = item_q[lo + 1];
      const int q_end = item_q[hi];
      float a[kCG];
#pragma unroll
      for (int u = 0; u < kCG; ++u) a[u] = 0.0f;
      for (int q0 = item_q[lo]; q0 < q_end; q0 += 32) {
        int off = 0;
        float wl = 1.0f;
        if (q0 + lane < q_end) {
          const int p = round0 + sorted[q0 + lane];
          off = (p - (p / t) * t) * f;
          if (kWeighted) wl = wb[p];
        }
        const int m = min(32, q_end - q0);
        for (int j0 = 0; j0 < m; j0 += kB) {
          float wv[kB], v[kB][kCG];
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            const int o = __shfl_sync(~0u, off, j0 + j);
            wv[j] = kWeighted ? __shfl_sync(~0u, wl, j0 + j) : 1.0f;
#pragma unroll
            for (int u = 0; u < kCG; ++u) {
              const int ch = c0 + u * 32 + lane;
              v[j][u] = ch < f ? gb[o + ch] : 0.0f;
            }
          }
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            if (j0 + kB > m && j0 + j >= m) break;  // only the last batch is cut
#pragma unroll
            for (int u = 0; u < kCG; ++u) {
              a[u] = __fadd_rn(a[u], kWeighted ? __fmul_rn(wv[j], v[j][u]) : v[j][u]);
            }
            if (q0 + j0 + j + 1 == next) {  // the item's last pair: its sum goes out
              const int d = item_d[item], slot = item_slot[item];
#pragma unroll
              for (int u = 0; u < kCG; ++u) {
                const int ch = c0 + u * 32 + lane;
                if (ch < f) {
                  if (slot >= 0) {
                    part[slot * f + ch] = a[u];
                  } else {
                    acc[d * f + ch] = __fadd_rn(acc[d * f + ch], a[u]);
                  }
                }
                a[u] = 0.0f;
              }
              ++item;
              next = item < hi ? item_q[item + 1] : q_end;
            }
          }
        }
      }
    }

    // a hot row's chunks, added in chunk order by one warp. Without hot
    // rows no barrier is needed here: what the next round writes before its
    // first barrier (the counts, the stage over the unused chunk sums) is
    // not read by this round's sums
    if (n_hot > 0) {
      __syncthreads();
      for (int d = warp; d < ts; d += kWarps) {
        const int n = cstart[d + 1] - cstart[d];
        if (n < 2) continue;
        for (int ch = lane; ch < f; ch += 32) {
          float x = acc[d * f + ch];
          for (int c = 0; c < n; ++c) x = __fadd_rn(x, part[(hstart[d] + c) * f + ch]);
          acc[d * f + ch] = x;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  float* out = dx + (static_cast<size_t>(b) * s + tile0) * f;
  for (int e = tid; e < ts * f; e += kThreads) out[e] = acc[e];
}

// idx (b, k, t) i32, w (b, k, t) f32 or null (ones), g (b, t, f) -> dx
// (b, s, f), every element written; b <= 65535, t * f < 2^31.
extern "C" int knn_scatter_launch(const int* idx, const float* w, const float* g, float* dx,
                                  int b, int k, int t, int s, int f, void* stream) {
  if (b == 0 || s == 0 || f == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = knn_scatter_rows(b, s, f);
  const size_t smem = smem_bytes(rows, f);
  const dim3 grid((s + rows - 1) / rows, b);
  cudaError_t err;
  if (w) {
    err = allow_smem(knn_scatter_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    knn_scatter_kernel<true><<<grid, kThreads, smem, st>>>(idx, w, g, dx, s, t, f, k, rows);
  } else {
    err = allow_smem(knn_scatter_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    knn_scatter_kernel<false><<<grid, kThreads, smem, st>>>(idx, w, g, dx, s, t, f, k, rows);
  }
  return cudaGetLastError();
}

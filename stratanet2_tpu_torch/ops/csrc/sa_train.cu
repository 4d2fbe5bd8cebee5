// Fused set-abstraction interior, train mode: the four edge passes behind
// ops/sa_train.py. Each pass rebuilds the edges of every centroid from the
// per-point layer-1 projection q (B, N, C1) and the centroid term cterm
// (B, C, C1) through the grouped selection idx/mask (B, C, K) of
// csrc/ball_query.cu; no (B, C, K, F) edge tensor is written to memory.
//
//   e0 = q[idx] - cterm,  h1 = relu(e0)
//   two layers:  y1 = h1*a1 + c1 (BN1 folded),  u = y1 @ W2 + b2,  h = relu(u)
//   one layer:   h = h1
//
// Replaces, in stratanet2_tpu/ops/pallas_kernels.py:
//   sa_train_stats_kernel <- _sa_stats1_kernel      (:1523, pallas_call in _sa_train_stats)
//   sa_train_main_kernel  <- _sa_train_main_kernel  (:1565, in _sa_train_main)
//   sa_train_bwd1_kernel  <- _sa_train_bwd1_kernel  (:1645, in _sa_train_bwd1)
//   sa_train_bwd2_kernel  <- _sa_train_bwd2_kernel  (:1750, in _sa_train_bwd2)
// The TPU kernels' block-grouped q layout, hi/lo-bf16 one-hot MXU gathers
// and scatters, lane padding and (16, 128) parameter packing are not carried
// over: Hopper gathers q rows with indexed loads, and bwd2's dq is summed
// from an edge buffer by a pass of its own, sa_train_dq_kernel, in which
// each block owns one group of points (the TPU kernel's one-hot scatter over
// a group's rows relies on the same grouping).
//
// Bound on the H100: operations, not bytes, but for stats (bytes, 0.0072
// ms). A pass reads q, cterm, idx and mask once (SA1 of the PROD train
// step: 12.8 + 3.2 + 6.4 + 1.6 MB) while
// every valid edge costs 6*C1 operations in layer 1 and, with two layers,
// 2*C1*C2 more for each 16x16 product (forward in every pass, transposed and
// outer products in the backward). The random q rows (64 or 128 B) come from
// L2: q is 12.8 MB at SA1 and 6.4 MB at SA2. At the PROD train step
// (chip_smoke.py's bound, float32 operations of the valid edges over 67
// TFLOP/s) main is bound at 0.017 ms (SA1 + SA2), bwd1 at 0.039, bwd2 at
// 0.034; what the card can issue is the lower limit that matters: phase 16
// of chip_smoke.py (`edge_loop`) gives each slot loop's SASS a warp an edge
// and the issue floor, the slots walked x SASS an edge / (132 SMs x 4
// schedulers x the maximum SM clock).
//
// Design of main, bwd1 and bwd2: lane = channel. A group of C1 lanes (a
// half-warp at SA1, C1 = C2 = 16; a warp at SA2, C1 = 32) owns one centroid
// at a time. Each q row is one coalesced 64 or 128 B load. The 16x16 layer-2
// product: lane o holds column o of W2 and needs y1[i] of every lane i; the
// transposed product of the backward: lane i holds row i of W2 and needs
// du[o] of every lane o.
// - stats, which has no product: 4 lanes a centroid, each reading 4
//   channels of the 64 B q row as one float4, so a warp takes 8 centroids
//   and each LDG.128 brings 8 rows. Slots in batches of KB: the warp loads
//   its 8 centroids' idx and mask for the batch together (consecutive rows:
//   coalesced, the two loads in flight at once) into shared memory, each
//   lane reads its centroid's KB points back and loads their KB rows
//   together; a masked or past-K slot adds an exact 0. At PROD it gathers
//   1.6 M rows (102 MB) from L2 in 0.0156 ms, ~6.6 TB/s: the L2 gather, not
//   HBM (0.0072 ms) nor the issue floor (0.0074 ms), is what bounds it.
// - main, bwd1 and bwd2 take their centroid's slots KB at a time
//   (`load_slots`): the batch's idx and mask, then its KB q rows, are loaded
//   together, so KB rows are in flight and not one; every slot of a batch is
//   computed, and a masked slot's values enter no sum, no max/min and no
//   winner (they are selected away, not branched around), so the two halves
//   of a warp never split on each other's masks. A tail batch (s0 + u >= K)
//   is masked the same way: the kernels take any K.
// - The products go through shared memory, no shuffle: each lane writes its
//   channel of the batch's y1 rows (`stage_rows`) and reads a row back as
//   C1/4 broadcast LDS.128 (`row_dot`); bwd1 reads the staged y1 row a second
//   time for the dW2 outer product (`row_outer`), and bwd1 and bwd2 then
//   stage the du rows for dy1 = du @ W2^T. The shuffle form it replaces
//   issued one SHFL a term: 16 a lane an edge in main at SA1, 48 in bwd1.
// - main at SA2, where a group is a whole warp, also stages the batch's idx
//   and mask through shared memory (`load_slots_staged`): two loads a batch
//   in place of 2*KB that all 32 lanes issue for one address. At SA1 (two
//   groups a warp) and in bwd1 and bwd2 this staging measured slower.
// KB, by kernel and instance (kMainKB1 ... kBwd2KB2 below), was chosen by
// scripts/kernel_variants.py on the H100 (PERF.md §6 has every candidate's
// time): main SA1 of 2, 4, 8; main SA2 of 8, 16, 32 (staged) and 4, 8, 16
// (not); bwd1 of 2, 4, 8; bwd2 of 2, 4, 8 and 4, 8, 16 (PR 6).
// Measured on the H100 (NVIDIA H100 80GB HBM3, 700 W; CUDA-event ms a
// launch at the PROD train-step sites, scripts/kernel_variants.py; the
// shuffle form each replaces in the same call in brackets; each design not
// kept was timed beside the kept one in its own call, PERF.md §6):
// - stats (device ms a launch at SA1; the earlier form, one slot at a time
//   0.0288 / 0.0289 in each call): kept, 4 lanes, staged, KB 16, 0.0156
//   (event 0.0171), 4.84 SASS a warp an edge (2.5 FP32), 59 registers. Not
//   kept: KB 4, 8, 32 (0.0201, 0.0170, 0.0163); the mask loaded before the
//   idx it selects (KB 4, 8, 16, 32: 0.0187, 0.0188, 0.0186, 0.0203; 5.44
//   to 4.79 SASS an edge); 4 lanes unstaged (0.0208, 0.0231, 0.0228,
//   0.0211; ~5.5); lane = channel unstaged (0.0347, 0.0336, 0.0321, 0.0319;
//   13-14) and staged (0.0363, 0.0299, 0.0284, 0.0269; 9-12).
// - main: 0.0714 at SA1 (0.1067), 0.0361 at SA2 (0.0403); slot loops of 27.3
//   and 26.9 SASS a warp an edge, 64 and 80 registers. Not kept: KB 2 and 8
//   at SA1 (0.0777, 0.0718); unstaged KB 4, 8, 16 at SA2 (0.0424, 0.0405,
//   0.0408), staged KB 8 and 32 (0.0379, 0.0365); staged at SA1 (0.0770);
//   the next batch's idx and mask loaded ahead (0.0715, 0.0418); registers
//   capped for 5 or 6 blocks an SM (48 or 40 registers: 0.0800, 0.0908).
// - bwd1: 0.1304 (0.3002); 52.1 SASS a warp an edge, 127 registers (2
//   blocks an SM). Not kept: KB 2 and 8 (0.1481; 0.1926 at 130 registers, 1
//   block an SM); capped at 80 registers for 3 blocks (168 B of spills,
//   0.2228); staged slots (0.1372); loads ahead (0.1315). Group rows padded
//   against the two half-warps' 2-way bank conflict measured within noise in
//   all three kernels (main 0.0696, bwd1 0.1302, bwd2 0.1508) and was not
//   kept.
// - bwd2 (PR 6): 0.151 at SA1 against 0.268 for the shuffle form, 0.046 at
//   SA2 against 0.052; an edge a lane (a lane computes all 16 channels of its
//   edge, W2 and the table from the constant bank) measured 0.167 at SA1
//   and 0.075 at SA2, 0.251 and 0.121 with the q rows staged through
//   shared memory. 128 registers at SA1 (2 blocks an SM), 64 at SA2.
// - bwd2 with the edge buffer and the dq pass (device ms at SA1 / SA2): edge
//   pass 0.1435 / 0.0506 (the earlier form, with float atomics into dq,
//   0.188 the two), dq pass 0.1035 / 0.0594, of which the ids' loads, the
//   counting sort and the stores take 0.0319 / 0.0176 (its sums cut).
//   Not kept: one warp placing every centroid (0.1043 / 0.0631); kDqB 2
//   and 8 (0.1028 / 0.0592, 0.1029 / 0.0590); a slot-major buffer
//   (B, K, C, C1), a block's rows contiguous (dq 0.1067 / 0.0580, the edge
//   pass 0.1540 / 0.0716). `sa_train_dq_ordered_plain` of the buffer equals
//   dq bit for bit in each.
// Every per-edge value is computed with _rn intrinsics in the order of the
// plain versions (cuda_kernels.sa_train_edges:
// the products as fma chains in index order, no contraction elsewhere), so
// kernel and plain agree bit for bit on every edge value and on every winner
// slot; only the sums over edges differ, by the order of summation.
// Per-channel sums over edges (BN statistics, S1/S2, db2, dW2) are reduced
// over the groups of a block in a fixed order and written as one partial row
// per block; the wrapper sums the rows with torch, so two runs give the same
// bits. A masked slot adds an exact zero to a lane's chain, if anything, so
// the chain's rounding depth is its valid edges (chip_smoke.sa_sum_depth).
// dq is a scatter over points: bwd2 writes each edge's de0 once to an edge
// buffer and sa_train_dq_kernel sums it, each point's row in one fixed
// order (cuda_kernels.sa_train_dq_ordered_plain), so no kernel here has a
// float atomic and two runs give the same bits. 256 threads a block; the
// grid (given by the wrapper) is at most 8 blocks of 256 threads on each of
// 132 SMs, each group walking centroids with the grid's stride.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr float kNeg = -3.4e38f;  // masked slots enter the max as this, the min as -this
// Slots a group takes at once: main at SA1 and SA2, bwd1 (SA1 only), bwd2 at
// SA1 and SA2 (see the head note).
constexpr int kMainKB1 = 4, kMainKB2 = 16, kBwd1KB = 4, kBwd2KB1 = 4, kBwd2KB2 = 8;
constexpr int kDqB = 4;  // de0 rows a dq group loads at once
// The stats pass (SA1 only): channels a lane (one float4 of the q row, so
// C / kStatsV lanes a centroid; sa_train_stats_lanes gives them to the
// wrapper) and slots a batch.
constexpr int kStatsV = 4;
constexpr int kStatsKB = 16;

// Rows of the (kAffRows, width) per-channel table `aff`, in the order of
// cuda_kernels.SA_AFF_ROWS.
enum AffRow {
  kA1, kC1, kB2, kGos2, kM2, kInvS2, kS1n2, kS2n2,
  kM1, kInvS1, kGos1, kS1n1, kS2n1, kShift1, kShiftL, kAffRows
};

// The lanes of the caller's group of W lanes (W = 16 or 32).
template <int W>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (W == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << W) - 1u) << ((threadIdx.x & 31) & ~(W - 1));
  }
}

// Slots s0 .. s0 + KB - 1 of one centroid (idx row ib, mask row mb, k
// slots): ok[u], the slot lies inside k and its mask is True; qi[u], the
// index of this lane's element of its q row (pb: the cloud's q plus the
// lane; the cloud's point 0 where not ok, so every load is in bounds); e0[u]
// = q - ct. The batch's idx and mask load first, then its q rows together.
template <int C, int KB>
__device__ __forceinline__ void load_slots(const float* __restrict__ q, size_t pb,
                                           const int* __restrict__ ib,
                                           const bool* __restrict__ mb, int s0, int k, float ct,
                                           bool (&ok)[KB], size_t (&qi)[KB], float (&e0)[KB]) {
#pragma unroll
  for (int u = 0; u < KB; ++u) {
    ok[u] = s0 + u < k && mb[s0 + u];
    qi[u] = pb + static_cast<size_t>(ok[u] ? ib[s0 + u] : 0) * C;
  }
#pragma unroll
  for (int u = 0; u < KB; ++u) e0[u] = __fsub_rn(q[qi[u]], ct);
}

// load_slots for a group that is a whole warp: lanes u < KB load slot s0 + u's
// idx (-1 where masked or past k) into the group's KB ints in shared memory
// (`slots`) and every lane reads them back as int4, so a batch takes two
// loads where load_slots takes 2*KB that every lane issues for one address.
template <int C, int KB>
__device__ __forceinline__ void load_slots_staged(const float* __restrict__ q, size_t pb,
                                                  const int* __restrict__ ib,
                                                  const bool* __restrict__ mb, int s0, int k,
                                                  float ct, bool (&ok)[KB], size_t (&qi)[KB],
                                                  float (&e0)[KB], int* slots, int lane) {
  static_assert(C == 32 && KB % 4 == 0 && KB <= C, "a warp stages KB ints, read as int4");
  if (lane < KB) {
    const int s = s0 + lane;
    slots[lane] = s < k && mb[s] ? ib[s] : -1;
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < KB / 4; ++m) {
    const int4 t = reinterpret_cast<const int4*>(slots)[m];
    const int id[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[4 * m + j] = id[j] >= 0;
      qi[4 * m + j] = pb + static_cast<size_t>(id[j] >= 0 ? id[j] : 0) * C;
    }
  }
  __syncwarp();  // read before the next batch writes
#pragma unroll
  for (int u = 0; u < KB; ++u) e0[u] = __fsub_rn(q[qi[u]], ct);
}

// Each lane writes its channel of the batch's KB rows (row u = v[u] over the
// group's lanes) to the group's rows in shared memory; then the group syncs.
template <int C, int KB>
__device__ __forceinline__ void stage_rows(float* mine, const float (&v)[KB], int lane,
                                           unsigned gm) {
#pragma unroll
  for (int u = 0; u < KB; ++u) mine[u * C + lane] = v[u];
  __syncwarp(gm);
}

// sum_i row[i] * w[i] over a staged row of C floats, read as C/4 broadcast
// LDS.128: the fma chain in index order (fmul for term 0, then __fmaf_rn),
// as cuda_kernels._fma_chain rounds it.
template <int C>
__device__ __forceinline__ float row_dot(const float* row, const float (&w)[C]) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < C / 4; ++m) {
    const float4 y = r[m];
    acc = m == 0 ? __fmul_rn(y.x, w[0]) : __fmaf_rn(y.x, w[4 * m], acc);
    acc = __fmaf_rn(y.y, w[4 * m + 1], acc);
    acc = __fmaf_rn(y.z, w[4 * m + 2], acc);
    acc = __fmaf_rn(y.w, w[4 * m + 3], acc);
  }
  return acc;
}

// acc[i] = fma(row[i], d, acc[i]) for i < C over a staged row (LDS.128).
template <int C>
__device__ __forceinline__ void row_outer(const float* row, float d, float* acc) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int m = 0; m < C / 4; ++m) {
    const float4 y = r[m];
    acc[4 * m] = __fmaf_rn(y.x, d, acc[4 * m]);
    acc[4 * m + 1] = __fmaf_rn(y.y, d, acc[4 * m + 1]);
    acc[4 * m + 2] = __fmaf_rn(y.z, d, acc[4 * m + 2]);
    acc[4 * m + 3] = __fmaf_rn(y.w, d, acc[4 * m + 3]);
  }
}

// The BN backward at one edge, dx = gos * ((dy - s1n) - xhat * s2n) with
// xhat = (x - m) * inv_s, times the ReLU's gate (pre > 0).
__device__ __forceinline__ float bn_relu_bwd(float dy, float x, float pre, float m, float inv_s,
                                             float gos, float s1n, float s2n) {
  const float xhat = __fmul_rn(__fsub_rn(x, m), inv_s);
  const float dx = __fmul_rn(gos, __fsub_rn(__fsub_rn(dy, s1n), __fmul_rn(xhat, s2n)));
  return pre > 0.f ? dx : 0.f;
}

// Sums each lane's v[0..V) over the block's groups, in group order, into
// out[j * C + lane]: one partial row of V*C values per block.
template <int C, int V>
__device__ __forceinline__ void block_reduce(const float (&v)[V], float* out) {
  constexpr int kGroups = kThreads / C;
  __shared__ float red[V * kThreads];
  const int lane = threadIdx.x % C, grp = threadIdx.x / C;
#pragma unroll
  for (int j = 0; j < V; ++j) red[(j * kGroups + grp) * C + lane] = v[j];
  __syncthreads();
  for (int t = threadIdx.x; t < V * C; t += kThreads) {
    const int j = t / C, l = t % C;
    float s = 0.f;
    for (int g = 0; g < kGroups; ++g) s += red[(j * kGroups + g) * C + l];
    out[t] = s;
  }
}

// The per-channel parameters of one lane: BN1 fold, layer 2 and both BNs'
// backward terms, loaded once per thread (a kernel's unused ones are dropped
// by the compiler).
template <int C, bool TWO>
struct LaneParams {
  float a1, c1, b2, gos2, m2, inv_s2, s1n2, s2n2, m1, inv_s1, gos1, s1n1, s2n1;
  float w2c[C];  // W2[:, lane]
  float w2r[C];  // W2[lane, :]

  __device__ __forceinline__ LaneParams(const float* aff, const float* w2, int lane) {
    const auto row = [&](int r) { return aff[r * C + lane]; };
    m1 = row(kM1);
    inv_s1 = row(kInvS1);
    gos1 = row(kGos1);
    s1n1 = row(kS1n1);
    s2n1 = row(kS2n1);
    if constexpr (TWO) {
      a1 = row(kA1);
      c1 = row(kC1);
      b2 = row(kB2);
      gos2 = row(kGos2);
      m2 = row(kM2);
      inv_s2 = row(kInvS2);
      s1n2 = row(kS1n2);
      s2n2 = row(kS2n2);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        w2c[i] = w2[i * C + lane];
        w2r[i] = w2[lane * C + i];
      }
    }
  }
};

// The 4 floats at p (16-byte aligned) as one float4 load.
__device__ __forceinline__ void load4(const float* __restrict__ p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// BN1 batch statistics: per-block partials of sum(h1 - shift1) and
// sum((h1 - shift1)^2) over the valid edges -> partial (grid, 2, C).
// L = C / kStatsV lanes a centroid, each taking 4 channels of its q rows as
// one float4; a warp takes 32 / L consecutive centroids at once.
// Slots KB at a time: the warp loads its centroids' batch of idx and mask
// (coalesced, both loads in flight together) into shared memory as points,
// -1 where masked, past k or past the last centroid; each lane reads its
// centroid's KB points back and loads their KB q rows together. Every slot
// is computed and a slot without a point adds an exact 0.
template <int C, int KB>
__global__ void __launch_bounds__(kThreads)
sa_train_stats_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                      const int* __restrict__ idx, const bool* __restrict__ mask,
                      const float* __restrict__ aff, float* __restrict__ partial, int n, int c,
                      int k, int total) {
  constexpr int V = kStatsV, L = C / V;
  constexpr int kWarps = kThreads / 32, kCPW = 32 / L, kGroups = kThreads / L;
  static_assert(V == 4 && C % V == 0 && 32 % L == 0,
                "a lane reads a float4; a warp holds whole centroids");
  __shared__ __align__(16) int slot_rows[kWarps * kCPW * KB];
  __shared__ float red[2 * kGroups * C];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch0 = (lane % L) * V;
  int* my_slots = slot_rows + warp * kCPW * KB;
  float shift[V], s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    shift[v] = aff[kShift1 * C + ch0 + v];
    s1[v] = 0.f;
    s2[v] = 0.f;
  }
  // the warp's centroids base .. base + kCPW - 1: group g of block i walks
  // centroids i * kGroups + g + j * grid * kGroups, as in the other passes
  for (int base = (blockIdx.x * kWarps + warp) * kCPW; base < total;
       base += gridDim.x * kGroups) {
    const int cc = min(base + lane / L, total - 1);  // past the last: no point at all
    float ct[V];
    load4(cterm + static_cast<size_t>(cc) * C + ch0, ct);
    const size_t pb = static_cast<size_t>(cc / c) * n * C + ch0;
    for (int s0 = 0; s0 < k; s0 += KB) {
#pragma unroll
      for (int r = 0; r < (kCPW * KB + 31) / 32; ++r) {
        const int e = lane + 32 * r;  // centroid base + e / KB, slot s0 + e % KB
        if (e < kCPW * KB) {
          const int ce = base + e / KB, s = s0 + e % KB;
          int id = -1;
          if (ce < total && s < k) {
            const size_t o = static_cast<size_t>(ce) * k + s;
            const int i = idx[o];
            id = mask[o] ? i : -1;
          }
          my_slots[e] = id;
        }
      }
      __syncwarp();
      int id[KB];
#pragma unroll
      for (int u = 0; u < KB; ++u) id[u] = my_slots[(lane / L) * KB + u];
      __syncwarp();  // read before the next batch writes
      float x[KB][V];
#pragma unroll
      for (int u = 0; u < KB; ++u)
        load4(q + pb + static_cast<size_t>(id[u] >= 0 ? id[u] : 0) * C, x[u]);
#pragma unroll
      for (int u = 0; u < KB; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float h1 = fmaxf(__fsub_rn(x[u][v], ct[v]), 0.f);
          const float hc = id[u] >= 0 ? __fsub_rn(h1, shift[v]) : 0.f;
          s1[v] = __fadd_rn(s1[v], hc);
          s2[v] = __fmaf_rn(hc, hc, s2[v]);
        }
      }
    }
  }
  // the block's groups in order into one partial row
  const int grp = threadIdx.x / L;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[grp * C + ch0 + v] = s1[v];
    red[(kGroups + grp) * C + ch0 + v] = s2[v];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * C; t += kThreads) {
    const int j = t / C, ch = t % C;
    float s = 0.f;
    for (int g = 0; g < kGroups; ++g) s = __fadd_rn(s, red[(j * kGroups + g) * C + ch]);
    partial[static_cast<size_t>(blockIdx.x) * 2 * C + t] = s;
  }
}

// Statistics of the last layer's pre-BN h (shift shift_l) as partials
// (grid, 2, C), and per centroid and channel the masked max and min of h
// over the K slots with the first winning slot (strict > and <, slot order).
// Slots KB at a time, every one computed; with two layers the batch's y1
// rows go through shared memory for u = y1 @ W2[:, lane] + b2. Where a group
// is a whole warp (SA2) the batch's idx and mask go through shared memory
// too (`load_slots_staged`).
template <int C, bool TWO, int KB>
__global__ void __launch_bounds__(kThreads)
sa_train_main_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                     const int* __restrict__ idx, const bool* __restrict__ mask,
                     const float* __restrict__ aff, const float* __restrict__ w2,
                     float* __restrict__ partial, float* __restrict__ vmax_out,
                     float* __restrict__ vmin_out, int* __restrict__ amax_out,
                     int* __restrict__ amin_out, int n, int c, int k, int total) {
  constexpr int kGroups = kThreads / C;
  constexpr bool kStage = C == 32;
  __shared__ __align__(16) float rows[TWO ? kGroups * KB * C : 4];
  __shared__ __align__(16) int slot_rows[kStage ? kGroups * KB : 4];
  const int lane = threadIdx.x % C;
  const unsigned gm = group_mask<C>();
  const float shift = aff[kShiftL * C + lane];
  const LaneParams<C, TWO> p(aff, w2, lane);
  float* mine = rows + (TWO ? (threadIdx.x / C) * KB * C : 0);
  int* my_slots = slot_rows + (kStage ? (threadIdx.x / C) * KB : 0);
  float v[2] = {0.f, 0.f};
  for (int cent = blockIdx.x * kGroups + threadIdx.x / C; cent < total;
       cent += gridDim.x * kGroups) {
    const size_t pb = static_cast<size_t>(cent / c) * n * C + lane;
    const size_t o = static_cast<size_t>(cent) * C + lane;
    const float ct = cterm[o];
    const int* ib = idx + static_cast<size_t>(cent) * k;
    const bool* mb = mask + static_cast<size_t>(cent) * k;
    float vmax = kNeg, vmin = -kNeg;
    int amax = 0, amin = 0;
    for (int s0 = 0; s0 < k; s0 += KB) {
      bool ok[KB];
      size_t qi[KB];
      float h[KB];
      if constexpr (kStage) {
        load_slots_staged<C, KB>(q, pb, ib, mb, s0, k, ct, ok, qi, h, my_slots, lane);
      } else {
        load_slots<C, KB>(q, pb, ib, mb, s0, k, ct, ok, qi, h);
      }
#pragma unroll
      for (int u = 0; u < KB; ++u) h[u] = fmaxf(h[u], 0.f);  // h1
      if constexpr (TWO) {
        float y1[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u) y1[u] = __fadd_rn(__fmul_rn(h[u], p.a1), p.c1);
        stage_rows<C, KB>(mine, y1, lane, gm);
#pragma unroll
        for (int u = 0; u < KB; ++u)
          h[u] = fmaxf(__fadd_rn(row_dot<C>(mine + u * C, p.w2c), p.b2), 0.f);
        __syncwarp(gm);  // the rows are read before the next batch writes
      }
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const float hc = ok[u] ? __fsub_rn(h[u], shift) : 0.f;
        v[0] = __fadd_rn(v[0], hc);
        v[1] = __fmaf_rn(hc, hc, v[1]);
        if (ok[u] && h[u] > vmax) {
          vmax = h[u];
          amax = s0 + u;
        }
        if (ok[u] && h[u] < vmin) {
          vmin = h[u];
          amin = s0 + u;
        }
      }
    }
    vmax_out[o] = vmax;
    vmin_out[o] = vmin;
    amax_out[o] = amax;
    amin_out[o] = amin;
  }
  block_reduce<C, 2>(v, partial + static_cast<size_t>(blockIdx.x) * 2 * C);
}

// Two layers only: BN2's backward at every valid edge (its cotangent dy2 is
// gt at the centroid's winner slot, 0 elsewhere), then per-block partials
// (grid, 3 + C, C) of S1_1 = sum dy1, S2_1 = sum dy1 * xhat1, db2 = sum du
// and dW2[i][o] = sum y1[i] du[o] (rows 3 + i).
// Slots KB at a time, every one computed, a masked slot's du set to 0: the
// staged y1 rows give u and the dW2 outer product, then the staged du rows
// give dy1 = du @ W2[lane, :]^T.
template <int C, int KB>
__global__ void __launch_bounds__(kThreads)
sa_train_bwd1_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                     const int* __restrict__ idx, const bool* __restrict__ mask,
                     const float* __restrict__ aff, const float* __restrict__ w2,
                     const int* __restrict__ awin, const float* __restrict__ gt,
                     float* __restrict__ partial, int n, int c, int k, int total) {
  constexpr int kGroups = kThreads / C;
  __shared__ __align__(16) float rows[kGroups * KB * C];
  const int lane = threadIdx.x % C;
  const unsigned gm = group_mask<C>();
  const LaneParams<C, true> p(aff, w2, lane);
  float* mine = rows + (threadIdx.x / C) * KB * C;
  float v[3 + C];
#pragma unroll
  for (int j = 0; j < 3 + C; ++j) v[j] = 0.f;
  for (int cent = blockIdx.x * kGroups + threadIdx.x / C; cent < total;
       cent += gridDim.x * kGroups) {
    const size_t pb = static_cast<size_t>(cent / c) * n * C + lane;
    const size_t o = static_cast<size_t>(cent) * C + lane;
    const float ct = cterm[o];
    const int aw = awin[o];
    const float g = gt[o];
    const int* ib = idx + static_cast<size_t>(cent) * k;
    const bool* mb = mask + static_cast<size_t>(cent) * k;
    for (int s0 = 0; s0 < k; s0 += KB) {
      bool ok[KB];
      size_t qi[KB];
      float e0[KB], y1[KB], du[KB];
      load_slots<C, KB>(q, pb, ib, mb, s0, k, ct, ok, qi, e0);
#pragma unroll
      for (int u = 0; u < KB; ++u) y1[u] = __fadd_rn(__fmul_rn(fmaxf(e0[u], 0.f), p.a1), p.c1);
      stage_rows<C, KB>(mine, y1, lane, gm);
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const float uu = __fadd_rn(row_dot<C>(mine + u * C, p.w2c), p.b2);
        const float d = bn_relu_bwd(aw == s0 + u ? g : 0.f, fmaxf(uu, 0.f), uu, p.m2, p.inv_s2,
                                    p.gos2, p.s1n2, p.s2n2);
        du[u] = ok[u] ? d : 0.f;
        v[2] = __fadd_rn(v[2], du[u]);
        row_outer<C>(mine + u * C, du[u], v + 3);  // dW2[i][lane] += y1[i] du
      }
      __syncwarp(gm);  // the y1 rows are read
      stage_rows<C, KB>(mine, du, lane, gm);
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const float dy1 = row_dot<C>(mine + u * C, p.w2r);  // 0 on a masked slot
        const float xhat1 = __fmul_rn(__fsub_rn(fmaxf(e0[u], 0.f), p.m1), p.inv_s1);
        v[0] = __fadd_rn(v[0], dy1);
        v[1] = __fmaf_rn(dy1, xhat1, v[1]);
      }
      __syncwarp(gm);  // the du rows are read before the next batch writes
    }
  }
  block_reduce<C, 3 + C>(v, partial + static_cast<size_t>(blockIdx.x) * (3 + C) * C);
}

// BN1's backward at every valid edge through layer 1's ReLU: de0, written
// to the edge buffer de (B, C, K, C1) (an exact 0 on a masked slot), and
// dcterm = -sum over the K slots of de0. sa_train_dq_kernel then sums de
// into dq, so this kernel writes every element once and has no atomic.
// With two layers dy1 comes from BN2's backward as
// in bwd1; with one, dy1 is gt at the winner slot. Slots KB at a time, every
// one computed, as in main and bwd1; with two layers the y1 rows, then the
// du rows, go through shared memory.
template <int C, bool TWO, int KB>
__global__ void __launch_bounds__(kThreads)
sa_train_bwd2_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                     const int* __restrict__ idx, const bool* __restrict__ mask,
                     const float* __restrict__ aff, const float* __restrict__ w2,
                     const int* __restrict__ awin, const float* __restrict__ gt,
                     float* __restrict__ de, float* __restrict__ dcterm, int n, int c, int k,
                     int total) {
  constexpr int kGroups = kThreads / C;
  __shared__ __align__(16) float rows[TWO ? kGroups * KB * C : 4];
  const int lane = threadIdx.x % C;
  const unsigned gm = group_mask<C>();
  const LaneParams<C, TWO> p(aff, w2, lane);
  float* mine = rows + (TWO ? (threadIdx.x / C) * KB * C : 0);
  for (int cent = blockIdx.x * kGroups + threadIdx.x / C; cent < total;
       cent += gridDim.x * kGroups) {
    const size_t pb = static_cast<size_t>(cent / c) * n * C + lane;
    const size_t o = static_cast<size_t>(cent) * C + lane;
    const float ct = cterm[o];
    const int aw = awin[o];
    const float g = gt[o];
    const int* ib = idx + static_cast<size_t>(cent) * k;
    const bool* mb = mask + static_cast<size_t>(cent) * k;
    float* eb = de + static_cast<size_t>(cent) * k * C + lane;  // this lane's channel of slot 0
    float dct = 0.f;
    for (int s0 = 0; s0 < k; s0 += KB) {
      bool ok[KB];
      size_t qi[KB];
      float e0[KB], dy1[KB];
      load_slots<C, KB>(q, pb, ib, mb, s0, k, ct, ok, qi, e0);
      if constexpr (TWO) {
        float du[KB];
#pragma unroll
        for (int u = 0; u < KB; ++u) du[u] = __fadd_rn(__fmul_rn(fmaxf(e0[u], 0.f), p.a1), p.c1);
        stage_rows<C, KB>(mine, du, lane, gm);  // the y1 rows
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          const float uu = __fadd_rn(row_dot<C>(mine + u * C, p.w2c), p.b2);
          du[u] = bn_relu_bwd(aw == s0 + u ? g : 0.f, fmaxf(uu, 0.f), uu, p.m2, p.inv_s2, p.gos2,
                              p.s1n2, p.s2n2);
        }
        __syncwarp(gm);  // the y1 rows are read
        stage_rows<C, KB>(mine, du, lane, gm);
#pragma unroll
        for (int u = 0; u < KB; ++u) dy1[u] = row_dot<C>(mine + u * C, p.w2r);
        __syncwarp(gm);  // the du rows are read before the next batch writes
      } else {
#pragma unroll
        for (int u = 0; u < KB; ++u) dy1[u] = aw == s0 + u ? g : 0.f;
      }
#pragma unroll
      for (int u = 0; u < KB; ++u) {
        const float d = bn_relu_bwd(dy1[u], fmaxf(e0[u], 0.f), e0[u], p.m1, p.inv_s1, p.gos1,
                                    p.s1n1, p.s2n1);
        const float de0 = ok[u] ? d : 0.f;
        dct = __fsub_rn(dct, de0);  // - 0 leaves dct's bits as they are
        if (s0 + u < k) eb[static_cast<size_t>(s0 + u) * C] = de0;  // a row of C1: coalesced
      }
    }
    dcterm[o] = dct;
  }
}

// dq of bwd2 from its edge buffer de (B, C, K, C1), owner computes. Slot j
// of the grouped selection only picks points of group j (g = ceil(N/K)
// consecutive points, csrc/ball_query.cu), so block (j, b) owns group j of
// cloud b, reads slot j of every centroid and is the only writer of its
// points' rows. A counting sort by point, stable in c: warp w takes the
// w-th span of the centroids, loads their slot-j ids (a masked slot, or an
// id outside the group, is skipped) and counts them by point (shared int
// atomics: a count has no order); a thread a point turns the warps' counts
// into each warp's offset within the point's list, a scan of the totals
// gives the lists' starts, and each warp places its span in increasing c
// (rank among 32 at a time by __match_any_sync), so a list holds its
// centroids in increasing c. A group of C1 lanes (lane = channel) then
// takes a point and adds its list's de0 rows (one coalesced row each, kDqB
// loads in flight) to 0 in that order with __fadd_rn, and stores the row
// once, zeros included: one order of sums for any launch
// (cuda_kernels.sa_train_dq_ordered_plain). It reads each valid edge's row
// once, where a gather over all pairs re-reads the ids for each tile.
template <int C>
__global__ void __launch_bounds__(kThreads)
sa_train_dq_kernel(const float* __restrict__ de, const int* __restrict__ idx,
                   const bool* __restrict__ mask, float* __restrict__ dq, int n, int c, int k,
                   int g) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ int dsm[];
  const int j = blockIdx.x, b = blockIdx.y;
  const int first = j * g;
  const int gs = max(0, min(g, n - first));  // the group's points
  int* key = dsm;                  // c: the centroid's point in the group, or -1
  int* cur = key + c;              // kWarps x gs: a warp's counts, then its cursors
  int* start = cur + kWarps * gs;  // gs + 1: where each point's list begins
  int* list = start + gs + 1;      // c: the centroids, by point, in increasing c
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = (c + kWarps - 1) / kWarps;
  const int c_lo = min(c, warp * span), c_hi = min(c, c_lo + span);
  int* mine = cur + warp * gs;
  for (int e = tid; e < kWarps * gs; e += kThreads) cur[e] = 0;
  if (tid == 0) start[0] = 0;
  __syncthreads();
  const size_t e0 = static_cast<size_t>(b) * c * k + j;  // edge (b, 0, j)
  for (int cc = c_lo + lane; cc < c_hi; cc += 32) {
    const size_t e = e0 + static_cast<size_t>(cc) * k;
    const int d = mask[e] ? idx[e] - first : -1;
    const bool in = d >= 0 && d < gs;
    key[cc] = in ? d : -1;
    if (in) atomicAdd(mine + d, 1);
  }
  __syncthreads();
  for (int p = tid; p < gs; p += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int x = cur[w * gs + p];
      cur[w * gs + p] = run;
      run += x;
    }
    start[p + 1] = run;
  }
  __syncthreads();
  if (warp == 0) {  // start[p + 1] = the picks of points 0 .. p
    int carry = 0;
    for (int p0 = 0; p0 < gs; p0 += 32) {
      const int v = p0 + lane < gs ? start[p0 + lane + 1] : 0;
      const int incl = warp_incl_scan(v, lane) + carry;
      if (p0 + lane < gs) start[p0 + lane + 1] = incl;
      carry = __shfl_sync(~0u, incl, 31);
    }
  }
  __syncthreads();
  for (int e = tid; e < kWarps * gs; e += kThreads) cur[e] += start[e % gs];
  __syncthreads();
  const unsigned lt = (1u << lane) - 1;
  for (int c0 = c_lo; c0 < c_hi; c0 += 32) {
    const int d = c0 + lane < c_hi ? key[c0 + lane] : -1;
    const unsigned act = __ballot_sync(~0u, d >= 0);
    if (d >= 0) {
      const unsigned peers = __match_any_sync(act, d);
      const int pos = mine[d] + __popc(peers & lt);
      list[pos] = c0 + lane;
      __syncwarp(act);  // every peer has read the cursor
      if (!(peers & lt)) mine[d] = pos + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  constexpr int kGroups = kThreads / C;
  const int ch = tid % C;
  const float* db = de + e0 * C + ch;  // channel ch of edge (b, 0, j)
  const size_t stride = static_cast<size_t>(k) * C;  // the next centroid's
  float* out = dq + (static_cast<size_t>(b) * n + first) * C + ch;
  for (int p = tid / C; p < gs; p += kGroups) {
    int r = start[p];
    const int end = start[p + 1];
    float acc = 0.f;
    for (; r + kDqB <= end; r += kDqB) {
      float v[kDqB];
#pragma unroll
      for (int u = 0; u < kDqB; ++u) v[u] = db[list[r + u] * stride];
#pragma unroll
      for (int u = 0; u < kDqB; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; r < end; ++r) acc = __fadd_rn(acc, db[list[r] * stride]);
    out[static_cast<size_t>(p) * C] = acc;
  }
}

// ---------------------------------------------------------------------------
// C entry points. q (b, n, ch), cterm (b, c, ch), idx (b, c, k) int32, mask
// (b, c, k) bool, aff (kAffRows, ch), w2 (ch, ch) or null, awin (b, c, ch)
// int32, gt (b, c, ch); `grid` blocks of kThreads threads. Instances:
// (ch, two layers) = (16, true), SA1, and (32, false), SA2; stats and bwd1
// run only with two layers.
// ---------------------------------------------------------------------------

// Lanes a centroid of the stats pass at ch channels: the wrapper's grid and
// the bound's summation depth follow them.
extern "C" int sa_train_stats_lanes(int ch) { return ch / kStatsV; }

extern "C" int sa_train_stats_launch(const float* q, const float* cterm, const int* idx,
                                     const bool* mask, const float* aff, float* partial,
                                     int grid, int b, int n, int c, int k, int ch,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch != 16) return cudaErrorInvalidValue;
  sa_train_stats_kernel<16, kStatsKB>
      <<<grid, kThreads, 0, st>>>(q, cterm, idx, mask, aff, partial, n, c, k, b * c);
  return cudaGetLastError();
}

extern "C" int sa_train_main_launch(const float* q, const float* cterm, const int* idx,
                                    const bool* mask, const float* aff, const float* w2,
                                    float* partial, float* vmax, float* vmin, int* amax,
                                    int* amin, int grid, int b, int n, int c, int k, int ch,
                                    int two_layer, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch == 16 && two_layer) {
    sa_train_main_kernel<16, true, kMainKB1><<<grid, kThreads, 0, st>>>(
        q, cterm, idx, mask, aff, w2, partial, vmax, vmin, amax, amin, n, c, k, b * c);
  } else if (ch == 32 && !two_layer) {
    sa_train_main_kernel<32, false, kMainKB2><<<grid, kThreads, 0, st>>>(
        q, cterm, idx, mask, aff, w2, partial, vmax, vmin, amax, amin, n, c, k, b * c);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int sa_train_bwd1_launch(const float* q, const float* cterm, const int* idx,
                                    const bool* mask, const float* aff, const float* w2,
                                    const int* awin, const float* gt, float* partial, int grid,
                                    int b, int n, int c, int k, int ch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch != 16) return cudaErrorInvalidValue;
  sa_train_bwd1_kernel<16, kBwd1KB><<<grid, kThreads, 0, st>>>(q, cterm, idx, mask, aff, w2,
                                                              awin, gt, partial, n, c, k, b * c);
  return cudaGetLastError();
}

// The edge pass into de (b, c, k, ch), then the dq pass: grid (k, b), one
// block a group of g = ceil(n / k) points, with the slot's keys and lists
// (c ints each), the warps' counts (8 g) and the lists' starts (g + 1) in
// shared memory; a c too large for it fails the launch.
extern "C" int sa_train_bwd2_launch(const float* q, const float* cterm, const int* idx,
                                    const bool* mask, const float* aff, const float* w2,
                                    const int* awin, const float* gt, float* de, float* dq,
                                    float* dcterm, int grid, int b, int n, int c, int k, int ch,
                                    int two_layer, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!((ch == 16 && two_layer) || (ch == 32 && !two_layer))) return cudaErrorInvalidValue;
  const int g = (n + k - 1) / k;
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(c) + (kThreads / 32 + 1) * g + 1);
  const dim3 dq_grid(k, b);
  cudaError_t err;
  if (two_layer) {
    err = allow_smem(sa_train_dq_kernel<16>, smem);
    if (err != cudaSuccess) return err;
    sa_train_bwd2_kernel<16, true, kBwd2KB1><<<grid, kThreads, 0, st>>>(
        q, cterm, idx, mask, aff, w2, awin, gt, de, dcterm, n, c, k, b * c);
    sa_train_dq_kernel<16><<<dq_grid, kThreads, smem, st>>>(de, idx, mask, dq, n, c, k, g);
  } else {
    err = allow_smem(sa_train_dq_kernel<32>, smem);
    if (err != cudaSuccess) return err;
    sa_train_bwd2_kernel<32, false, kBwd2KB2><<<grid, kThreads, 0, st>>>(
        q, cterm, idx, mask, aff, w2, awin, gt, de, dcterm, n, c, k, b * c);
    sa_train_dq_kernel<32><<<dq_grid, kThreads, smem, st>>>(de, idx, mask, dq, n, c, k, g);
  }
  return cudaGetLastError();
}

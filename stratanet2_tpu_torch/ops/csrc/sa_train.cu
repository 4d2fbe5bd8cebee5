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
// over: Hopper gathers q rows with indexed loads and scatters dq with atomics.
//
// Bound on the H100: operations, not bytes. A pass reads q, cterm, idx and
// mask once (SA1 of the PROD train step: 12.8 + 3.2 + 6.4 + 1.6 MB) while
// every valid edge costs 6*C1 operations in layer 1 and, with two layers,
// 2*C1*C2 more for each 16x16 product (forward in every pass, transposed and
// outer products in the backward). The random q rows (64 or 128 B) come from
// L2: q is 12.8 MB at SA1 and 6.4 MB at SA2.
//
// Design: lane = channel. A group of C1 lanes (a half-warp at SA1, C1 =
// C2 = 16; a warp at SA2, C1 = 32) owns one centroid at a time and walks its
// K slots in order. Each q row is one coalesced 64 or 128 B load. The 16x16
// layer-2 product: lane o holds column o of W2 and needs y1[i] of lane i; the
// transposed product of the backward: lane i holds row i of W2 and needs
// du[o] of lane o.
// - stats, main, bwd1: a slot with mask False is skipped by the whole group;
//   the products move y1[i] (du[o]) by __shfl_sync, one a term.
// - bwd2: the group takes kBatch slots at a time and computes every one (a
//   masked slot's values are dropped), so the batch's q rows load together
//   and the two halves of a warp never split on the mask; the products go
//   through shared memory: each lane writes its channel of the batch's y1
//   (then du) rows and reads each row back as C1/4 broadcast LDS.128, no
//   shuffle. On the H100 (PERF.md; scripts/kernel_variants.py) it
//   takes 0.151 ms at SA1 against 0.268 for the shuffle form, 0.046 at SA2
//   against 0.052; an edge a lane (a lane computes all 16 channels of its
//   edge, W2 and the table from the constant bank) measured 0.167 at SA1
//   and 0.075 at SA2, 0.251 and 0.121 with the q rows staged through
//   shared memory. Its slot loop issues 49 SASS a warp an edge at SA1 and
//   39 at SA2, no SHFL; 128 registers at SA1 (2 blocks an SM), 64 at SA2.
// Every per-edge value is computed with _rn intrinsics in the order of the
// plain versions (cuda_kernels.sa_train_edges:
// the products as fma chains in index order, no contraction elsewhere), so
// kernel and plain agree bit for bit on every edge value and on every winner
// slot; only the sums over edges differ, by the order of summation.
// Per-channel sums over edges (BN statistics, S1/S2, db2, dW2) are reduced
// over the groups of a block in a fixed order and written as one partial row
// per block; the wrapper sums the rows with torch, so two runs give the same
// bits. dq is a scatter over points: float atomicAdd into a zeroed buffer,
// sum order not fixed. 256 threads a block; the grid (given by the wrapper)
// is at most 8 blocks of 256 threads on each of 132 SMs, each group walking
// centroids with the grid's stride.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr float kNeg = -3.4e38f;  // masked slots enter the max as this, the min as -this

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

// u[o] = fma(y1[C-1], W2[C-1][o], ... fma(y1[1], W2[1][o], y1[0]*W2[0][o])) + b2[o]
// for lane o; y1[i] comes from lane i of the group.
template <int C>
__device__ __forceinline__ float layer2(unsigned gm, float y1, const float (&w2c)[C], float b2) {
  float s = __fmul_rn(__shfl_sync(gm, y1, 0, C), w2c[0]);
#pragma unroll
  for (int i = 1; i < C; ++i) s = __fmaf_rn(__shfl_sync(gm, y1, i, C), w2c[i], s);
  return __fadd_rn(s, b2);
}

// dy1[i] = sum_o W2[i][o] du[o] as the same fma chain over o, for lane i.
template <int C>
__device__ __forceinline__ float layer2_t(unsigned gm, float du, const float (&w2r)[C]) {
  float s = __fmul_rn(w2r[0], __shfl_sync(gm, du, 0, C));
#pragma unroll
  for (int o = 1; o < C; ++o) s = __fmaf_rn(w2r[o], __shfl_sync(gm, du, o, C), s);
  return s;
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
// backward terms, loaded once per thread.
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

// BN1 batch statistics: per-block partials of sum(h1 - shift1) and
// sum((h1 - shift1)^2) over the valid edges -> partial (grid, 2, C).
template <int C>
__global__ void __launch_bounds__(kThreads)
sa_train_stats_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                      const int* __restrict__ idx, const bool* __restrict__ mask,
                      const float* __restrict__ aff, float* __restrict__ partial, int n, int c,
                      int k, int total) {
  constexpr int kGroups = kThreads / C;
  const int lane = threadIdx.x % C;
  const float shift = aff[kShift1 * C + lane];
  float v[2] = {0.f, 0.f};
  for (int cent = blockIdx.x * kGroups + threadIdx.x / C; cent < total;
       cent += gridDim.x * kGroups) {
    const float* qb = q + static_cast<size_t>(cent / c) * n * C + lane;
    const float ct = cterm[static_cast<size_t>(cent) * C + lane];
    const int* ib = idx + static_cast<size_t>(cent) * k;
    const bool* mb = mask + static_cast<size_t>(cent) * k;
    for (int s = 0; s < k; ++s) {
      if (!mb[s]) continue;
      const float h1 = fmaxf(__fsub_rn(qb[static_cast<size_t>(ib[s]) * C], ct), 0.f);
      const float hc = __fsub_rn(h1, shift);
      v[0] = __fadd_rn(v[0], hc);
      v[1] = __fmaf_rn(hc, hc, v[1]);
    }
  }
  block_reduce<C, 2>(v, partial + static_cast<size_t>(blockIdx.x) * 2 * C);
}

// Statistics of the last layer's pre-BN h (shift shift_l) as partials
// (grid, 2, C), and per centroid and channel the masked max and min of h
// over the K slots with the first winning slot (strict > and <, slot order).
template <int C, bool TWO>
__global__ void __launch_bounds__(kThreads)
sa_train_main_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                     const int* __restrict__ idx, const bool* __restrict__ mask,
                     const float* __restrict__ aff, const float* __restrict__ w2,
                     float* __restrict__ partial, float* __restrict__ vmax_out,
                     float* __restrict__ vmin_out, int* __restrict__ amax_out,
                     int* __restrict__ amin_out, int n, int c, int k, int total) {
  constexpr int kGroups = kThreads / C;
  const int lane = threadIdx.x % C;
  const unsigned gm = group_mask<C>();
  const float shift = aff[kShiftL * C + lane];
  const LaneParams<C, TWO> p(aff, w2, lane);
  float v[2] = {0.f, 0.f};
  for (int cent = blockIdx.x * kGroups + threadIdx.x / C; cent < total;
       cent += gridDim.x * kGroups) {
    const float* qb = q + static_cast<size_t>(cent / c) * n * C + lane;
    const float ct = cterm[static_cast<size_t>(cent) * C + lane];
    const int* ib = idx + static_cast<size_t>(cent) * k;
    const bool* mb = mask + static_cast<size_t>(cent) * k;
    float vmax = kNeg, vmin = -kNeg;
    int amax = 0, amin = 0;
    for (int s = 0; s < k; ++s) {
      if (!mb[s]) continue;
      const float h1 = fmaxf(__fsub_rn(qb[static_cast<size_t>(ib[s]) * C], ct), 0.f);
      float h = h1;
      if constexpr (TWO) {
        h = fmaxf(layer2<C>(gm, __fadd_rn(__fmul_rn(h1, p.a1), p.c1), p.w2c, p.b2), 0.f);
      }
      const float hc = __fsub_rn(h, shift);
      v[0] = __fadd_rn(v[0], hc);
      v[1] = __fmaf_rn(hc, hc, v[1]);
      if (h > vmax) {
        vmax = h;
        amax = s;
      }
      if (h < vmin) {
        vmin = h;
        amin = s;
      }
    }
    const size_t o = static_cast<size_t>(cent) * C + lane;
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
template <int C>
__global__ void __launch_bounds__(kThreads)
sa_train_bwd1_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                     const int* __restrict__ idx, const bool* __restrict__ mask,
                     const float* __restrict__ aff, const float* __restrict__ w2,
                     const int* __restrict__ awin, const float* __restrict__ gt,
                     float* __restrict__ partial, int n, int c, int k, int total) {
  constexpr int kGroups = kThreads / C;
  const int lane = threadIdx.x % C;
  const unsigned gm = group_mask<C>();
  const LaneParams<C, true> p(aff, w2, lane);
  float v[3 + C];
#pragma unroll
  for (int j = 0; j < 3 + C; ++j) v[j] = 0.f;
  for (int cent = blockIdx.x * kGroups + threadIdx.x / C; cent < total;
       cent += gridDim.x * kGroups) {
    const float* qb = q + static_cast<size_t>(cent / c) * n * C + lane;
    const size_t o = static_cast<size_t>(cent) * C + lane;
    const float ct = cterm[o];
    const int aw = awin[o];
    const float g = gt[o];
    const int* ib = idx + static_cast<size_t>(cent) * k;
    const bool* mb = mask + static_cast<size_t>(cent) * k;
    for (int s = 0; s < k; ++s) {
      if (!mb[s]) continue;
      const float h1 = fmaxf(__fsub_rn(qb[static_cast<size_t>(ib[s]) * C], ct), 0.f);
      const float y1 = __fadd_rn(__fmul_rn(h1, p.a1), p.c1);
      const float u = layer2<C>(gm, y1, p.w2c, p.b2);
      const float du = bn_relu_bwd(aw == s ? g : 0.f, fmaxf(u, 0.f), u, p.m2, p.inv_s2, p.gos2,
                                   p.s1n2, p.s2n2);
      v[2] = __fadd_rn(v[2], du);
#pragma unroll
      for (int i = 0; i < C; ++i) v[3 + i] = __fmaf_rn(__shfl_sync(gm, y1, i, C), du, v[3 + i]);
      const float dy1 = layer2_t<C>(gm, du, p.w2r);
      const float xhat1 = __fmul_rn(__fsub_rn(h1, p.m1), p.inv_s1);
      v[0] = __fadd_rn(v[0], dy1);
      v[1] = __fmaf_rn(dy1, xhat1, v[1]);
    }
  }
  block_reduce<C, 3 + C>(v, partial + static_cast<size_t>(blockIdx.x) * (3 + C) * C);
}

// BN1's backward at every valid edge through layer 1's ReLU: de0, then
// dq[b, idx] += de0 (float atomics into dq, zeroed by the launch) and
// dcterm = -sum over the K slots of de0. With two layers dy1 comes from
// BN2's backward as in bwd1; with one, dy1 is gt at the winner slot.
//
// Lane = channel as in the other passes, but the group takes its centroid's
// slots kBatch at a time, every slot of a batch computed (a masked slot's
// values are discarded): the batch's q rows are loaded together, the group
// never splits on the mask, and the batch gives kBatch independent chains.
// Two layers: each lane writes its channel of the batch's y1 rows (then du
// rows) to the group's rows in shared memory, and every lane reads a row
// back as C/4 broadcast LDS.128, in place of C __shfl_sync a product.
// kBatch 4 (SA1) and 8 (SA2) measured best of 2, 4, 8 and 4, 8, 16 (PERF.md).
template <int C, bool TWO>
__global__ void __launch_bounds__(kThreads)
sa_train_bwd2_kernel(const float* __restrict__ q, const float* __restrict__ cterm,
                     const int* __restrict__ idx, const bool* __restrict__ mask,
                     const float* __restrict__ aff, const float* __restrict__ w2,
                     const int* __restrict__ awin, const float* __restrict__ gt,
                     float* __restrict__ dq, float* __restrict__ dcterm, int n, int c, int k,
                     int total) {
  constexpr int kGroups = kThreads / C;
  constexpr int kBatch = TWO ? 4 : 8;
  __shared__ __align__(16) float rows[TWO ? kGroups * kBatch * C : 4];
  const int lane = threadIdx.x % C;
  const unsigned gm = group_mask<C>();
  const LaneParams<C, TWO> p(aff, w2, lane);
  float* mine = rows + (TWO ? (threadIdx.x / C) * kBatch * C : 0);
  for (int cent = blockIdx.x * kGroups + threadIdx.x / C; cent < total;
       cent += gridDim.x * kGroups) {
    const size_t pb = static_cast<size_t>(cent / c) * n * C + lane;
    const size_t o = static_cast<size_t>(cent) * C + lane;
    const float ct = cterm[o];
    const int aw = awin[o];
    const float g = gt[o];
    const int* ib = idx + static_cast<size_t>(cent) * k;
    const bool* mb = mask + static_cast<size_t>(cent) * k;
    float dct = 0.f;
    for (int s0 = 0; s0 < k; s0 += kBatch) {
      bool ok[kBatch];
      size_t qi[kBatch];
      float e0[kBatch], dy1[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        ok[u] = s0 + u < k && mb[s0 + u];
        qi[u] = pb + static_cast<size_t>(ok[u] ? ib[s0 + u] : 0) * C;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) e0[u] = __fsub_rn(q[qi[u]], ct);
      if constexpr (TWO) {
        float du[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          mine[u * C + lane] = __fadd_rn(__fmul_rn(fmaxf(e0[u], 0.f), p.a1), p.c1);  // y1
        __syncwarp(gm);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {  // u = y1 @ W2[:, lane] + b2, the fma chain over i
          const float4* r = reinterpret_cast<const float4*>(mine + u * C);
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < C / 4; ++m) {
            const float4 y = r[m];
            acc = m == 0 ? __fmul_rn(y.x, p.w2c[0]) : __fmaf_rn(y.x, p.w2c[4 * m], acc);
            acc = __fmaf_rn(y.y, p.w2c[4 * m + 1], acc);
            acc = __fmaf_rn(y.z, p.w2c[4 * m + 2], acc);
            acc = __fmaf_rn(y.w, p.w2c[4 * m + 3], acc);
          }
          const float uu = __fadd_rn(acc, p.b2);
          du[u] = bn_relu_bwd(aw == s0 + u ? g : 0.f, fmaxf(uu, 0.f), uu, p.m2, p.inv_s2, p.gos2,
                              p.s1n2, p.s2n2);
        }
        __syncwarp(gm);  // the y1 rows are read
#pragma unroll
        for (int u = 0; u < kBatch; ++u) mine[u * C + lane] = du[u];
        __syncwarp(gm);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {  // dy1 = du @ W2[lane, :]^T, the fma chain over o
          const float4* r = reinterpret_cast<const float4*>(mine + u * C);
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < C / 4; ++m) {
            const float4 d = r[m];
            acc = m == 0 ? __fmul_rn(p.w2r[0], d.x) : __fmaf_rn(p.w2r[4 * m], d.x, acc);
            acc = __fmaf_rn(p.w2r[4 * m + 1], d.y, acc);
            acc = __fmaf_rn(p.w2r[4 * m + 2], d.z, acc);
            acc = __fmaf_rn(p.w2r[4 * m + 3], d.w, acc);
          }
          dy1[u] = acc;
        }
        __syncwarp(gm);  // the du rows are read before the next batch writes
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) dy1[u] = aw == s0 + u ? g : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!ok[u]) continue;  // the same for the whole group
        const float de0 = bn_relu_bwd(dy1[u], fmaxf(e0[u], 0.f), e0[u], p.m1, p.inv_s1, p.gos1,
                                      p.s1n1, p.s2n1);
        dct = __fsub_rn(dct, de0);
        if (de0 != 0.f) atomicAdd(dq + qi[u], de0);
      }
    }
    dcterm[o] = dct;
  }
}

// ---------------------------------------------------------------------------
// C entry points. q (b, n, ch), cterm (b, c, ch), idx (b, c, k) int32, mask
// (b, c, k) bool, aff (kAffRows, ch), w2 (ch, ch) or null, awin (b, c, ch)
// int32, gt (b, c, ch); `grid` blocks of kThreads threads. Instances:
// (ch, two layers) = (16, true), SA1, and (32, false), SA2; stats and bwd1
// run only with two layers.
// ---------------------------------------------------------------------------

extern "C" int sa_train_stats_launch(const float* q, const float* cterm, const int* idx,
                                     const bool* mask, const float* aff, float* partial,
                                     int grid, int b, int n, int c, int k, int ch,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch != 16) return cudaErrorInvalidValue;
  sa_train_stats_kernel<16><<<grid, kThreads, 0, st>>>(q, cterm, idx, mask, aff, partial, n, c,
                                                      k, b * c);
  return cudaGetLastError();
}

extern "C" int sa_train_main_launch(const float* q, const float* cterm, const int* idx,
                                    const bool* mask, const float* aff, const float* w2,
                                    float* partial, float* vmax, float* vmin, int* amax,
                                    int* amin, int grid, int b, int n, int c, int k, int ch,
                                    int two_layer, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch == 16 && two_layer) {
    sa_train_main_kernel<16, true><<<grid, kThreads, 0, st>>>(
        q, cterm, idx, mask, aff, w2, partial, vmax, vmin, amax, amin, n, c, k, b * c);
  } else if (ch == 32 && !two_layer) {
    sa_train_main_kernel<32, false><<<grid, kThreads, 0, st>>>(
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
  sa_train_bwd1_kernel<16><<<grid, kThreads, 0, st>>>(q, cterm, idx, mask, aff, w2, awin, gt,
                                                     partial, n, c, k, b * c);
  return cudaGetLastError();
}

extern "C" int sa_train_bwd2_launch(const float* q, const float* cterm, const int* idx,
                                    const bool* mask, const float* aff, const float* w2,
                                    const int* awin, const float* gt, float* dq, float* dcterm,
                                    int grid, int b, int n, int c, int k, int ch, int two_layer,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!((ch == 16 && two_layer) || (ch == 32 && !two_layer))) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(dq, 0, sizeof(float) * b * static_cast<size_t>(n) * ch, st);
  if (err != cudaSuccess) return err;
  if (two_layer) {
    sa_train_bwd2_kernel<16, true><<<grid, kThreads, 0, st>>>(q, cterm, idx, mask, aff, w2, awin,
                                                             gt, dq, dcterm, n, c, k, b * c);
  } else {
    sa_train_bwd2_kernel<32, false><<<grid, kThreads, 0, st>>>(q, cterm, idx, mask, aff, w2,
                                                              awin, gt, dq, dcterm, n, c, k,
                                                              b * c);
  }
  return cudaGetLastError();
}

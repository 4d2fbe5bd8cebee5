// PR 16's design of csrc/sa_train.cu's windowed dq pass, kept as a variant
// and timed against the package's design by scripts/kernel_variants.py
// (`sa_train_bwd2`): grid (K, B), one block a group, which walks its group in
// windows of gp points and, for each, the centroids in windows of cc
// (PR 16's cuda_kernels.sa_train_dq_chunks, `pr16_dq_chunks` in the
// harness), in increasing c. Each window reads slot j's ids (K apart in idx)
// into shared-memory keys, counts and places them, and sums its lists into
// the points' rows, starting from the row that the previous centroid window
// stored: the same adds in the same order as one window, so the same bits
// as cuda_kernels.sa_train_dq_ordered_plain. Its shared memory is
// 4 (2 cc + 9 gp + 1) bytes.
//
// Built from this file alone: it includes csrc/sa_train.cu (nvcc -I csrc),
// so its library also holds the package's sa_train_bwd2_launch, and the
// harness times both entries in one process.
#include "sa_train.cu"

template <int C, bool CHUNKED>
__device__ __forceinline__ void dq_window_pr16(const float* __restrict__ de,
                                          const int* __restrict__ idx,
                                          const bool* __restrict__ mask, float* __restrict__ dq,
                                          int* dsm, int n, int c, int k, int j, int b, int first,
                                          int gs, int cb, int ce) {
  constexpr int kWarps = kThreads / 32;
  const int nc = ce - cb;
  int* key = dsm;                  // nc: the centroid's point in the window, or -1
  int* cur = key + nc;             // kWarps x gs: a warp's counts, then its cursors
  int* start = cur + kWarps * gs;  // gs + 1: where each point's list begins
  int* list = start + gs + 1;      // nc: the centroids, by point, in increasing c
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = (nc + kWarps - 1) / kWarps;
  const int c_lo = cb + min(nc, warp * span), c_hi = min(ce, c_lo + span);
  int* mine = cur + warp * gs;
  for (int e = tid; e < kWarps * gs; e += kThreads) cur[e] = 0;
  if (tid == 0) start[0] = 0;
  __syncthreads();
  const size_t e0 = static_cast<size_t>(b) * c * k + j;  // edge (b, 0, j)
  for (int cc = c_lo + lane; cc < c_hi; cc += 32) {
    const size_t e = e0 + static_cast<size_t>(cc) * k;
    const int d = mask[e] ? idx[e] - first : -1;
    const bool in = d >= 0 && d < gs;
    key[cc - cb] = in ? d : -1;
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
    const int d = c0 + lane < c_hi ? key[c0 + lane - cb] : -1;
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
    float acc = CHUNKED && cb > 0 ? out[static_cast<size_t>(p) * C] : 0.f;
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
  if (CHUNKED) __syncthreads();  // the next window reuses the shared memory
}

template <int C, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
sa_train_dq_pr16_kernel(const float* __restrict__ de, const int* __restrict__ idx,
                   const bool* __restrict__ mask, float* __restrict__ dq, int n, int c, int k,
                   int g, int gp, int cc) {
  extern __shared__ int dsm[];
  const int j = blockIdx.x, b = blockIdx.y;
  const int first = j * g;
  const int gs = max(0, min(g, n - first));  // the group's points
  if constexpr (!CHUNKED) {
    dq_window_pr16<C, false>(de, idx, mask, dq, dsm, n, c, k, j, b, first, gs, 0, c);
  } else {
    for (int p0 = 0; p0 < gs; p0 += gp)
      for (int c0 = 0; c0 < c; c0 += cc)
        dq_window_pr16<C, true>(de, idx, mask, dq, dsm, n, c, k, j, b, first + p0, min(gp, gs - p0),
                           c0, min(c, c0 + cc));
  }
}

// The package's edge pass, then this dq pass: sa_train_bwd2_launch's
// arguments as PR 16 took them (no keys or lists; windows of gp points and
// cc centroids).
template <int C, bool TWO, int KB>
cudaError_t launch_pr16(const float* q, const float* cterm, const int* idx, const bool* mask,
                        const float* aff, const float* w2, const int* awin, const float* gt,
                        float* de, float* dq, float* dcterm, int grid, int b, int n, int c,
                        int k, int gp, int cc, cudaStream_t st) {
  const int g = (n + k - 1) / k;
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(cc) + (kThreads / 32 + 1) * gp + 1);
  cudaError_t err = allow_smem(sa_train_dq_pr16_kernel<C, true>, smem);
  if (err != cudaSuccess) return err;
  sa_train_bwd2_kernel<C, TWO, KB><<<grid, kThreads, 0, st>>>(
      q, cterm, idx, mask, aff, w2, awin, gt, de, dcterm, n, c, k, b * c);
  sa_train_dq_pr16_kernel<C, true><<<dim3(k, b), kThreads, smem, st>>>(de, idx, mask, dq, n, c,
                                                                         k, g, gp, cc);
  return cudaGetLastError();
}

extern "C" int sa_train_bwd2_pr16_launch(const float* q, const float* cterm, const int* idx,
                                         const bool* mask, const float* aff, const float* w2,
                                         const int* awin, const float* gt, float* de, float* dq,
                                         float* dcterm, int grid, int b, int n, int c, int k,
                                         int ch, int two_layer, int gp, int cc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch == 16 && two_layer)
    return launch_pr16<16, true, kBwd2KB1>(q, cterm, idx, mask, aff, w2, awin, gt, de, dq,
                                           dcterm, grid, b, n, c, k, gp, cc, st);
  if (ch == 32 && !two_layer)
    return launch_pr16<32, false, kBwd2KB2>(q, cterm, idx, mask, aff, w2, awin, gt, de, dq,
                                            dcterm, grid, b, n, c, k, gp, cc, st);
  return cudaErrorInvalidValue;
}

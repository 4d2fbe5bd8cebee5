// Nearest fixed-K ball query: per centroid, the k points of least expanded
// d2 within the radius, in ascending order of (d2, index); slots past the
// in-radius count give idx 0 and mask 0.
//
// Replaces: the selection of stratanet2_tpu/ops/ballquery.py::
// _ball_query_single (:104-138, `method="nearest"`), which scores the same
// d2 and takes jax.lax.approx_min_k of it in XLA (no Pallas kernel; on a
// TPU over bf16 scores). It computes what the plain
// stratanet2_tpu_torch/ops/ballquery.py::ball_query_nearest computes: exact
// float32 distances, rounded as XLA rounds them (common.cuh), and a stable
// order by (d2, index).
//
// Keys: a candidate is the 64-bit key (bits(d2) << 32) | index. The bit
// patterns of non-negative floats order like their values, so the keys
// order by (d2, index) exactly and are distinct. The sign bit is cleared
// first: a -0.0 would otherwise sort after every positive distance.
//
// Bound on the H100: instruction issue. Each centroid scores every point of
// its cloud (20 x 2500 x 10000 = 5.0e8 pairs at SA1 of a PROD step, 3.1e7
// at SA2), while the bytes are a few MB of positions and indices; the
// selection itself runs only on candidates, which the running k-th key
// keeps rare once the list is full.
//
// Design, simple first: one warp a centroid, 8 warps a block, all of one
// cloud. The block stages its cloud in tiles of kNearTile points as float4
// [x, y, z, |p|^2] in shared memory (one read of the cloud from memory a
// block, not a warp), and each warp scans a tile 32 points at a time, a
// point a lane. A lane whose point is within the radius and whose key is
// below the warp's running k-th key appends it to the warp's buffer of 32
// (ballot and prefix count); a full buffer is merged into the warp's
// sorted top-k list in shared memory (merge_top: each key's rank in the
// union is its rank among the list plus its rank among the buffer, so every
// key goes to its place in one pass and the list stays sorted). The k-th key
// is re-read after each merge. k <= kNearMaxK.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phases 17a
// and 16): 0.95 ms a nearest serve step (SA1 0.84, SA2 0.11), 3.3x the
// issue floor of its scan loop (18 SASS a pair that inserts nothing, against
// the grouped query's 10.6); 48 registers, no spills. Faster designs
// (several centroids a warp, spatial culling) are later work (PERF.md).
#include "common.cuh"

constexpr int kNearWarps = 8;
constexpr int kNearThreads = 32 * kNearWarps;
constexpr int kNearTile = 1024;  // points staged a round: 16 KB
constexpr int kNearMaxK = 128;   // cuda_kernels.NEAREST_MAX_K
constexpr int kNearBuf = 32;     // candidates a warp holds before it merges
constexpr unsigned long long kNone = ~0ull;  // above every key: an empty slot

// Merge the `cnt` unsorted keys of `buf` into the sorted list `top` of k
// keys (empty slots kNone, at the end), keeping the k least. Keys are
// distinct, so the rank of a key in the union is unique: list key i goes
// to i + #(buffer keys below it), buffer key s to #(list keys below it) +
// #(buffer keys below it). Every place < k is written once: the empty slots
// of the list, each with all cnt buffer keys below it, fill the places past
// the real keys. Not inlined, so that the scan loop stays one loop.
__device__ __noinline__ void merge_top(unsigned long long* top, const unsigned long long* buf,
                                       int cnt, int k, int lane) {
  constexpr int kPer = kNearMaxK / 32;
  const unsigned long long s = lane < cnt ? buf[lane] : kNone;
  unsigned long long e[kPer];
  int re[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    e[q] = i < k ? top[i] : kNone;
    re[q] = 0;
  }
  int rs = 0;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const unsigned long long u = __shfl_sync(~0u, s, t);
    rs += u < s;
#pragma unroll
    for (int q = 0; q < kPer; ++q) re[q] += u < e[q];
  }
  int pos = 0;  // list keys below s: a binary search of the sorted list
#pragma unroll
  for (int step = kNearMaxK; step >= 1; step >>= 1) {
    if (pos + step <= k && top[pos + step - 1] < s) pos += step;
  }
  __syncwarp();  // every lane has read the list
  if (lane < cnt && pos + rs < k) top[pos + rs] = s;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = lane + 32 * q;
    if (i < k && i + re[q] < k) top[i + re[q]] = e[q];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kNearThreads)
ball_query_nearest_kernel(const float* __restrict__ cent, const float* __restrict__ xyz,
                          int* __restrict__ idx, uint8_t* __restrict__ mask, int n, int c,
                          int k, float r2) {
  extern __shared__ unsigned long long smem[];  // per warp: top[k], buf[32]; then the tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int ci = blockIdx.x * kNearWarps + warp;
  const bool live = ci < c;  // a warp past the end scans (the block's barriers) and writes nothing
  unsigned long long* top = smem + static_cast<size_t>(warp) * (k + kNearBuf);
  unsigned long long* buf = top + k;
  float4* tile = reinterpret_cast<float4*>(smem + static_cast<size_t>(kNearWarps) * (k + kNearBuf));

  const float* cp = cent + (static_cast<size_t>(b) * c + min(ci, c - 1)) * 3;
  const float cx = cp[0], cy = cp[1], cz = cp[2];
  const float cn = sq3_rn(cx, cy, cz);
  for (int i = lane; i < k; i += 32) top[i] = kNone;
  __syncwarp();
  unsigned long long kth = kNone;  // the list's k-th key, warp-uniform
  int cnt = 0;                     // keys in buf, warp-uniform
  const float* xb = xyz + static_cast<size_t>(b) * n * 3;
  const unsigned below = (1u << lane) - 1;

  for (int t0 = 0; t0 < n; t0 += kNearTile) {
    const int tn = min(kNearTile, n - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < tn; j += kNearThreads) {
      const float* p = xb + 3 * static_cast<size_t>(t0 + j);
      const float x = p[0], y = p[1], z = p[2];
      tile[j] = make_float4(x, y, z, sq3_rn(x, y, z));
    }
    __syncthreads();
    for (int j0 = 0; j0 < tn; j0 += 32) {
      const int j = j0 + lane;
      unsigned long long key = kNone;
      if (j < tn) {
        const float4 p = tile[j];
        const float d2 = expanded_d2_sel(cn, dot3_rn(cx, cy, cz, p.x, p.y, p.z), p.w);
        if (d2 <= r2) {
          key = (static_cast<unsigned long long>(__float_as_uint(d2) & 0x7fffffffu) << 32) |
                static_cast<unsigned>(t0 + j);
        }
      }
      bool want = key < kth;
      unsigned ballot = __ballot_sync(~0u, want);
      if (ballot == 0) continue;
      if (cnt + __popc(ballot) > kNearBuf) {
        merge_top(top, buf, cnt, k, lane);
        cnt = 0;
        kth = top[k - 1];
        want = key < kth;
        ballot = __ballot_sync(~0u, want);
      }
      if (want) buf[cnt + __popc(ballot & below)] = key;
      cnt += __popc(ballot);
      __syncwarp();
    }
  }
  if (cnt > 0) merge_top(top, buf, cnt, k, lane);
  if (!live) return;
  int* ib = idx + (static_cast<size_t>(b) * c + ci) * k;
  uint8_t* mb = mask + (static_cast<size_t>(b) * c + ci) * k;
  for (int i = lane; i < k; i += 32) {
    const unsigned long long key = top[i];
    const bool ok = key != kNone;
    ib[i] = ok ? static_cast<int>(key & 0xffffffffu) : 0;
    mb[i] = ok ? 1 : 0;
  }
}

// cent (b, c, 3), xyz (b, n, 3) -> idx (b, c, k) i32, mask (b, c, k) u8
// (a torch.bool tensor); 1 <= k <= min(n, kNearMaxK).
extern "C" int ball_query_nearest_launch(const float* cent, const float* xyz, int* idx,
                                         uint8_t* mask, int b, int n, int c, int k, float r2,
                                         void* stream) {
  const size_t smem = sizeof(unsigned long long) * kNearWarps * static_cast<size_t>(k + kNearBuf) +
                      sizeof(float4) * kNearTile;
  cudaError_t err = allow_smem(ball_query_nearest_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kNearWarps - 1) / kNearWarps, b);
  ball_query_nearest_kernel<<<grid, kNearThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cent, xyz, idx, mask, n, c, k, r2);
  return cudaGetLastError();
}

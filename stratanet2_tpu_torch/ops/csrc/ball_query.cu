// Grouped fixed-K ball query: per centroid and per group of g = ceil(N/K)
// consecutive points, the nearest point within the radius.
//
// Replaces: stratanet2_tpu/ops/pallas_kernels.py::_bq_kernel (pallas_call in
// ball_query_grouped_pallas), which the JAX train path runs once per SA
// stage. It computes what the JAX XLA path _ball_query_grouped
// (stratanet2_tpu/ops/ballquery.py:71-101) and the plain
// stratanet2_tpu_torch/ops/ballquery.py::ball_query_grouped compute: the
// first point of least expanded d2 in each group (rounded as XLA rounds it,
// common.cuh), valid iff d2 <= r^2; a ragged last group is searched over
// its real points only; an empty group, or one with no point within the
// radius, gives idx 0 and mask 0. The TPU kernel's hi/lo-bf16 13-wide
// distance dot, poisoned pad rows and (K, C) "kc" output layout are not
// carried over: the output is (B, C, K), the layout of the plain version.
//
// Bound on the H100: arithmetic. Each centroid scores every point of its
// cloud (~10 operations per pair: 5e8 pairs at SA1 of the PROD train step,
// 3.1e7 at SA2), while the bytes are a few MB of positions and indices.
//
// Design: one block per (cloud, tile of 128 centroids), one thread per
// centroid. The block walks the K groups; each group's x, y, z, |p|^2 are
// staged in shared memory (SA1: 313 x 16 B) and read by all threads as
// broadcasts, so device memory is read once per block. The pick is
// common.cuh's group_nearest, the loop the fused SA eval kernel runs too.
#include "common.cuh"

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ cent, const float* __restrict__ xyz,
                  int* __restrict__ idx, uint8_t* __restrict__ mask, int n, int c, int k,
                  int g, float r2) {
  extern __shared__ float smem[];
  float* gx = smem;
  float* gy = gx + g;
  float* gz = gy + g;
  float* gn = gz + g;

  const int b = blockIdx.y;
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = ci < c;
  const size_t row = static_cast<size_t>(b) * c + (active ? ci : 0);
  const float cx = cent[row * 3], cy = cent[row * 3 + 1], cz = cent[row * 3 + 2];
  const float cn = sq3_rn(cx, cy, cz);
  int* ib = idx + row * k;
  uint8_t* mb = mask + row * k;

  const float* xb = xyz + static_cast<size_t>(b) * n * 3;
  for (int grp = 0; grp < k; ++grp) {
    const int first = grp * g;
    const int cnt = max(0, min(g, n - first));  // ragged or empty last groups
    __syncthreads();  // the previous group's tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const float x = xb[3 * (first + j)];
      const float y = xb[3 * (first + j) + 1];
      const float z = xb[3 * (first + j) + 2];
      gx[j] = x;
      gy[j] = y;
      gz[j] = z;
      gn[j] = sq3_rn(x, y, z);
    }
    __syncthreads();
    if (!active) continue;
    float dmin;
    int jmin;
    group_nearest(cx, cy, cz, cn, gx, gy, gz, gn, cnt, dmin, jmin);
    const bool ok = dmin <= r2;
    ib[grp] = ok ? first + jmin : 0;
    mb[grp] = ok ? 1 : 0;
  }
}

// cent (b, c, 3), xyz (b, n, 3) -> idx (b, c, k) i32, mask (b, c, k) u8
// (a torch.bool tensor); g = ceil(n / k).
extern "C" int ball_query_launch(const float* cent, const float* xyz, int* idx,
                                 uint8_t* mask, int b, int n, int c, int k, int g,
                                 float r2, void* stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(g);
  cudaError_t err = allow_smem(ball_query_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kThreads - 1) / kThreads, b);
  ball_query_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cent, xyz, idx, mask, n, c, k, g, r2);
  return cudaGetLastError();
}

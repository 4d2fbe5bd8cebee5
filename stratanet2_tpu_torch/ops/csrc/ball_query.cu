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
// Bound on the H100: instruction issue. Each centroid scores every point of
// its cloud, 20 x 2500 x 10000 = 5.0e8 pairs at SA1 of the PROD train step
// and 20 x 625 x 2500 = 3.1e7 at SA2, while the bytes are a few MB of
// positions and indices. The selection loop (common.cuh's group_nearest,
// unrolled 8 points x 2 centroids) is 161 SASS instructions for 16 pairs,
// 10.06 a pair (cuobjdump -sass on the card, chip_smoke.py's
// "selection_floor" phase): 5 FP32 (FMUL, 2 FFMA for c.p, FFMA for
// |c|^2 - 2 c.p, FADD of |p|^2), 3.75 compare/select (FMNMX clamp, FSETP,
// FSEL, SEL, some predicated), 0.5 LDS.128 and 0.8 of loop control. At one
// instruction a lane a cycle on 132 SMs x 128 lanes at 1980 MHz that is
// 0.160 ms a train step, the issue floor.
//
// Design (the selection is common.cuh's select_tile, shared with
// sa_fused_eval.cu): one block of 8 warps per (tile of 64 centroids, chunk of
// 8 groups, cloud), since a (centroid, group) output depends on nothing
// else; warp w of a block takes group 8 * chunk + w, stages it packed as
// float4 in its own slice of shared memory (no block barrier) and scans it
// with 2 centroids a lane, so one broadcast load of a point feeds two
// independent chains. ptxas: 40 registers, no spills.
//   SA1: grid (40 tiles x 4 chunks, 20) = 3200 blocks of 40 KB shared
//        memory; 5 blocks (40 warps) an SM; 24.2 blocks a SM in all, so the
//        last round leaves at most one block's imbalance (~4%).
//   SA2: grid (10 x 8, 20) = 1600 blocks of 5 KB; 6 blocks (48 warps) an SM
//        by registers; 12.1 blocks a SM.
// Measured on an H100 (chip_smoke.py's train profile, device ms a step):
// all K groups a block (grid (40, 20), the SA kernel's layout) 0.283 against
// 0.250; 4 centroids a lane (tiles of 128: 9.59 instructions a pair) 0.250,
// no gain; the staging's loads batched 4 points a lane 0.250 against 0.246
// one at a time. None is kept (PERF.md).
#include "common.cuh"

__global__ void __launch_bounds__(kSelThreads)
ball_query_kernel(const float* __restrict__ cent, const float* __restrict__ xyz,
                  int* __restrict__ idx, uint8_t* __restrict__ mask, int n, int c, int k,
                  int g, float r2) {
  extern __shared__ float4 stage[];
  const int b = blockIdx.y;
  const int tiles = (c + kSelTile - 1) / kSelTile;
  const int c0 = (blockIdx.x % tiles) * kSelTile, grp0 = (blockIdx.x / tiles) * kSelWarps;
  int* ib = idx + static_cast<size_t>(b) * c * k;
  uint8_t* mb = mask + static_cast<size_t>(b) * c * k;
  select_tile(cent + static_cast<size_t>(b) * c * 3, xyz + static_cast<size_t>(b) * n * 3, n, c,
              c0, grp0, min(grp0 + kSelWarps, k), g, r2, stage,
              [&](int ci, int grp, bool ok, int pick) {
                const size_t o = static_cast<size_t>(ci) * k + grp;
                ib[o] = ok ? pick : 0;
                mb[o] = ok ? 1 : 0;
              });
}

// cent (b, c, 3), xyz (b, n, 3) -> idx (b, c, k) i32, mask (b, c, k) u8
// (a torch.bool tensor); g = ceil(n / k).
extern "C" int ball_query_launch(const float* cent, const float* xyz, int* idx,
                                 uint8_t* mask, int b, int n, int c, int k, int g,
                                 float r2, void* stream) {
  const size_t smem = sizeof(float4) * kSelWarps * static_cast<size_t>(g);
  cudaError_t err = allow_smem(ball_query_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kSelTile - 1) / kSelTile * ((k + kSelWarps - 1) / kSelWarps), b);
  ball_query_kernel<<<grid, kSelThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cent, xyz, idx, mask, n, c, k, g, r2);
  return cudaGetLastError();
}

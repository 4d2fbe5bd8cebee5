// Designs of csrc/pixel_max.cu's tables past one block's shared memory
// without clusters, timed against the package's design by
// scripts/kernel_variants.py (`pixel_max`): the table cut into slices of
// pixels, a block a (slice, cloud), each block reading every id of its
// cloud (kBatch a thread at once, independent loads in flight), keeping
// the points of its own slice and taking them into its slice with
// shared-memory atomics, then decoding it. pixel_max_slice_launch: the
// 64-bit keys of the one-block kernel (a compare-and-swap loop each);
// pixel_max_owner2_launch: two passes of 32-bit atomics, the max of
// order_key(v) per slot, then the least index among the points that reach
// it. No distributed shared memory and no cluster barrier, but the ids are
// read once a slice, and a slice holding a hot pixel holds its points.
//
// Built from this file alone: it includes csrc/pixel_max.cu (nvcc -I csrc).
#include "pixel_max.cu"

constexpr int kBatch = 8;  // ids a thread loads at once

// A table past one block's shared memory: a block a (slice, cloud) of grid
// (slices, b), block x owning the own = ceil(p2 / slices) pixels from x own
// (its table own c keys). Every block reads all of its cloud's ids, kBatch
// a thread at a time (independent loads in flight), keeps the points of its
// slice and takes their keys into its table, then decodes it.
__global__ void __launch_bounds__(kThreads)
pixel_max_slice_kernel(const int* __restrict__ pix, const float* __restrict__ vals,
                       float* __restrict__ vmax, int* __restrict__ amax, int n, int p2, int c) {
  extern __shared__ unsigned long long slice[];
  const int t = threadIdx.x;
  const size_t b = blockIdx.y;
  const int own = (p2 + gridDim.x - 1) / gridDim.x, first = blockIdx.x * own;
  const int mine = max(0, min(own, p2 - first));  // pixels of this block's slice
  for (int i = t; i < mine * c; i += kThreads) slice[i] = 0ull;
  __syncthreads();
  const int* pb = pix + b * n;
  for (int base = 0; base < n; base += kBatch * kThreads) {
    int id[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + t;
      id[j] = i < n ? __ldg(pb + i) : -1;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (id[j] < first || id[j] >= first + mine) continue;
      const int i = base + j * kThreads + t, p = id[j] - first;
      const unsigned long long low = 0xFFFFFFFFull - static_cast<unsigned>(i);
      for (int ch = 0; ch < c; ++ch) {
        const float v = vals[(b * n + i) * c + ch];
        atomicMax(&slice[p * c + ch], (static_cast<unsigned long long>(order_key(v)) << 32) | low);
      }
    }
  }
  __syncthreads();
  const size_t o0 = (b * p2 + first) * c;
  for (int i = t; i < mine * c; i += kThreads) {
    const unsigned long long key = slice[i];
    if (key == 0ull) {  // every occupied slot has a non-zero index half
      vmax[o0 + i] = -3.4e38f;
      amax[o0 + i] = -1;
    } else {
      vmax[o0 + i] = order_value(static_cast<uint32_t>(key >> 32));
      amax[o0 + i] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    }
  }
}

// pix (b, n) i32, vals (b, n, c) f32 -> vmax (b, p2, c) f32, amax (b, p2, c)
// i32, `slices` blocks a cloud: 8 ceil(p2 / slices) c bytes of shared memory
// a block, b <= 65535.
extern "C" int pixel_max_slice_launch(const int* pix, const float* vals, float* vmax, int* amax,
                                      int b, int n, int p2, int c, int slices, void* stream) {
  const size_t smem =
      static_cast<size_t>((p2 + slices - 1) / slices) * c * sizeof(unsigned long long);
  cudaError_t err = allow_smem(pixel_max_slice_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(slices, b);
  pixel_max_slice_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pix, vals, vmax, amax, n, p2, c);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
pixel_max_owner2_kernel(const int* __restrict__ pix, const float* __restrict__ vals,
                        float* __restrict__ vmax, int* __restrict__ amax, int n, int p2, int c,
                        int per) {
  extern __shared__ unsigned tab[];  // order keys [own c], then indices [own c]
  const int r = blockIdx.x;
  const size_t b = blockIdx.z;
  const int lo = blockIdx.y * per, cnt = min(per, p2 - lo);
  const int own = (per + kCS - 1) / kCS;
  const int first = lo + r * own, mine = max(0, min(own, cnt - r * own));
  unsigned* ord = tab;
  unsigned* idx = tab + own * c;
  for (int i = threadIdx.x; i < mine * c; i += kThreads) {
    ord[i] = 0u;
    idx[i] = 0xFFFFFFFFu;
  }
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {  // the maxima, then the least index reaching each
    for (int base = 0; base < n; base += kBatch * kThreads) {
      int id[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + threadIdx.x;
        id[j] = i < n ? __ldg(pix + b * n + i) : -1;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (id[j] < first || id[j] >= first + mine) continue;
        const int i = base + j * kThreads + threadIdx.x;
        for (int ch = 0; ch < c; ++ch) {
          const int slot = (id[j] - first) * c + ch;
          const unsigned key = order_key(vals[(b * n + i) * c + ch]);
          if (pass == 0) {
            atomicMax(&ord[slot], key);
          } else if (key == ord[slot]) {
            atomicMin(&idx[slot], static_cast<unsigned>(i));
          }
        }
      }
    }
    __syncthreads();
  }
  const size_t o0 = (b * p2 + first) * c;
  for (int i = threadIdx.x; i < mine * c; i += kThreads) {
    vmax[o0 + i] = ord[i] == 0u ? -3.4e38f : order_value(ord[i]);
    amax[o0 + i] = ord[i] == 0u ? -1 : static_cast<int>(idx[i]);
  }
}

// Ranges of `per` pixels, kCS slices of ceil(per / kCS) each, in two 32-bit passes.
extern "C" int pixel_max_owner2_launch(const int* pix, const float* vals, float* vmax, int* amax,
                                       int b, int n, int p2, int c, int per, void* stream) {
  const size_t smem = static_cast<size_t>((per + kCS - 1) / kCS) * c * 2 * sizeof(unsigned);
  cudaError_t err = allow_smem(pixel_max_owner2_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kCS, (p2 + per - 1) / per, b);
  pixel_max_owner2_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pix, vals, vmax, amax, n, p2, c, per);
  return cudaGetLastError();
}

// A design of csrc/pixel_max.cu's tables past one block's shared memory,
// kept as a variant and timed against the package's design by
// scripts/kernel_variants.py (`pixel_max`): the table spread over the
// cluster, block r owning 1/kCS of the pixels, each block zeroing only its
// own slice and sending each of its share of the points' keys to the owner
// block by `red.shared::cluster.max.u64`, then one cluster barrier and each
// block decoding its slice. On an H100 (sm_90a, CUDA 12.8) ptxas lowers
// that reduction to a branch on the address's space (QSPC): a
// compare-and-swap loop on the block's own shared memory (ATOMS.CAST.SPIN.64)
// or ATOM.E.MAX.64 on a peer's; the outputs then differed from the plain
// version's at the dense plots' table (P = 100, up to 2.0 in a maximum), and
// a launch took 0.114 ms against the ranges' 0.074 (PERF.md §6, row 6a).
//
// Built from this file alone: it includes csrc/pixel_max.cu (nvcc -I csrc).
#include "pixel_max.cu"

// The 32-bit shared::cluster address of the key at local shared address
// `local` in block `rank` of the cluster.
__device__ __forceinline__ unsigned peer_slot(unsigned local, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(local), "r"(rank));
  return a;
}

// The key at shared::cluster address `at` becomes max(key, v).
__device__ __forceinline__ void peer_max(unsigned at, unsigned long long v) {
  asm volatile("red.shared::cluster.max.u64 [%0], %1;" ::"r"(at), "l"(v) : "memory");
}

// Cluster (range, cloud) of grid (kCS, ranges, b): the pixels [lo, lo +
// cnt), lo = range x per, block r owning own = ceil(per / kCS) of them from
// lo + r own (the last blocks of a short range own fewer, or none).
__global__ void __cluster_dims__(kCS, 1, 1) __launch_bounds__(kThreads)
pixel_max_dsmem_kernel(const int* __restrict__ pix, const float* __restrict__ vals,
                        float* __restrict__ vmax, int* __restrict__ amax, int n, int p2, int c,
                        int per) {
  extern __shared__ unsigned long long slice[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.z;
  const int lo = blockIdx.y * per, cnt = min(per, p2 - lo);
  const int own = (per + kCS - 1) / kCS;
  const int mine = max(0, min(own, cnt - rank * own));  // pixels of this block's slice
  for (int i = threadIdx.x; i < mine * c; i += kThreads) slice[i] = 0ull;
  cluster.sync();  // every slice is zeroed before any peer's keys arrive
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(slice));
  const int share = (n + kCS - 1) / kCS;
  const int end = min(n, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < end; i += kThreads) {
    const int id = pix[b * n + i];
    if (id < lo || id >= lo + cnt) continue;
    const int p = id - lo, owner = p / own;
    const unsigned at = peer_slot(base + 8u * ((p - owner * own) * c), owner);
    const unsigned long long low = 0xFFFFFFFFull - static_cast<unsigned>(i);
    for (int ch = 0; ch < c; ++ch) {
      const float v = vals[(b * n + i) * c + ch];
      peer_max(at + 8u * ch, (static_cast<unsigned long long>(order_key(v)) << 32) | low);
    }
  }
  cluster.sync();  // every key has reached its slice
  const size_t o0 = (b * p2 + lo + static_cast<size_t>(rank) * own) * c;
  for (int i = threadIdx.x; i < mine * c; i += kThreads) {
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
// i32, the table spread over each cluster, in ranges of `per` pixels (the
// last may hold fewer): 8 * ceil(per / kCS) * c bytes of shared memory a
// block, b and the ranges <= 65535.
extern "C" int pixel_max_dsmem_launch(const int* pix, const float* vals, float* vmax,
                                       int* amax, int b, int n, int p2, int c, int per,
                                       void* stream) {
  const size_t smem = static_cast<size_t>((per + kCS - 1) / kCS) * c * sizeof(unsigned long long);
  cudaError_t err = allow_smem(pixel_max_dsmem_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kCS, (p2 + per - 1) / per, b);
  pixel_max_dsmem_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pix, vals, vmax, amax, n, p2, c, per);
  return cudaGetLastError();
}

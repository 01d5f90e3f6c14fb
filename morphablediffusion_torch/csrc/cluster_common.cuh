// Thread-block-cluster machinery shared by the depth-attention kernel (K3,
// depth_attention.cu), the GroupNorm kernel (K4, group_norm.cu) and the
// depth-context kernel's cluster design (K1, depth_attention_ctx_cluster.cu).
// K3 and K4 split one reduction across the blocks of a cluster, which read
// each other's partial sums through distributed shared memory (DSMEM) in a
// fixed order of ranks, so every block gets the same, deterministic total in
// one launch; K1's cluster design also writes into its peers' shared memory.
//
// * `cluster_arrive` / `cluster_wait`: the two halves of the cluster
//   barrier (release / acquire). A block arrives after writing its
//   partials and waits before reading its peers'; it arrives again once it
//   has read them and waits once more before it exits, because a block that
//   exits frees the shared memory its peers may still be reading.
// * `peer`: a peer block's copy of a shared-memory array
//   (cooperative_groups' `map_shared_rank`), to read or to write.
// * `cp_async16`: a 16-byte copy from device to shared memory that
//   occupies no register (`cp.async`); `cp_async_wait_all` waits for the
//   thread's own copies.
// * `peer_addr`, `bulk_copy_to_peer`: a peer's shared address (`mapa`) and
//   a copy of bytes from this block's shared memory into a peer's that
//   completes on the peer's mbarrier (`cp.async.bulk`, the async proxy).
// * `launch_cluster`: `cudaLaunchKernelEx` with the cluster's size as a
//   launch attribute (`__cluster_dims__` would fix it at compile time;
//   here it is chosen per shape). The grid must be a multiple of it; a size
//   above 8, the portable size, needs `allow_cluster16` first.
// * `max_active_clusters`: `cudaOccupancyMaxActiveClusters` for a plan.
//
// A source that includes this header is rebuilt when it changes
// (ops/_cuda.py hashes every *.cuh beside the sources).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"  // allow_smem, MAX_DEVICES, smem_u32

namespace {

namespace coop = cooperative_groups;

constexpr int MAX_CLUSTER = 8;             // the portable cluster size
constexpr int MAX_BLOCK_SMEM = 232448;     // 227 KB: the most a block may have

__host__ __device__ constexpr int up16(int bytes) { return (bytes + 15) / 16 * 16; }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T* peer(T* local, int rank) {
  return coop::this_cluster().map_shared_rank(local, rank);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

// The shared::cluster address of `addr` (this block's shared address) in
// the block of rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// `bytes` (a multiple of 16) from this block's shared address src to the
// shared::cluster address dst, completing as transferred bytes on the
// mbarrier at the shared::cluster address bar (in dst's block). The source
// must have been made visible to the async proxy (fence.proxy.async).
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, uint32_t src, int bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

inline cudaLaunchConfig_t cluster_config(unsigned blocks, int threads, int smem, int cluster,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow clusters of up to 16 blocks of `kernel` (the non-portable sizes),
// once per device; `done` is the caller's flags. Returns a refusal's error.
inline int allow_cluster16(const void* kernel, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES) done[dev] = true;
  return 0;
}

// Launch kernel<<<blocks, threads, smem, stream>>> in clusters of `cluster`
// blocks (a plain launch for 1). Returns the launch's error.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), unsigned blocks, int threads, int smem,
                   int cluster, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(blocks, threads, smem, cluster, stream, attr);
  if (cluster == 1) cfg.numAttrs = 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // read (and clear) either way
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// Clusters of `cluster` blocks of this kernel, at `smem` bytes a block,
// that the device holds at once; minus the CUDA error if the query fails.
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), int threads, int smem, int cluster) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(static_cast<unsigned>(cluster), threads, smem, cluster, nullptr, attr);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

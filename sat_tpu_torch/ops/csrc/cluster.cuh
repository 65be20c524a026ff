// Thread-block cluster pieces shared by the kernels that split one unit of
// work across the blocks of a cluster (the attention kernels an image's
// rows, the top-k kernel a row's columns): the block's rank, cluster
// barriers, loads from and stores to another block's shared memory
// (distributed shared memory), and a launch that checks first that a
// cluster can be placed.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

namespace sat_cluster {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// This block's rank in its cluster (blockIdx.x here: clusters run along x).
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every block of the cluster: a barrier that also orders
// shared-memory writes before it (release) against reads after it
// (acquire), in all the cluster's blocks.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
          : "memory");
}

// cluster_sync in two halves, for work between them: every thread arrives
// (releasing its memory operations before it, loads from other blocks
// included), and later waits until every thread of the cluster arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// An arrival that orders no memory: at a kernel's start, it says only that
// this block runs, so that another block may write to its shared memory
// after the matching cluster_wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The address of `local` (a shared-memory pointer of this block) in the
// shared memory of block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_u32(local)), "r"(rank));
  return out;
}

__device__ __forceinline__ float cluster_load(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

__device__ __forceinline__ void cluster_store(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(x) : "memory");
}

__device__ __forceinline__ void cluster_store_s32(uint32_t addr, int x) {
  asm volatile("st.shared::cluster.s32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}

__device__ __forceinline__ float4 cluster_load4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// Check once per (kernel, device, shared-memory size, cluster size) that a
// cluster can be placed, asking cudaOccupancyMaxActiveClusters. Before it,
// the kernel's dynamic shared-memory limit on the device is raised to the
// size when it is below it; it is never lowered, so every size checked
// before stays launchable. A cluster that cannot be placed is an error
// (cudaErrorLaunchOutOfResources); there is no other kernel to fall back
// to.
template <typename Kernel>
cudaError_t check_placement(Kernel kernel, const cudaLaunchConfig_t& cfg) {
  struct Seen {
    const void* fn;
    int device;
    size_t smem;
    unsigned cluster;
  };
  static std::mutex mu;
  static std::vector<Seen> placed, limit;  // limit: the largest size set
  const void* fn = reinterpret_cast<const void*>(kernel);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const size_t smem = cfg.dynamicSmemBytes;
  unsigned cluster = 1;
  for (unsigned a = 0; a < cfg.numAttrs; ++a)
    if (cfg.attrs[a].id == cudaLaunchAttributeClusterDimension)
      cluster = cfg.attrs[a].val.clusterDim.x * cfg.attrs[a].val.clusterDim.y *
                cfg.attrs[a].val.clusterDim.z;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& p : placed)
    if (p.fn == fn && p.device == device && p.smem == smem && p.cluster == cluster)
      return cudaSuccess;
  Seen* set = nullptr;
  for (Seen& p : limit)
    if (p.fn == fn && p.device == device) set = &p;
  if (set == nullptr) {
    limit.push_back({fn, device, 0, 0});
    set = &limit.back();
  }
  if (smem > set->smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    set->smem = smem;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  placed.push_back({fn, device, smem, cluster});
  return cudaSuccess;
}

// One launch of `kernel` on `grid` (grid.x a multiple of `cluster`) of
// `threads`-thread blocks, in clusters of `cluster` blocks along x.
// Returns the CUDA error of the placement check or of the launch.
template <typename... Params, typename... Args>
int launch_cluster_grid(void (*kernel)(Params...), dim3 grid, int cluster,
                        int threads, size_t smem, cudaStream_t stream,
                        Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = check_placement(kernel, cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sat_cluster

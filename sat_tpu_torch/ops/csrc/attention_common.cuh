// Shared pieces of the two attention kernels (attention_fwd.cu,
// attention_bwd.cu): warp reductions, the ring of shared-memory tiles that
// one-dimensional bulk copies (cp.async.bulk) fill and mbarriers complete,
// and the launch of one thread-block cluster per image.
//
// Both kernels split an image's L rows across the kCluster blocks of its
// cluster: block `rank` owns the contiguous rows [rank * chunk, ...) with
// chunk = ceil(L / kCluster), which may be empty when L < kCluster. The
// rows of one image are contiguous in memory, so a tile of them is one
// bulk copy of rows * width * sizeof(T) bytes: no tensor map is needed. Sums
// that cross the cluster go through distributed shared memory, always in
// rank order, so every run gives the same bits and no scratch in device
// memory or second kernel is needed.
//
// Keys and features (and, in the backward, dkeys and dfeats) are stored as
// T, float or __nv_bfloat16; every other tensor is float, and all the
// arithmetic is float in registers. A thread reads and writes a T row in
// groups of four elements (load4, store4): one float4, or two
// __nv_bfloat162 widened and narrowed by the conversion intrinsics, the
// narrowing rounding to nearest even.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster.cuh"

namespace sat_attention {

using namespace sat_cluster;  // rank, barriers, mapa and loads, the launch

// Chosen on the H100 at the main path's shapes (E = D = 512): small
// blocks with a small ring keep 4-5 blocks on each SM, and a 4-row tile
// gives each of the 4 warps one key row to score. Larger rings (up to
// 4 x 16 KB) or 256 threads were slower: fewer blocks fit an SM.
constexpr int kCluster = 8;            // blocks per image (portable maximum)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;             // ring slots, each one bulk copy
constexpr int kSlotBytes = 8 * 1024;   // a slot's size unless one row is wider
// bf16 rows are half as wide, so the same 8 KB slot takes twice the rows:
// a block has the same bytes in flight (kStages x 8 KB) in both types and
// issues half as many copies in bf16. Tiles scored a warp per row may
// then hold 2 x kWarps rows, two for each warp.
constexpr int kBarrierBytes = 128;     // the kStages mbarriers, padded

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__host__ __device__ inline size_t floats16(size_t n) {  // n floats, 16-byte padded
  return (4 * n + 15) & ~static_cast<size_t>(15);
}

// Rows of `row_bytes` bytes in one ring slot: kSlotBytes worth, at least
// one, at most `cap`.
__host__ inline int tile_rows(int row_bytes, int cap) {
  return clamp_int(kSlotBytes / row_bytes, 1, cap);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]), hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, const float4& x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& x) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(x.x, x.y);
  q[1] = __floats2bfloat162_rn(x.z, x.w);
}

// The rows of an image that block `rank` of its cluster owns: [l0, l0 + n).
struct Chunk {
  int l0, n;
  __device__ Chunk(int rank, int chunk, int L) {
    l0 = min(L, rank * chunk);
    n = min(L, l0 + chunk) - l0;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Sum (or max) of one float that every block of the cluster keeps at the
// same shared address, taken in rank order: the same bits in every block.
__device__ __forceinline__ float cluster_sum(const float* local) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) s += cluster_load(cluster_addr(local, q));
  return s;
}

__device__ __forceinline__ float cluster_max(const float* local) {
  float m = __int_as_float(0xff800000);  // -inf: an empty block's max
#pragma unroll
  for (int q = 0; q < kCluster; ++q)
    m = fmaxf(m, cluster_load(cluster_addr(local, q)));
  return m;
}

// A float4 that every block keeps at the same shared address, summed over
// the cluster in rank order.
__device__ __forceinline__ float4 cluster_sum4(const float4* local) {
  float4 x[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) x[q] = cluster_load4(cluster_addr(local, q));
  float4 s = x[0];
#pragma unroll
  for (int q = 1; q < kCluster; ++q) add4(s, x[q]);
  return s;
}

// A ring of kStages tiles in shared memory. Tile t of a block's sequence
// goes to slot t % kStages; one thread asks for its bytes on the slot's
// mbarrier and starts the bulk copy; every thread waits on the barrier's
// phase (t / kStages) & 1. After all threads are done with a tile
// (__syncthreads), the same thread refills its slot with tile t + kStages,
// so kStages copies stay in flight while the block computes.
struct Ring {
  uint64_t* bars;
  unsigned char* slots;
  int slot_bytes;  // a multiple of 16

  __device__ Ring(unsigned char* smem, int slot_bytes_)
      : bars(reinterpret_cast<uint64_t*>(smem)),
        slots(smem + kBarrierBytes),
        slot_bytes(slot_bytes_) {}

  // One thread, before any copy; a __syncthreads must follow.
  __device__ void init() {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_u32(&bars[s])),
                   "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // One thread: copy `bytes` (a multiple of 16, from a 16-byte aligned
  // global address) into the slot of tile t.
  __device__ void load(int t, const void* src, uint32_t bytes) {
    const int s = t % kStages;
    const uint32_t bar = smem_u32(&bars[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(slots + s * slot_bytes)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }

  // Every thread: wait until tile t has landed; returns its slot.
  template <typename T>
  __device__ const T* wait(int t) {
    const int s = t % kStages;
    const uint32_t bar = smem_u32(&bars[s]);
    const uint32_t parity = (t / kStages) & 1;
    uint32_t done;
    do {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    } while (!done);
    return reinterpret_cast<const T*>(slots + s * slot_bytes);
  }
};

// One launch of `kernel` on a (kCluster, images) grid of kThreads-thread
// blocks in clusters of kCluster along x: one cluster per image. Returns
// the CUDA error of the placement check or of the launch.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int images, size_t smem,
                    cudaStream_t stream, Args... args) {
  return launch_cluster_grid(kernel, dim3(kCluster, images, 1), kCluster,
                             kThreads, smem, stream, args...);
}

}  // namespace sat_attention

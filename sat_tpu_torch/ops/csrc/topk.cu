// Exact top-k of each f32 row, for the beam's (B, K*V) candidate scores.
//
// Replaces sat_tpu/ops/topk.py::_topk_kernel (the Pallas kernel behind
// exact_topk). Same contract: entries ordered by (value desc, index asc),
// NaN ranks as -inf (and comes back as -inf), an all -inf row gives indices
// 0..k-1, and every index appears at most once.
//
// Bound on the H100 (3.35 TB/s): at the beam's shape, (128, 13165) with
// k = 5, the rows are 6.74 MB read once, 2.0 us, and one compare per entry.
// In the beam the step's masked_fill has just written the block, so it is
// read from the 50 MB L2; at the server's batches a launch is a chain of
// latencies (load, warp rounds, a cluster barrier), not a stream of bytes.
//
// k = 1..16, topk_cluster<K>: one pass over each row.
//  - A row goes to a thread-block cluster of C blocks (C = 1..4; the
//    wrapper picks it from the batch). A row starts 4-byte aligned only
//    (N = 13165 is odd), so it is cut into a head of up to 3 entries before
//    its first 16-byte boundary, whole float4s, and a tail of up to 3
//    entries. The float4s are split into C contiguous slices, one per
//    block; rank 0 also takes the head, rank C-1 the tail. Indices stay
//    global column numbers.
//  - Each thread loads kUnroll float4s at a time (and the head or tail
//    scalar), all in flight before it looks at them. A warp then takes the
//    K-th largest of its 32 lanes' maxima (K rounds of a redux max): at
//    least K of its entries reach it, so no entry below it can be among the
//    warp's K best, and most entries cost one compare. Those at or above
//    it go into the thread's K best (value, index) pairs, sorted in registers
//    (TopList: unrolled, static indices, no local memory).
//  - Each warp merges its lanes' lists by K rounds: a redux max of the
//    heads' order keys, a redux min of the indices at that key, and the
//    lane that holds the winner pops it and stores it into rank 0's shared
//    memory (st.shared::cluster). A relaxed cluster arrive at the start and
//    its wait before the first store make sure rank 0 runs.
//  - A cluster barrier (release / acquire) lands every warp list; warp 0 of
//    rank 0 takes one list a lane (C * kWarps <= 32), merges them the same
//    way and writes the row's K.
// The order is total once NaN maps to -inf, so the exact top-k is unique
// and any split or merge order gives the same bits: no atomics, no scratch
// in device memory, one launch. A block with an empty slice (N < 4 * C)
// offers only (-inf, INT_MAX), after every entry of the row; -inf entries
// tie by index, so an all -inf row still gives 0..k-1. kThreads and
// kUnroll, and the wrapper's choice of C, were chosen by timing on the card
// at B = 1, 32 and 128.
//
// k > 16, topk_rounds: one block of 1024 threads per row and k rounds of a
// block-wide arg-max. Round r looks for the first entry, in the same order,
// that comes after round r-1's winner, so no "taken" mask is stored; each
// round re-reads the row (from L2 after the first). The C entry picks the
// kernel by k alone.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cluster.cuh"

namespace {

using namespace sat_cluster;

constexpr int kThreads = 256;  // topk_cluster's block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // float4 loads in flight per thread
constexpr int kMaxK = 16;  // topk_cluster's largest k
constexpr int kMaxCluster = 4;  // blocks a row: 4 * kWarps lists, one a lane
constexpr int kRoundThreads = 1024;  // topk_rounds' block
constexpr int kRoundWarps = kRoundThreads / 32;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// True when (av, ai) comes before (bv, bi): larger value, then lower index.
__device__ __forceinline__ bool precedes(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float ranked(float v) {  // NaN ranks as -inf
  return v != v ? neg_inf() : v;
}

// The first of the lanes' (v, i), in lane 0.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (precedes(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// An unsigned key in the order of the values: -0.0 and +0.0 share one,
// -inf (NaN ranked) has the least key of a value, 0x007fffff; 0 is below
// every value.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0;  // -0.0
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// A value that at least K of the lanes' m reach: the K-th largest of the
// 32, equal values counted, in every lane. No entry below it can be among
// the warp's K best. K rounds of a warp max (one redux instruction); the
// lanes at the max drop out.
template <int K>
__device__ __forceinline__ float kth_largest(float m) {
  unsigned key = order_key(m), kth = 0;
  int seen = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    kth = __reduce_max_sync(0xffffffffu, key);
    seen += __popc(__ballot_sync(0xffffffffu, key == kth));
    if (seen >= K) break;
    if (key == kth) key = 0;
  }
  return key_value(kth);
}

// A thread's K best (value, index) pairs, first first, in registers; empty
// places hold (-inf, INT_MAX), which every entry of a row precedes.
template <int K>
struct TopList {
  float v[K];
  int i[K];

  __device__ __forceinline__ TopList() {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      v[p] = neg_inf();
      i[p] = INT_MAX;
    }
  }

  // Insert (x, j) in order when it comes before the K-th; the K-th drops.
  __device__ __forceinline__ void push(float x, int j) {
    if (!precedes(x, j, v[K - 1], i[K - 1])) return;
    bool before[K];
#pragma unroll
    for (int p = 0; p < K; ++p) before[p] = precedes(x, j, v[p], i[p]);
#pragma unroll
    for (int p = K - 1; p > 0; --p) {
      v[p] = before[p - 1] ? v[p - 1] : (before[p] ? x : v[p]);
      i[p] = before[p - 1] ? i[p - 1] : (before[p] ? j : i[p]);
    }
    v[0] = before[0] ? x : v[0];
    i[0] = before[0] ? j : i[0];
  }

  // Every lane of the warp: the first of all lanes' heads, by a warp max
  // of their keys and a warp min of the indices at that key (one redux
  // instruction each). Returns true in the lane that holds it (a real index
  // is in one lane only; when every head is empty, in each of them), which
  // pops it into (bv, bi).
  __device__ __forceinline__ bool take_best(float& bv, int& bi) {
    const unsigned key = order_key(v[0]);
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    const bool mine = key == top;
    const unsigned first = __reduce_min_sync(
        0xffffffffu, mine ? static_cast<unsigned>(i[0]) : 0xffffffffu);
    if (!mine || static_cast<unsigned>(i[0]) != first) return false;
    bv = v[0];
    bi = i[0];
#pragma unroll
    for (int p = 0; p + 1 < K; ++p) {
      v[p] = v[p + 1];
      i[p] = i[p + 1];
    }
    v[K - 1] = neg_inf();
    i[K - 1] = INT_MAX;
    return true;
  }
};

// Grid: `cluster` blocks per row along x, in clusters of `cluster`.
template <int K>
__global__ void __launch_bounds__(kThreads)
topk_cluster(const float* __restrict__ x, float* __restrict__ values,
             int64_t* __restrict__ indices, int n, int cluster) {
  // Rank 0's copy gathers the K-lists of every warp of the cluster.
  __shared__ float list_v[kMaxCluster * kWarps * K];
  __shared__ int list_i[kMaxCluster * kWarps * K];
  cluster_arrive_relaxed();  // this block runs: others may store to it

  const int rank = cluster_rank();
  const size_t row = blockIdx.x / cluster;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* src = x + row * n;

  // [0, head) before the row's first 16-byte boundary, nvec float4s, then
  // [tail, n); this block's float4s are [v0, v1).
  const int head = min(
      n, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(src) & 15u)) & 15u) >> 2));
  const int nvec = (n - head) >> 2;
  const int tail = head + 4 * nvec;
  const int per = (nvec + cluster - 1) / cluster;
  const int v0 = min(nvec, rank * per);
  const int v1 = min(nvec, v0 + per);
  // The head's and the tail's scalars, loaded beside the first float4s.
  const bool has_head = rank == 0 && t < head;
  const bool has_tail = rank == cluster - 1 && t < n - tail;
  const float head_v = has_head ? src[t] : 0.f;
  const float tail_v = has_tail ? src[tail + t] : 0.f;

  TopList<K> list;
  const float4* vec = reinterpret_cast<const float4*>(src + head);
  for (int a0 = v0; a0 < v1; a0 += kUnroll * kThreads) {  // the same trips in every lane
    float e[4 * kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int a = a0 + t + u * kThreads;
      const float4 q = a < v1 ? __ldg(vec + a) : make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
      e[4 * u] = ranked(q.x);
      e[4 * u + 1] = ranked(q.y);
      e[4 * u + 2] = ranked(q.z);
      e[4 * u + 3] = ranked(q.w);
    }
    float m[2 * kUnroll];  // the thread's max, as a tree
#pragma unroll
    for (int c = 0; c < 2 * kUnroll; ++c) m[c] = fmaxf(e[c], e[c + 2 * kUnroll]);
#pragma unroll
    for (int w = kUnroll; w > 0; w >>= 1)
#pragma unroll
      for (int c = 0; c < w; ++c) m[c] = fmaxf(m[c], m[c + w]);
    // The warp holds at least K entries at or above tau: none below it
    // can be among the warp's K best, and most entries cost one compare.
    const float tau = kth_largest<K>(m[0]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int a = a0 + t + u * kThreads;
      if (a >= v1) break;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (e[4 * u + c] >= tau) list.push(e[4 * u + c], head + 4 * a + c);
    }
  }
  if (has_head) list.push(ranked(head_v), t);
  if (has_tail) list.push(ranked(tail_v), tail + t);

  // The warp's K best, stored straight into rank 0's shared memory.
  cluster_wait();  // every block of the cluster runs
  const int slot = (rank * kWarps + warp) * K;
  const uint32_t dst_v = cluster_addr(list_v + slot, 0);
  const uint32_t dst_i = cluster_addr(list_i + slot, 0);
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float bv;
    int bi;
    if (list.take_best(bv, bi)) {
      cluster_store(dst_v + 4 * r, bv);
      cluster_store_s32(dst_i + 4 * r, bi);
    }
  }
  cluster_arrive();  // releases the stores
  cluster_wait();    // rank 0: every list has landed
  if (rank != 0 || warp != 0) return;

  // Warp 0 of rank 0: one sorted list a lane, then the row's K.
  TopList<K> all;
  if (lane < cluster * kWarps) {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      all.v[p] = list_v[lane * K + p];
      all.i[p] = list_i[lane * K + p];
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r) {
    float bv;
    int bi;
    if (all.take_best(bv, bi)) {
      values[row * K + r] = bv;
      indices[row * K + r] = bi;
    }
  }
}

// One block per row, k rounds (the k > kMaxK kernel).
__global__ void __launch_bounds__(kRoundThreads)
topk_rounds(const float* __restrict__ x, float* __restrict__ values,
            int64_t* __restrict__ indices, int n, int k) {
  __shared__ float warp_v[kRoundWarps];
  __shared__ int warp_i[kRoundWarps];
  __shared__ float last_v;
  __shared__ int last_i;

  const float* row = x + static_cast<size_t>(blockIdx.x) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The previous winner; (+inf, -1) comes before every entry.
  float pv = __int_as_float(0x7f800000);
  int pi = -1;

  for (int r = 0; r < k; ++r) {
    // (-inf, INT_MAX) comes after every entry, -inf ones included.
    float bv = neg_inf();
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < n; j += kRoundThreads) {
      const float v = ranked(row[j]);
      const bool after_last = v < pv || (v == pv && j > pi);
      if (after_last && precedes(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = warp_v[lane];  // kRoundWarps == 32: one entry per lane
      bi = warp_i[lane];
      warp_best(bv, bi);
      if (lane == 0) {
        const size_t out = static_cast<size_t>(blockIdx.x) * k + r;
        values[out] = bv;
        indices[out] = bi;
        last_v = bv;
        last_i = bi;
      }
    }
    __syncthreads();
    pv = last_v;
    pi = last_i;
  }
}

static_assert(kMaxCluster * kWarps <= 32, "rank 0's warp takes one list a lane");
static_assert((kUnroll & (kUnroll - 1)) == 0, "the thread's max is a tree of 2 * kUnroll");
static_assert(kRoundWarps == 32, "the second reduction gives one warp entry per lane");

using Launch = int (*)(const float*, float*, int64_t*, int, int, int, cudaStream_t);

template <int K>
int launch_cluster_k(const float* x, float* values, int64_t* indices, int rows,
                     int n, int cluster, cudaStream_t stream) {
  return launch_cluster_grid(topk_cluster<K>, dim3(rows * cluster, 1, 1), cluster,
                             kThreads, 0, stream, x, values, indices, n, cluster);
}

constexpr Launch kLaunch[kMaxK] = {
    launch_cluster_k<1>,  launch_cluster_k<2>,  launch_cluster_k<3>,
    launch_cluster_k<4>,  launch_cluster_k<5>,  launch_cluster_k<6>,
    launch_cluster_k<7>,  launch_cluster_k<8>,  launch_cluster_k<9>,
    launch_cluster_k<10>, launch_cluster_k<11>, launch_cluster_k<12>,
    launch_cluster_k<13>, launch_cluster_k<14>, launch_cluster_k<15>,
    launch_cluster_k<16>};

}  // namespace

// x (rows, n) f32 contiguous -> values (rows, k) f32, indices (rows, k)
// int64. Needs 0 < k <= n and rows >= 1; `cluster` (1..4) is the blocks a
// row for k <= 16, and k > 16 ignores it. Returns the CUDA error of the
// launch (cudaErrorInvalidValue for a cluster out of range).
extern "C" int sat_topk_f32(const float* x, float* values, int64_t* indices,
                            int rows, int n, int k, int cluster,
                            cudaStream_t stream) {
  if (k > kMaxK) {
    topk_rounds<<<rows, kRoundThreads, 0, stream>>>(x, values, indices, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  if (k < 1 || cluster < 1 || cluster > kMaxCluster || rows > INT_MAX / cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return kLaunch[k - 1](x, values, indices, rows, n, cluster, stream);
}

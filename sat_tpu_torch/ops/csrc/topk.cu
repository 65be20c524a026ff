// Exact top-k of each f32 row, for the beam's (B, K*V) candidate scores.
//
// Replaces sat_tpu/ops/topk.py::_topk_kernel (the Pallas kernel behind
// exact_topk). Same contract: entries ordered by (value desc, index asc),
// NaN ranks as -inf, an all -inf row gives indices 0..k-1, and a column
// once taken never wins again, so ties give distinct columns.
//
// Bound: at the beam's shape, (128, 13165) with k = 5, the row data is
// 6.7 MB read once and a few compares per element: memory-bound. Design:
// one block per row and k rounds of a block-wide arg-max. Round r looks for
// the first entry, in the (value desc, index asc) order, that comes after
// round r-1's winner, so no "taken" mask is stored: that order is total once
// NaN maps to -inf. Each round re-reads the row; the first round brings it
// from device memory and the later rounds find it in L2 (a row is 52.7 KB,
// the whole input 6.7 MB against a 50 MB L2).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// True when (av, ai) comes before (bv, bi): larger value, then lower index.
__device__ __forceinline__ bool precedes(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

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

__global__ void __launch_bounds__(kThreads)
topk_rows(const float* __restrict__ x, float* __restrict__ values,
          int64_t* __restrict__ indices, int n, int k) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
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
    float bv = __int_as_float(0xff800000);
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      float v = row[j];
      if (v != v) v = __int_as_float(0xff800000);  // NaN ranks as -inf
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
      bv = warp_v[lane];  // kWarps == 32: one entry per lane
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

static_assert(kWarps == 32, "the second reduction gives one warp entry per lane");

}  // namespace

// x (rows, n) f32 contiguous -> values (rows, k) f32, indices (rows, k)
// int64. Needs 0 < k <= n and rows >= 1. Returns cudaGetLastError() after
// the launch.
extern "C" int sat_topk_f32(const float* x, float* values, int64_t* indices,
                            int rows, int n, int k, cudaStream_t stream) {
  topk_rows<<<rows, kThreads, 0, stream>>>(x, values, indices, n, k);
  return static_cast<int>(cudaGetLastError());
}

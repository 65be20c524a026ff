// Fused soft-attention forward: the memory-bound middle of a decode step.
//
// Replaces sat_tpu/ops/fused_attention.py::_attention_kernel. For image b
// and each of its R hidden rows r:
//
//   e[r, l]   = sum_e tanh(keys[b, l, e] + u_h[b*R + r, e]) * v[e] + b_v
//   alpha[r]  = softmax_l(e[r])
//   ctx[r, d] = sum_l alpha[r, l] * feats[b, l, d]
//
// R = 1 is the TPU kernel's function; R = K serves the de-duplicated beam,
// whose K rows of an image share one copy of its keys and features.
//
// Bound: at the beam's shape (128 images, R = 5, L = 196, E = D = 512) the
// inputs are about 104 MB, 31 us at 3.35 TB/s; the R*L*E tanh per image are
// the other near-limit (64 M of them). Eager PyTorch would write and read
// back a (B, R, L, E) tanh tensor, 257 MB at that shape; here it never
// leaves registers. Design: one block per image. Each warp takes key rows,
// reads each row once, and scores it against up to kRowsPerPass hidden rows
// held in shared memory; the R x L scores stay in shared memory for the
// softmax; then each thread owns output columns d and sums over l with one
// accumulator per hidden row, reading each feature row once per pass.
// tanhf and expf (not the approximate intrinsics) keep the result within
// float rounding of the plain PyTorch form.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerPass = 8;  // hidden rows scored per pass over the keys

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

__global__ void __launch_bounds__(kThreads)
attention_fwd(const float* __restrict__ keys, const float* __restrict__ feats,
              const float* __restrict__ u_h, const float* __restrict__ v,
              const float* __restrict__ b_v, float* __restrict__ ctx,
              float* __restrict__ alpha, int R, int L, int E, int D) {
  extern __shared__ float smem[];
  float* s_u = smem;          // (R, E) this image's projected hidden rows
  float* s_v = s_u + R * E;   // (E,)
  float* s_p = s_v + E;       // (R, L) scores, then probabilities

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* key = keys + static_cast<size_t>(b) * L * E;
  const float* feat = feats + static_cast<size_t>(b) * L * D;
  const size_t row0 = static_cast<size_t>(b) * R;  // first output row

  for (int i = threadIdx.x; i < R * E; i += kThreads) s_u[i] = u_h[row0 * E + i];
  for (int i = threadIdx.x; i < E; i += kThreads) s_v[i] = v[i];
  __syncthreads();
  const float bias = b_v[0];

  // Scores: a warp per key row, lanes across E.
  for (int r0 = 0; r0 < R; r0 += kRowsPerPass) {
    const int nr = min(kRowsPerPass, R - r0);
    for (int l = warp; l < L; l += kWarps) {
      float acc[kRowsPerPass];
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) acc[r] = 0.f;
      const float* krow = key + static_cast<size_t>(l) * E;
      for (int e = lane; e < E; e += 32) {
        const float kv = krow[e];
        const float ve = s_v[e];
#pragma unroll
        for (int r = 0; r < kRowsPerPass; ++r)
          if (r < nr) acc[r] += tanhf(kv + s_u[(r0 + r) * E + e]) * ve;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) {
        const float s = warp_sum(acc[r]);
        if (lane == 0 && r < nr) s_p[(r0 + r) * L + l] = s + bias;
      }
    }
  }
  __syncthreads();

  // Softmax over l: a warp per hidden row.
  for (int r = warp; r < R; r += kWarps) {
    float* p = s_p + r * L;
    float m = __int_as_float(0xff800000);
    for (int l = lane; l < L; l += 32) m = fmaxf(m, p[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float x = expf(p[l] - m);
      p[l] = x;
      sum += x;
    }
    sum = warp_sum(sum);
    float* out = alpha + (row0 + r) * L;
    for (int l = lane; l < L; l += 32) {
      const float a = p[l] / sum;
      p[l] = a;
      out[l] = a;
    }
  }
  __syncthreads();

  // Context: threads across D, one accumulator per hidden row of the pass.
  for (int r0 = 0; r0 < R; r0 += kRowsPerPass) {
    const int nr = min(kRowsPerPass, R - r0);
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float acc[kRowsPerPass];
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r) acc[r] = 0.f;
      for (int l = 0; l < L; ++l) {
        const float f = feat[static_cast<size_t>(l) * D + d];
#pragma unroll
        for (int r = 0; r < kRowsPerPass; ++r)
          if (r < nr) acc[r] += s_p[(r0 + r) * L + l] * f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerPass; ++r)
        if (r < nr) ctx[(row0 + r0 + r) * D + d] = acc[r];
    }
  }
}

}  // namespace

// keys (B, L, E), feats (B, L, D), u_h (B*R, E), v (E,), b_v (1,), all f32
// contiguous -> ctx (B*R, D), alpha (B*R, L). Needs B >= 1. Returns the CUDA
// error of the attribute call or of the launch.
extern "C" int sat_attention_fwd_f32(const float* keys, const float* feats,
                                     const float* u_h, const float* v,
                                     const float* b_v, float* ctx, float* alpha,
                                     int images, int rows_per_image, int L,
                                     int E, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(rows_per_image) * E + E +
       static_cast<size_t>(rows_per_image) * L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attention_fwd<<<images, kThreads, smem, stream>>>(
      keys, feats, u_h, v, b_v, ctx, alpha, rows_per_image, L, E, D);
  return static_cast<int>(cudaGetLastError());
}

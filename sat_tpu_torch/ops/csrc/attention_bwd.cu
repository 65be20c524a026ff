// Fused soft-attention backward: the gradient of attention_fwd at R = 1.
//
// Replaces sat_tpu/ops/fused_attention.py::_attention_bwd_kernel. Given the
// forward's inputs, its alpha, and the gradients dctx and dalpha of its two
// outputs, for image b:
//
//   att[l, e]    = tanh(keys[b, l, e] + u_h[b, e])     recomputed, never stored
//   dfeats[l, d] = alpha[l] * dctx[d]                  (only when asked)
//   g[l]         = feats[b, l] . dctx + dalpha[l]
//   de[l]        = alpha[l] * (g[l] - sum_l alpha[l] g[l])       (softmax VJP)
//   dpre[l, e]   = de[l] * v[e] * (1 - att[l, e]^2)
//   dkeys[b]     = dpre;   du_h[b] = sum_l dpre
//   dv_part[b]   = sum_l att[l, :] * de[l];   dbv_part[b] = sum_l de[l]
//
// The caller sums dv_part and dbv_part over images, in a fixed order: no
// atomics, so a run gives the same bits every time. (The TPU kernel's
// (8, 128)-padded partials are a Mosaic tiling artefact and are not kept.)
//
// Bound: at the training shape (64 images, L = 196, E = D = 512) the kernel
// must read keys and feats (25.7 MB each) and write dkeys (25.7 MB), plus
// dfeats (25.7 MB) when asked: 77 MB, 23 us at 3.35 TB/s, or 103 MB, 31 us.
// The special-function work is one tanh per (b, l, e): 6.4 M. Eager
// PyTorch's autograd of the plain attention would instead save the (B, L, E)
// tanh in the forward and read it back here. Design: one block per image.
// Pass 1, a warp per feature row, computes g (and writes dfeats) reading
// each row once; warp 0 then forms de in shared memory; pass 2 gives each
// thread a column e, walks l in order with the key column read coalesced
// across the block, recomputes the tanh in registers, writes dkeys and keeps
// du_h and dv in registers, so both are written once with no reduction
// across threads. 64 blocks fill 64 of the card's 132 SMs.
// tanhf (not the approximate intrinsic) matches the forward kernel and the
// plain form to float rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
attention_bwd(const float* __restrict__ keys, const float* __restrict__ feats,
              const float* __restrict__ u_h, const float* __restrict__ v,
              const float* __restrict__ alpha, const float* __restrict__ dctx,
              const float* __restrict__ dalpha, float* __restrict__ dkeys,
              float* __restrict__ dfeats, float* __restrict__ du_h,
              float* __restrict__ dv_part, float* __restrict__ dbv_part, int L,
              int E, int D) {
  extern __shared__ float smem[];
  float* s_dctx = smem;        // (D,)
  float* s_alpha = s_dctx + D; // (L,)
  float* s_g = s_alpha + L;    // (L,) g, then de

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t grid_off = static_cast<size_t>(b) * L;

  for (int i = threadIdx.x; i < D; i += kThreads)
    s_dctx[i] = dctx[static_cast<size_t>(b) * D + i];
  for (int i = threadIdx.x; i < L; i += kThreads) s_alpha[i] = alpha[grid_off + i];
  __syncthreads();

  // Pass 1: g[l] = feats[l] . dctx + dalpha[l]; dfeats[l] = alpha[l] dctx.
  for (int l = warp; l < L; l += kWarps) {
    const float* frow = feats + (grid_off + l) * D;
    const float a = s_alpha[l];
    float acc = 0.f;
    if (dfeats != nullptr) {
      float* drow = dfeats + (grid_off + l) * D;
      for (int d = lane; d < D; d += 32) {
        acc += frow[d] * s_dctx[d];
        drow[d] = a * s_dctx[d];
      }
    } else {
      for (int d = lane; d < D; d += 32) acc += frow[d] * s_dctx[d];
    }
    acc = warp_sum(acc);
    if (lane == 0) s_g[l] = acc + dalpha[grid_off + l];
  }
  __syncthreads();

  // Softmax VJP in warp 0: de[l] = alpha[l] (g[l] - sum_l alpha g).
  if (warp == 0) {
    float s = 0.f;
    for (int l = lane; l < L; l += 32) s += s_alpha[l] * s_g[l];
    s = warp_sum(s);
    float total = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float de = s_alpha[l] * (s_g[l] - s);
      s_g[l] = de;
      total += de;
    }
    total = warp_sum(total);
    if (lane == 0) dbv_part[b] = total;
  }
  __syncthreads();

  // Pass 2: a thread per column e, l in order.
  const float* kcol = keys + grid_off * E;
  float* dkcol = dkeys + grid_off * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const float u = u_h[static_cast<size_t>(b) * E + e];
    const float ve = v[e];
    float du = 0.f, dv = 0.f;
#pragma unroll 4
    for (int l = 0; l < L; ++l) {
      const size_t i = static_cast<size_t>(l) * E + e;
      const float att = tanhf(kcol[i] + u);
      const float de = s_g[l];
      const float dpre = (de * ve) * (1.f - att * att);
      dkcol[i] = dpre;
      du += dpre;
      dv += att * de;
    }
    du_h[static_cast<size_t>(b) * E + e] = du;
    dv_part[static_cast<size_t>(b) * E + e] = dv;
  }
}

}  // namespace

// keys (B, L, E), feats (B, L, D), u_h (B, E), v (E,), alpha (B, L),
// dctx (B, D), dalpha (B, L), all f32 contiguous -> dkeys (B, L, E),
// dfeats (B, L, D) unless it is null, du_h (B, E), dv_part (B, E),
// dbv_part (B,). Needs B >= 1. Returns the CUDA error of the attribute call
// or of the launch.
extern "C" int sat_attention_bwd_f32(const float* keys, const float* feats,
                                     const float* u_h, const float* v,
                                     const float* alpha, const float* dctx,
                                     const float* dalpha, float* dkeys,
                                     float* dfeats, float* du_h, float* dv_part,
                                     float* dbv_part, int images, int L, int E,
                                     int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(D) + 2 * L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attention_bwd<<<images, kThreads, smem, stream>>>(
      keys, feats, u_h, v, alpha, dctx, dalpha, dkeys, dfeats, du_h, dv_part,
      dbv_part, L, E, D);
  return static_cast<int>(cudaGetLastError());
}

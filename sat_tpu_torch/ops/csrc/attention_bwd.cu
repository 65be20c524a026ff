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
// Keys and features are float or bf16, and dkeys and dfeats are written in
// their type, rounded to nearest even from the float value: the bits that
// autograd makes of a float dkeys on its way back through the cast of the
// keys to bf16 (the TPU kernel writes float; the caller casts). The rest
// is float, and so is all the math.
//
// The caller sums dv_part and dbv_part over images, in a fixed order: no
// atomics, so a run gives the same bits every time. (The TPU kernel's
// (8, 128)-padded partials are a Mosaic tiling artefact and are not kept.)
//
// Bound on the H100 (3.35 TB/s): at the training shape (64 images,
// L = 196, E = D = 512) the kernel must read keys and feats (25.7 MB each)
// and write dkeys (25.7 MB), plus dfeats (25.7 MB) when asked: 77 MB,
// 23 us, or 103 MB, 31 us; in bf16 half of that, 39 or 52 MB. The tanh is one per (b, l, e), 6.4 M, a few us
// of issue slots. Eager PyTorch's autograd of the plain attention would
// instead save the (B, L, E) tanh in the forward and read it back here.
//
// Design (attention_common.cuh): one cluster of kCluster = 8 blocks per
// image, block `rank` owning a contiguous chunk of ceil(L / 8) rows, whose
// feature tiles and then key tiles stream through a ring of bulk copies.
// Pass 1, a warp per staged feature row: g for the block's rows; dfeats
// (when asked) is written with float4 stores. The softmax VJP needs
// sum_l alpha g over the whole image: each block's share is exchanged
// through distributed shared memory and added in rank order. Pass 2,
// threads across E (float4): the tanh is recomputed in registers from the
// staged key tile, dkeys written with float4 stores, and du_h and dv
// summed over the block's rows in order, in shared memory; then
// each block owns E / 8 columns and adds the cluster's 8 partials in rank
// order. du_h is final; dv and db_v leave one partial per image. One
// launch, no device scratch. tanhf (not the approximate intrinsic) matches
// the forward kernel and the plain form to float rounding.
// bf16 inputs take the same kernel with half the bytes a row: a slot holds
// 8 bf16 feature rows (two a warp) or 8 key rows, where it holds 4 f32.

#include "attention_common.cuh"

namespace {

using namespace sat_attention;

// Shared-memory layout, computed once on the host and passed by value.
struct BwdLayout {
  int chunk;        // rows per block: ceil(L / kCluster)
  int tf, tk;       // rows per feature tile (a warp each) and per key tile
  int slot_bytes;   // bytes per ring slot
  size_t dctx, u, v, alpha, g, acc, red, bytes;

  // elem: bytes of a key or feature element, 4 (float) or 2 (bf16)
  BwdLayout(int L, int E, int D, int elem) {
    chunk = ceil_div(L, kCluster);
    const int warp_rows = kWarps * (4 / elem);  // g a warp per row
    tf = tile_rows(elem * D, warp_rows < chunk ? warp_rows : chunk);
    tk = tile_rows(elem * E, chunk);
    slot_bytes = elem * (tk * E > tf * D ? tk * E : tf * D);
    dctx = kBarrierBytes + static_cast<size_t>(kStages) * slot_bytes;
    u = dctx + floats16(D);
    v = u + floats16(E);
    alpha = v + floats16(E);
    g = alpha + floats16(chunk);
    acc = g + floats16(chunk);  // (2, E): du, then dv
    red = acc + floats16(2 * static_cast<size_t>(E));
    bytes = red + floats16(2);
  }
};

// T: the storage type of keys, features, dkeys and dfeats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd(const T* __restrict__ keys, const T* __restrict__ feats,
              const float* __restrict__ u_h, const float* __restrict__ v,
              const float* __restrict__ alpha, const float* __restrict__ dctx,
              const float* __restrict__ dalpha, T* __restrict__ dkeys,
              T* __restrict__ dfeats, float* __restrict__ du_h,
              float* __restrict__ dv_part, float* __restrict__ dbv_part, int L,
              int E, int D, BwdLayout lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring(smem, lay.slot_bytes);
  float* s_dctx = reinterpret_cast<float*>(smem + lay.dctx);
  float* s_u = reinterpret_cast<float*>(smem + lay.u);
  float* s_v = reinterpret_cast<float*>(smem + lay.v);
  float* s_alpha = reinterpret_cast<float*>(smem + lay.alpha);
  float* s_g = reinterpret_cast<float*>(smem + lay.g);  // g, then de
  float4* s_du = reinterpret_cast<float4*>(smem + lay.acc);
  float4* s_dv = s_du + E / 4;
  float* s_red = reinterpret_cast<float*>(smem + lay.red);  // sum alpha g, sum de

  const int rank = cluster_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Chunk own(rank, lay.chunk, L);
  const int nf = ceil_div(own.n, lay.tf);
  const int ntiles = nf + ceil_div(own.n, lay.tk);
  const int E4 = E / 4, D4 = D / 4;
  const size_t grid0 = static_cast<size_t>(b) * L + own.l0;  // first own row

  auto issue = [&](int t) {  // thread 0: tile t, features then keys
    const bool feat = t < nf;
    const int i0 = feat ? t * lay.tf : (t - nf) * lay.tk;
    const int width = feat ? D : E;
    const int rows = min(feat ? lay.tf : lay.tk, own.n - i0);
    ring.load(t, (feat ? feats : keys) + (grid0 + i0) * width,
              static_cast<uint32_t>(rows * width * sizeof(T)));
  };

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(kStages, ntiles); ++t) issue(t);
  for (int i = tid; i < D; i += kThreads) s_dctx[i] = dctx[static_cast<size_t>(b) * D + i];
  for (int i = tid; i < E; i += kThreads) {
    s_u[i] = u_h[static_cast<size_t>(b) * E + i];
    s_v[i] = v[i];
  }
  for (int i = tid; i < own.n; i += kThreads) s_alpha[i] = alpha[grid0 + i];
  for (int i = tid; i < 2 * E4; i += kThreads)
    s_du[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // dfeats = alpha dctx for this block's rows, while the first tiles land.
  const float4* dctx4 = reinterpret_cast<const float4*>(s_dctx);
  if (dfeats != nullptr) {
    T* out = dfeats + grid0 * D;
    for (int i = tid; i < own.n * D4; i += kThreads) {
      const float a = s_alpha[i / D4];
      const float4 d = dctx4[i % D4];
      store4(out + 4 * static_cast<size_t>(i),
             make_float4(a * d.x, a * d.y, a * d.z, a * d.w));
    }
  }

  // Pass 1: g[l] = feats[l] . dctx + dalpha[l], a warp per feature row.
  for (int t = 0; t < nf; ++t) {
    const T* tile = ring.wait<T>(t);
    const int i0 = t * lay.tf, rows = min(lay.tf, own.n - i0);
    for (int i = warp; i < rows; i += kWarps) {
      const T* frow = tile + static_cast<size_t>(i) * D;
      float acc = 0.f;
      for (int c = lane; c < D4; c += 32) {
        const float4 f = load4(frow + 4 * c), d = dctx4[c];
        acc = fmaf(f.x, d.x, acc);
        acc = fmaf(f.y, d.y, acc);
        acc = fmaf(f.z, d.z, acc);
        acc = fmaf(f.w, d.w, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) s_g[i0 + i] = acc + dalpha[grid0 + i0 + i];
    }
    __syncthreads();
    if (tid == 0 && t + kStages < ntiles) issue(t + kStages);
  }

  // Softmax VJP: sum_l alpha g over the image, across the cluster.
  if (warp == 0) {
    float s = 0.f;
    for (int i = lane; i < own.n; i += 32) s += s_alpha[i] * s_g[i];
    s = warp_sum(s);
    if (lane == 0) s_red[0] = s;
  }
  cluster_sync();
  if (warp == 0) {
    const float total = cluster_sum(s_red);
    float sum_de = 0.f;
    for (int i = lane; i < own.n; i += 32) {
      const float de = s_alpha[i] * (s_g[i] - total);
      s_g[i] = de;
      sum_de += de;
    }
    sum_de = warp_sum(sum_de);
    if (lane == 0) s_red[1] = sum_de;
  }
  __syncthreads();

  // Pass 2: a thread per column group c, the tile's rows in order; the du
  // and dv sums stay in shared memory from tile to tile.
  const float4* u4 = reinterpret_cast<const float4*>(s_u);
  const float4* v4 = reinterpret_cast<const float4*>(s_v);
  T* dk = dkeys + grid0 * E;
  for (int t = nf; t < ntiles; ++t) {
    const T* tile = ring.wait<T>(t);
    const int i0 = (t - nf) * lay.tk, rows = min(lay.tk, own.n - i0);
    for (int c = tid; c < E4; c += kThreads) {
      const float4 u = u4[c], w = v4[c];
      float4 du = s_du[c], dv = s_dv[c];
      for (int i = 0; i < rows; ++i) {
        const float4 k = load4(tile + static_cast<size_t>(i) * E + 4 * c);
        const float de = s_g[i0 + i];
        const float ax = tanhf(k.x + u.x), ay = tanhf(k.y + u.y);
        const float az = tanhf(k.z + u.z), aw = tanhf(k.w + u.w);
        const float4 dp = make_float4((de * w.x) * (1.f - ax * ax),
                                      (de * w.y) * (1.f - ay * ay),
                                      (de * w.z) * (1.f - az * az),
                                      (de * w.w) * (1.f - aw * aw));
        store4(dk + static_cast<size_t>(i0 + i) * E + 4 * c, dp);
        add4(du, dp);
        add4(dv, make_float4(ax * de, ay * de, az * de, aw * de));
      }
      s_du[c] = du;
      s_dv[c] = dv;
    }
    __syncthreads();
    if (tid == 0 && t + kStages < ntiles) issue(t + kStages);
  }

  // The cluster's partials in rank order: this block writes its E4 / 8
  // column groups of du_h and dv_part; rank 0 writes dbv_part.
  cluster_sync();
  const int per = ceil_div(E4, kCluster);
  const int c0 = min(E4, rank * per), nc = min(E4, c0 + per) - c0;
  float4* du_out = reinterpret_cast<float4*>(du_h) + static_cast<size_t>(b) * E4;
  float4* dv_out = reinterpret_cast<float4*>(dv_part) + static_cast<size_t>(b) * E4;
  for (int c = c0 + tid; c < c0 + nc; c += kThreads) {
    du_out[c] = cluster_sum4(s_du + c);
    dv_out[c] = cluster_sum4(s_dv + c);
  }
  if (rank == 0 && tid == 0) dbv_part[b] = cluster_sum(s_red + 1);
  cluster_sync();  // no block leaves while another reads its shared memory
}

// The launch of one storage type: an error for what the bulk copies cannot
// take (rows that are not whole 16-byte units).
template <typename T>
int launch_bwd(const T* keys, const T* feats, const float* u_h,
               const float* v, const float* alpha, const float* dctx,
               const float* dalpha, T* dkeys, T* dfeats, float* du_h,
               float* dv_part, float* dbv_part, int images, int L, int E,
               int D, cudaStream_t stream) {
  constexpr int kGroup = 16 / sizeof(T);  // elements in 16 bytes
  if (E % kGroup != 0 || D % kGroup != 0 || images < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdLayout lay(L, E, D, sizeof(T));
  return launch_clusters(attention_bwd<T>, images, lay.bytes, stream, keys,
                         feats, u_h, v, alpha, dctx, dalpha, dkeys, dfeats,
                         du_h, dv_part, dbv_part, L, E, D, lay);
}

}  // namespace

// keys (B, L, E), feats (B, L, D), u_h (B, E), v (E,), alpha (B, L),
// dctx (B, D), dalpha (B, L), all f32 contiguous, keys and feats 16-byte
// aligned, E and D multiples of 4 -> dkeys (B, L, E), dfeats (B, L, D)
// unless it is null, du_h (B, E), dv_part (B, E), dbv_part (B,), the
// outputs 16-byte aligned. Needs B >= 1. One kernel launch; returns the
// CUDA error of the placement check or of the launch.
extern "C" int sat_attention_bwd_f32(const float* keys, const float* feats,
                                     const float* u_h, const float* v,
                                     const float* alpha, const float* dctx,
                                     const float* dalpha, float* dkeys,
                                     float* dfeats, float* du_h, float* dv_part,
                                     float* dbv_part, int images, int L, int E,
                                     int D, cudaStream_t stream) {
  return launch_bwd(keys, feats, u_h, v, alpha, dctx, dalpha, dkeys, dfeats,
                    du_h, dv_part, dbv_part, images, L, E, D, stream);
}

// As sat_attention_bwd_f32 with keys, feats, dkeys and dfeats in bf16, E
// and D multiples of 8; everything else f32.
extern "C" int sat_attention_bwd_bf16(
    const __nv_bfloat16* keys, const __nv_bfloat16* feats, const float* u_h,
    const float* v, const float* alpha, const float* dctx,
    const float* dalpha, __nv_bfloat16* dkeys, __nv_bfloat16* dfeats,
    float* du_h, float* dv_part, float* dbv_part, int images, int L, int E,
    int D, cudaStream_t stream) {
  return launch_bwd(keys, feats, u_h, v, alpha, dctx, dalpha, dkeys, dfeats,
                    du_h, dv_part, dbv_part, images, L, E, D, stream);
}

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
// whose K rows of an image share one copy of its keys and features. Keys
// and features are float or bf16 (the TPU kernel takes both and computes
// in f32 either way); the rest is float, and so is all the math.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32): at the beam's shape (128
// images, R = 5, L = 196, E = D = 512) the inputs are 106 MB, 32 us; at the
// training shape (64 images, R = 1) 51 MB, 15 us; with bf16 keys and
// features about half of each (55 and 26 MB). The tanh is the other
// near-limit at R = 5: 64 M precise tanhf of about a dozen FP32
// instructions each take some 30 us of the card's issue slots, so the
// kernel can approach the byte bound but not reach it. Eager PyTorch would
// write and read back a (B, R, L, E) tanh tensor (257 MB at the beam's
// shape); here it never leaves registers.
//
// Design (attention_common.cuh): one cluster of kCluster = 8 blocks per
// image, so 64 images fill 512 blocks and a single image 8 SMs. Block
// `rank` owns a contiguous chunk of ceil(L / 8) key and feature rows and
// streams them through a ring of kStages shared-memory tiles filled by 1-D
// bulk copies, keys first, then features, so that the first feature tiles
// are in flight during the softmax exchange. Scores: a warp per key row
// reads the row once from shared memory (four elements at a time, widened
// to a float4 when bf16) and scores it against all
// R hidden rows, which sit in shared memory with v. Softmax: each block's
// R maxima, then its R sums of exp(e - M), are exchanged through
// distributed shared memory (two cluster barriers), so every block forms
// the same M and Z and writes alpha for its rows. Context: each block sums
// alpha * f over its rows into an (R, D) partial in shared memory (threads
// across D, float4); after a barrier each block owns D / 8 output columns
// and adds the 8 partials in rank order. One launch, no device scratch,
// the same bits every run. tanhf and expf (not the approximate intrinsics)
// keep alpha within 1e-6 of the plain PyTorch form, which beam parity needs.
// bf16 inputs take the same kernel with half the bytes a row: a slot holds
// 8 bf16 key rows (two a warp) or 8 feature rows, where it holds 4 f32.

#include "attention_common.cuh"

namespace {

using namespace sat_attention;

// Shared-memory layout, computed once on the host and passed by value.
struct FwdLayout {
  int chunk;        // rows per block: ceil(L / kCluster)
  int tk, tf;       // rows per key tile and per feature tile
  int slot_bytes;   // bytes per ring slot
  size_t rows;      // (R, E) hidden rows while scoring, then (R, D) context
  size_t v;         // (E,)
  size_t p;         // (R, chunk) scores, then alpha
  size_t red;       // (2, R) this block's maxima and sums
  size_t bytes;

  // elem: bytes of a key or feature element, 4 (float) or 2 (bf16)
  FwdLayout(int R, int L, int E, int D, int elem) {
    chunk = ceil_div(L, kCluster);
    const int warp_rows = kWarps * (4 / elem);  // scored a warp per row
    tk = tile_rows(elem * E, warp_rows < chunk ? warp_rows : chunk);
    tf = tile_rows(elem * D, chunk);
    slot_bytes = elem * (tk * E > tf * D ? tk * E : tf * D);
    rows = kBarrierBytes + static_cast<size_t>(kStages) * slot_bytes;
    v = rows + floats16(static_cast<size_t>(R) * (E > D ? E : D));
    p = v + floats16(E);
    red = p + floats16(static_cast<size_t>(R) * chunk);
    bytes = red + floats16(2 * static_cast<size_t>(R));
  }
};

// kRows hidden rows per pass, a divisor of R chosen by the host (5 for the
// beam, 1 for training and greedy), so that every pass scores exactly
// kRows rows with no guard between their independent tanh chains. T: the
// storage type of keys and features.
template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
attention_fwd(const T* __restrict__ keys, const T* __restrict__ feats,
              const float* __restrict__ u_h, const float* __restrict__ v,
              const float* __restrict__ b_v, float* __restrict__ ctx,
              float* __restrict__ alpha, int R, int L, int E, int D,
              FwdLayout lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring(smem, lay.slot_bytes);
  float* s_rows = reinterpret_cast<float*>(smem + lay.rows);
  float* s_v = reinterpret_cast<float*>(smem + lay.v);
  float* s_p = reinterpret_cast<float*>(smem + lay.p);
  float* s_max = reinterpret_cast<float*>(smem + lay.red);
  float* s_sum = s_max + R;

  const int rank = cluster_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Chunk own(rank, lay.chunk, L);
  const int nk = ceil_div(own.n, lay.tk);
  const int ntiles = nk + ceil_div(own.n, lay.tf);
  const int E4 = E / 4, D4 = D / 4;
  const size_t row0 = static_cast<size_t>(b) * R;  // first hidden row

  auto issue = [&](int t) {  // thread 0: tile t, keys then features
    const bool key = t < nk;
    const int i0 = key ? t * lay.tk : (t - nk) * lay.tf;
    const int width = key ? E : D;
    const int rows = min(key ? lay.tk : lay.tf, own.n - i0);
    ring.load(t, (key ? keys : feats) +
                     (static_cast<size_t>(b) * L + own.l0 + i0) * width,
              static_cast<uint32_t>(rows * width * sizeof(T)));
  };

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(kStages, ntiles); ++t) issue(t);
  for (int i = tid; i < R * E; i += kThreads) s_rows[i] = u_h[row0 * E + i];
  for (int i = tid; i < E; i += kThreads) s_v[i] = v[i];
  __syncthreads();
  const float bias = b_v[0];

  // 1. Scores of this block's rows: a warp per key row, lanes across E.
  const float4* u4 = reinterpret_cast<const float4*>(s_rows);
  const float4* v4 = reinterpret_cast<const float4*>(s_v);
  for (int t = 0; t < nk; ++t) {
    const T* tile = ring.wait<T>(t);
    const int i0 = t * lay.tk, rows = min(lay.tk, own.n - i0);
    for (int i = warp; i < rows; i += kWarps) {
      const T* krow = tile + static_cast<size_t>(i) * E;
      for (int r0 = 0; r0 < R; r0 += kRows) {
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        for (int c = lane; c < E4; c += 32) {
          const float4 k = load4(krow + 4 * c), w = v4[c];
          float4 u[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            u[r] = u4[static_cast<size_t>(r0 + r) * E4 + c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r] = fmaf(tanhf(k.x + u[r].x), w.x, acc[r]);
            acc[r] = fmaf(tanhf(k.y + u[r].y), w.y, acc[r]);
            acc[r] = fmaf(tanhf(k.z + u[r].z), w.z, acc[r]);
            acc[r] = fmaf(tanhf(k.w + u[r].w), w.w, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float s = warp_sum(acc[r]);
          if (lane == 0) s_p[(r0 + r) * lay.chunk + i0 + i] = s + bias;
        }
      }
    }
    __syncthreads();
    if (tid == 0 && t + kStages < ntiles) issue(t + kStages);
  }

  // 2. Softmax over the image's L rows, across the cluster: a warp per
  // hidden row. An empty chunk gives max -inf and sum 0.
  for (int r = warp; r < R; r += kWarps) {
    float m = __int_as_float(0xff800000);
    for (int i = lane; i < own.n; i += 32) m = fmaxf(m, s_p[r * lay.chunk + i]);
    m = warp_max(m);
    if (lane == 0) s_max[r] = m;
  }
  cluster_sync();
  for (int r = warp; r < R; r += kWarps) {
    const float m = cluster_max(s_max + r);
    float sum = 0.f;
    for (int i = lane; i < own.n; i += 32) {
      const float x = expf(s_p[r * lay.chunk + i] - m);
      s_p[r * lay.chunk + i] = x;
      sum += x;
    }
    sum = warp_sum(sum);
    if (lane == 0) s_sum[r] = sum;
  }
  cluster_sync();
  for (int r = warp; r < R; r += kWarps) {
    const float z = cluster_sum(s_sum + r);
    float* out = alpha + (row0 + r) * L + own.l0;
    for (int i = lane; i < own.n; i += 32) {
      const float a = s_p[r * lay.chunk + i] / z;
      s_p[r * lay.chunk + i] = a;
      out[i] = a;
    }
  }

  // 3. This block's partial context over its rows, in s_rows (the hidden
  // rows are no longer needed): threads across D.
  float4* part = reinterpret_cast<float4*>(s_rows);
  for (int i = tid; i < R * D4; i += kThreads) part[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int t = nk; t < ntiles; ++t) {
    const T* tile = ring.wait<T>(t);
    const int i0 = (t - nk) * lay.tf, rows = min(lay.tf, own.n - i0);
    for (int r0 = 0; r0 < R; r0 += kRows) {
      for (int c = tid; c < D4; c += kThreads) {
        float4 acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = part[static_cast<size_t>(r0 + r) * D4 + c];
        for (int i = 0; i < rows; ++i) {
          const float4 f = load4(tile + static_cast<size_t>(i) * D + 4 * c);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float a = s_p[(r0 + r) * lay.chunk + i0 + i];
            acc[r].x = fmaf(a, f.x, acc[r].x);
            acc[r].y = fmaf(a, f.y, acc[r].y);
            acc[r].z = fmaf(a, f.z, acc[r].z);
            acc[r].w = fmaf(a, f.w, acc[r].w);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          part[static_cast<size_t>(r0 + r) * D4 + c] = acc[r];
      }
    }
    __syncthreads();
    if (tid == 0 && t + kStages < ntiles) issue(t + kStages);
  }

  // 4. The cluster's partials summed in rank order: this block writes its
  // D4 / kCluster column groups of every hidden row.
  cluster_sync();
  const int per = ceil_div(D4, kCluster);
  const int c0 = min(D4, rank * per), nc = min(D4, c0 + per) - c0;
  float4* out = reinterpret_cast<float4*>(ctx);
  for (int i = tid; i < R * nc; i += kThreads) {
    const int r = i / nc, c = c0 + i % nc;
    out[(row0 + r) * D4 + c] =
        cluster_sum4(part + static_cast<size_t>(r) * D4 + c);
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

// The launch of one storage type: an error for what the bulk copies cannot
// take (rows that are not whole 16-byte units), else the kernel of the
// largest kRows that divides R.
template <typename T>
int launch_fwd(const T* keys, const T* feats, const float* u_h,
               const float* v, const float* b_v, float* ctx, float* alpha,
               int images, int R, int L, int E, int D, cudaStream_t stream) {
  constexpr int kGroup = 16 / sizeof(T);  // elements in 16 bytes
  if (E % kGroup != 0 || D % kGroup != 0 || images < 1 || L < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdLayout lay(R, L, E, D, sizeof(T));
#define SAT_LAUNCH_FWD(ROWS)                                                  \
  return launch_clusters(attention_fwd<T, ROWS>, images, lay.bytes, stream,  \
                         keys, feats, u_h, v, b_v, ctx, alpha, R, L, E, D, lay)
  if (R % 8 == 0) SAT_LAUNCH_FWD(8);
  if (R % 5 == 0) SAT_LAUNCH_FWD(5);
  if (R % 4 == 0) SAT_LAUNCH_FWD(4);
  if (R % 3 == 0) SAT_LAUNCH_FWD(3);
  if (R % 2 == 0) SAT_LAUNCH_FWD(2);
  SAT_LAUNCH_FWD(1);
#undef SAT_LAUNCH_FWD
}

}  // namespace

// keys (B, L, E), feats (B, L, D), u_h (B*R, E), v (E,), b_v (1,), all f32
// contiguous, keys and feats 16-byte aligned, E and D multiples of 4 ->
// ctx (B*R, D) (16-byte aligned), alpha (B*R, L). Needs B >= 1. One kernel
// launch; returns the CUDA error of the placement check or of the launch.
extern "C" int sat_attention_fwd_f32(const float* keys, const float* feats,
                                     const float* u_h, const float* v,
                                     const float* b_v, float* ctx, float* alpha,
                                     int images, int rows_per_image, int L,
                                     int E, int D, cudaStream_t stream) {
  return launch_fwd(keys, feats, u_h, v, b_v, ctx, alpha, images,
                    rows_per_image, L, E, D, stream);
}

// As sat_attention_fwd_f32 with keys and feats in bf16, E and D multiples
// of 8; everything else f32.
extern "C" int sat_attention_fwd_bf16(const __nv_bfloat16* keys,
                                      const __nv_bfloat16* feats,
                                      const float* u_h, const float* v,
                                      const float* b_v, float* ctx,
                                      float* alpha, int images,
                                      int rows_per_image, int L, int E, int D,
                                      cudaStream_t stream) {
  return launch_fwd(keys, feats, u_h, v, b_v, ctx, alpha, images,
                    rows_per_image, L, E, D, stream);
}

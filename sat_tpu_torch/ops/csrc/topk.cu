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
// k > 16, topk_select: each row read once from device memory, then a radix
// select over it in at most three block-wide passes, whatever k, and a sort
// of the k survivors.
//  - One block of 1,024 threads a row. The row is copied into dynamic
//    shared memory (up to kRowVecs float4s, 208 KiB: rows of up to 53,245
//    entries; the flagship sampler's 2,633 take 10.5 KB, BERT's 30,522 take
//    122 KB). A row starts 4-byte aligned only, so it is read as the
//    float4s of its own 16-byte boundaries: it sits s = 0..3 entries into
//    its first vector, and only the first and last vectors are partial
//    (scalar loads, pads of -inf; every pass masks entries by index). Each
//    thread keeps kLoadUnroll float4 loads in flight and keeps the largest
//    value it loaded.
//  - A bound at or below the k-th largest value, from those maxima: each
//    warp whose lanes all hold entries takes the r-th largest of its lanes'
//    maxima, r = ceil(k / such warps) <= 32, and the least of these is
//    reached by at least k entries of the row. Entries below it cannot be
//    in the top k, and every later sweep drops them with one compare.
//    Without such warps, or with r > 32 (every k > 1,024), every entry
//    stays.
//  - Warp w sweeps a contiguous run of the row's vectors, 32 lanes'
//    vectors at a time, and places the (key, ~index) words of the entries
//    that reach the bound, in index order, by ballots, in its own 64 words
//    of shared memory. When no warp has more than 64 and all of them are
//    at most kMaxSelect (random rows keep a few hundred of BERT's 30,522
//    at k = 50), they are the survivors.
//  - Otherwise a radix select over them: each maps to a 32-bit order key
//    (NaN as -inf, -0.0 as +0.0: for the key only), and passes over digits
//    of 11, 11 and 10 bits (key bits 31-21, 20-10, 9-0) histogram the keys
//    that match the prefix found so far into 2,048 bins in shared memory
//    (atomic adds: their order changes no count); a descending scan of the
//    bins finds the bin of the k-th largest key and the count of keys
//    above it. After a pass whose prefix has at most S = max(k, kMaxSelect)
//    keys at or above it, the passes stop and all of those survive (for
//    k > kMaxSelect, exactly k). Otherwise, after the third, the prefix is
//    the k-th key T itself: every key above T survives, and the
//    lowest-index (k - above) of the keys equal to T. They are taken in
//    index order by two sweeps: the first counts each warp's, one barrier
//    and a scan of the 32 counts give each warp its first place, and the
//    second places each at the count above the prefix before it plus the
//    count at it before it, capped at the quota. No atomic decides a
//    place, so two launches give the same bits.
//  - k <= kMaxSelect: a bitonic sort of the survivors, one 64-bit word
//    (key, ~index) a thread of the first (survivors, rounded up to a power
//    of two from 32) threads, descending, which orders by value
//    descending, then index ascending: strides below 32 by warp shuffles,
//    the others through shared memory (one barrier of those threads each).
//    Thread t < k writes the t-th index and its value, read again from the
//    row (so -0.0 keeps its sign and NaN comes back as -inf).
//  - k > kMaxSelect: the take lays the k survivors' indices down in index
//    order, and a stable LSD radix sort on their order keys, descending,
//    orders them by value descending, then index ascending, without ever
//    comparing indices. Digits of 8 bits (kSortBits), low digit first;
//    only the digits below the highest bit in which the survivors' least
//    and largest keys differ are sorted (the rest are the same in every
//    survivor). Each pass gives warp w a contiguous run of the current
//    order and 256 counters of its run's digits; a block scan in (digit
//    descending, warp ascending) order turns the 32 x 256 counts into
//    first places, and one sweep places each index at its (warp, digit)
//    place plus the lanes before it with its digit (lanes with one digit
//    found by __match_any_sync), whose highest lane moves the place on:
//    places by scans, never by atomics. The counts are made where each
//    index is placed, by the take for the first digit and by each pass's
//    sweep for the next: a shared atomic add to the counter of the next
//    digit of the warp whose run the place falls in (the order of the adds
//    changes no count), into the other of two tables. The counters are
//    16-bit (a resident row has < 65,536 entries, so 16-bit indices too),
//    two to a word for the atomics: one table in the 16 KB the passes'
//    histograms used, one after the row in dynamic shared memory; for a
//    row not resident (or one too wide to leave room for that table) both
//    are 32-bit, in dynamic shared memory. A warp's row of counters is
//    padded by one word, so that the scan's reads (one digit of 8 warps a
//    thread) find 32 banks. On the card (`time_topk.py`), at (128, 2,633)
//    and k = 1,025: 0.0308 ms with a sweep of its own to count each digit,
//    no padding and the unrolled sub-steps past a warp's run swept too;
//    0.0277 padded and skipping them; 0.0248 counting at the places.
//    A key is read again from the row at each use (shared memory when it
//    is resident). The two index buffers take the shared memory the row
//    leaves (BERT's 30,522-entry row leaves room for 19,228 16-bit indices
//    in each, beside the second table); one or both that do not fit lie
//    in a workspace in device
//    memory (`sat_topk_workspace_bytes`, allocated by the wrapper), whose
//    scattered stores go to the L2. Why not a bitonic sort of several words
//    a thread: at BERT's k = 30,521 it is 120 stages of 32,768 words with a
//    barrier each and 64-bit words that do not fit beside the row; the
//    radix sort is at most 4 passes of 3 block barriers over 16-bit
//    indices (chosen by this count; only the radix sort was built). A
//    ballot of each digit bit in place of __match_any_sync was timed on
//    the card: faster at k >= 2,048 of random rows, slower at 1,025 and
//    in BERT's sampled decode at 30,521, so match stays. The radix sort
//    is the template argument kRadix, so that the kernel for k <=
//    kMaxSelect compiles as it did without it.
//  - A row too wide for the copy runs the same sweeps with each one reading
//    the row from device memory (the L2 after the first): exact, slower. No
//    path of the port gives such rows at k > 16.
//  Bound on the H100: the row read once and k values and indices written;
//  at the sampler's (128, 30,522), k = 50, 15.6 MB, 4.7 us at 3.35 TB/s,
//  and at k = 30,521 62.5 MB, 19 us; a row a block leaves each SM one copy
//  to wait on. The rest is a chain of barriers: 2 (the bound, the take)
//  when the bound keeps few enough entries, else 3 for each pass and 2 for
//  the take; for k <= kMaxSelect the bitonic sort's stages at strides of 32
//  and up (none to 15; log^2 in the survivors), for larger k 3 barriers
//  for each of at most 4 digits and a sweep of k / 32 indices a warp.
//  kLoadUnroll and the block were chosen by timing on the card.
//
// The C entry picks the kernel by k.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "cluster.cuh"

namespace {

using namespace sat_cluster;

constexpr int kThreads = 256;  // topk_cluster's block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // float4 loads in flight per thread
constexpr int kMaxK = 16;  // topk_cluster's largest k
constexpr int kMaxCluster = 4;  // blocks a row: 4 * kWarps lists, one a lane
constexpr int kSelectThreads = 1024;  // topk_select's block
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr int kMaxSelect = kSelectThreads;  // survivors: one a thread
constexpr int kBins = 2048;  // an 11-bit digit
constexpr int kPasses = 3;  // digits of 11, 11 and 10 bits
constexpr int kLoadUnroll = 4;  // float4 loads in flight per thread
constexpr int kRowVecs = 13312;  // float4s of a row in shared memory
constexpr int kRunWords = 64;  // a warp's run of kept entries: 32 runs fill the histograms
constexpr int kSortBits = 8;  // the sort's digit (k > kMaxSelect)
constexpr int kSortBins = 1 << kSortBits;
constexpr int kSortUnroll = 4;  // indices a lane loads at a time in the sort's sweeps

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// True when (av, ai) comes before (bv, bi): larger value, then lower index.
__device__ __forceinline__ bool precedes(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float ranked(float v) {  // NaN ranks as -inf
  return v != v ? neg_inf() : v;
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


// ---- topk_select (k > 16)

// Digit `pass` of a key: its shift and width (bits 31-21, 20-10, 9-0).
__device__ __forceinline__ int digit_shift(int pass) { return pass == 0 ? 21 : pass == 1 ? 10 : 0; }
__device__ __forceinline__ int digit_bits(int pass) { return pass == 2 ? 10 : 11; }

__device__ __forceinline__ float4 neg_inf4() {
  return make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
}

// Vector q of a row that sits s entries into its first 16-byte unit:
// entries 4q - s .. 4q - s + 3; those outside [0, n) read as -inf (and no
// pass counts them). `vec` is the row's first 16-byte unit (src - s).
__device__ __forceinline__ float4 row_vec(const float4* vec, const float* src,
                                          int q, int s, int n) {
  const int j = 4 * q - s;
  if (j >= 0 && j + 3 < n) return __ldg(vec + q);
  float e[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) e[c] = (j + c >= 0 && j + c < n) ? __ldg(src + j + c) : neg_inf();
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Inclusive sum over the warp's lanes.
__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// Where the select kernel reads its row: shared memory (kResident) or
// device memory.
template <bool kResident>
struct Row {
  const float4* smem;
  const float4* vec;
  const float* src;
  int s, n, nv;

  __device__ __forceinline__ float4 operator[](int q) const {
    if (q >= nv) return neg_inf4();
    return kResident ? smem[q] : row_vec(vec, src, q, s, n);
  }
  __device__ __forceinline__ float at(int j) const {
    return kResident ? reinterpret_cast<const float*>(smem)[j + s] : src[j];
  }
};

// A barrier of the first `threads` threads of the block (a multiple of
// 32), on barrier `id` (0 is __syncthreads'). The warp converges first:
// the barrier may follow code whose lanes branched apart.
__device__ __forceinline__ void named_barrier(int id, uint32_t threads) {
  __syncwarp();
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A bitonic sort of kSize 64-bit words, one in each of the first kSize
// threads, descending: the thread's word after it. Strides below 32 go by
// warp shuffles, the others through `buf`'s two halves of kMaxSelect
// words in turn, with one barrier of the kSize threads each.
template <int kSize>
__device__ __forceinline__ unsigned long long bitonic(unsigned long long mine,
                                                      unsigned long long* buf) {
  const int t = threadIdx.x;
  int exchange = 0;
#pragma unroll
  for (int size = 2; size <= kSize; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned long long other;
      if (stride >= 32) {
        unsigned long long* half = buf + (exchange++ & 1) * kMaxSelect;
        half[t] = mine;
        named_barrier(1, kSize);
        other = half[t ^ stride];
      } else {
        other = __shfl_xor_sync(0xffffffffu, mine, stride);
      }
      const bool descending = (t & size) == 0;
      const bool first = (t & stride) == 0;
      const bool larger = other > mine;
      if (first == descending ? larger : !larger && other != mine) mine = other;
    }
  }
  return mine;
}

// The sort's row indices and counters (k > kMaxSelect): 16-bit when the row
// is resident (fewer than 65,536 entries), else 32-bit.
template <bool kResident>
using Slot = typename std::conditional<kResident, uint16_t, uint32_t>::type;

// A warp's row of the sort's counters, kSortBins and one 32-bit word: the
// scan, which reads one digit of 8 warps a thread, then finds 32 banks.
template <bool kResident>
__host__ __device__ constexpr int sort_stride() { return kSortBins + 4 / static_cast<int>(sizeof(Slot<kResident>)); }

// Add one to the counter of digit `digit` of the warp whose run of `per`
// indices holds `place`: a shared atomic, whose order changes no count. Two
// 16-bit counters share a word; a count stays below 65,536, so the add
// never carries into the other.
template <bool kResident>
__device__ __forceinline__ void count_at(Slot<kResident>* table, uint32_t place,
                                         uint32_t digit, uint32_t per) {
  Slot<kResident>* row = table + (place / per) * sort_stride<kResident>();
  if constexpr (kResident)
    atomicAdd(reinterpret_cast<uint32_t*>(row + (digit & ~1u)), 1u << (16 * (digit & 1u)));
  else
    atomicAdd(row + digit, 1u);
}

// A stable LSD radix sort of the m row indices in `a`, descending by their
// order keys, over the key's low `digits` digits of kSortBits: returns the
// buffer (`a` or `b`) that holds them sorted. Warp w sorts the w-th run of
// ceil(m / kSelectWarps) indices of each pass's order. `t0` for even
// passes and `t1` for odd ones (kSelectWarps rows of sort_stride counters
// each) hold the pass's digit counts of each warp's run, counted where the
// indices were placed (the take counts pass 0's, the scatter of pass p
// those of pass p + 1); the first pass zeroes `t1`. `warp_sum`:
// kSelectWarps words.
template <bool kResident>
__device__ __forceinline__ const Slot<kResident>* radix_sort(
    const Row<kResident>& row, Slot<kResident>* a, Slot<kResident>* b,
    Slot<kResident>* t0, Slot<kResident>* t1, uint32_t* warp_sum, int m, int digits) {
  using S = Slot<kResident>;
  constexpr int kStride = sort_stride<kResident>();
  constexpr int kTableWords = kSelectWarps * kStride * sizeof(S) / 4;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t per = (m + kSelectWarps - 1) / kSelectWarps;
  const int c0 = min(m, static_cast<int>(warp * per)), c1 = min(m, c0 + static_cast<int>(per));
  for (int p = 0; p < digits; ++p) {
    const int shift = kSortBits * p;
    S* const table = p & 1 ? t1 : t0;
    S* const next = p & 1 ? t0 : t1;  // pass p - 1's places: free
    // the counts' exclusive scan in (digit descending, warp ascending)
    // order: thread t holds digit kSortBins-1 - t/4, warps 8(t%4)..+7
    {
      const int d = kSortBins - 1 - (t >> 2);
      const int w0 = 8 * (t & 3);
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        c[u] = table[(w0 + u) * kStride + d];
        sum += c[u];
      }
      for (int i = t; i < kTableWords; i += kSelectThreads) reinterpret_cast<uint32_t*>(next)[i] = 0;
      const uint32_t inc = warp_inclusive(sum);
      if (lane == 31) warp_sum[warp] = inc;
      __syncthreads();
      const uint32_t w = warp_sum[lane];
      uint32_t place = __shfl_sync(0xffffffffu, warp_inclusive(w) - w, warp) + inc - sum;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        table[(w0 + u) * kStride + d] = static_cast<S>(place);
        place += c[u];
      }
    }
    __syncthreads();
    // each index goes to its (warp, digit) place plus the lanes before it
    // with its digit, and counts there for the next pass; the group's
    // highest lane moves the place on
    S* const own = table + warp * kStride;
    const bool counts = p + 1 < digits;
    for (int i0 = c0; i0 < c1; i0 += 32 * kSortUnroll) {  // the same trips in every lane
      S j[kSortUnroll];
      uint32_t key[kSortUnroll], d[kSortUnroll];
#pragma unroll
      for (int u = 0; u < kSortUnroll; ++u) {
        const int i = i0 + lane + 32 * u;
        j[u] = i < c1 ? a[i] : S(0);
      }
#pragma unroll
      for (int u = 0; u < kSortUnroll; ++u) {
        const int i = i0 + lane + 32 * u;
        key[u] = i < c1 ? order_key(ranked(row.at(j[u]))) : 0u;
        d[u] = i < c1 ? (key[u] >> shift) & (kSortBins - 1) : static_cast<uint32_t>(kSortBins);
      }
#pragma unroll
      for (int u = 0; u < kSortUnroll; ++u) {
        if (i0 + 32 * u >= c1) break;  // no lane's index is in the run
        const unsigned peers = __match_any_sync(0xffffffffu, d[u]);
        const bool in_run = d[u] < kSortBins;
        const uint32_t at = in_run ? own[d[u]] : 0u;
        __syncwarp();
        if (in_run) {
          const uint32_t to = at + __popc(peers & below);
          b[to] = j[u];
          if (counts) count_at<kResident>(next, to, (key[u] >> (shift + kSortBits)) & (kSortBins - 1), per);
          if (lane == 31 - __clz(peers)) own[d[u]] = static_cast<S>(at + __popc(peers));
        }
        __syncwarp();
      }
    }
    __syncthreads();
    S* done = b;
    b = a;
    a = done;
  }
  return a;
}

// The select kernel's static words: two histograms, or the 16-bit
// counters of the radix sort.
constexpr int kWorkWords = 2 * kBins + kSelectWarps;

// Grid: one block per row. kResident: the row lives in dynamic shared
// memory (16 * ((n + 6) / 4) bytes); else each pass reads device memory.
// kRadix (k > kMaxSelect): the radix sort of the survivors, else the
// bitonic one. Its two tables of counters are `work` and the first
// dynamic bytes after the row when the row is resident, else the first
// dynamic bytes; then come the first `in_smem` (0-2) of its two index
// buffers of k Slots; the others lie in `ws`, (2 - in_smem) * k Slots a
// row.
template <bool kResident, bool kRadix>
__global__ void __launch_bounds__(kSelectThreads, 1)
topk_select(const float* __restrict__ x, float* __restrict__ values,
            int64_t* __restrict__ indices, int n, int k, void* __restrict__ ws,
            int in_smem) {
  using S = Slot<kResident>;
  extern __shared__ float4 row_smem[];  // kResident: the row's vectors
  // The warps' runs of kept entries, or two histograms and then the
  // survivors; then the sort's two exchange buffers (64-bit words), or
  // (k > kMaxSelect, resident) the radix sort's counters.
  __shared__ __align__(16) uint32_t work[kWorkWords];
  __shared__ uint32_t warp_a[kSelectWarps], warp_b[kSelectWarps], warp_bound[kSelectWarps];
  __shared__ uint32_t chosen[3];  // the pass's prefix, keys above it, keys at it

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t r = blockIdx.x;
  const float* src = x + r * n;
  const int s = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15u) >> 2);
  const int nv = (n + s + 3) >> 2;
  const Row<kResident> row{row_smem, reinterpret_cast<const float4*>(src - s), src, s, n, nv};
  const uint32_t cap = kRadix ? k : kMaxSelect;  // the survivors the sort holds

  for (int i = t; i < 2 * kBins; i += kSelectThreads) work[i] = 0;

  // ---- the copy (kResident), and each thread's largest value (pads are
  // -inf; fmaxf drops NaN, which ranks as -inf)
  float top = neg_inf();
  for (int q0 = 0; q0 < nv; q0 += kLoadUnroll * kSelectThreads) {
    float4 v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int q = q0 + t + u * kSelectThreads;
      v[u] = q < nv ? row_vec(row.vec, src, q, s, n) : neg_inf4();
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int q = q0 + t + u * kSelectThreads;
      if (kResident && q < nv) row_smem[q] = v[u];
      top = fmaxf(top, fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
    }
  }

  // ---- a bound at or below the k-th largest key. Each lane of the first
  // `full` warps holds vector t, so its largest value is one of its
  // entries. A warp's per_warp-th largest lane maximum is reached by
  // per_warp entries, so the least of those over the full warps is reached
  // by full * per_warp >= k entries: no entry below it is in the top k.
  const int full = min(kSelectWarps, nv / 32);
  const int per_warp = full > 0 ? (k + full - 1) / full : 33;
  if (warp < full && per_warp <= 32) {
    uint32_t key = order_key(top), kth = 0;
    int seen = 0;
    for (int round = 0; round < 32 && seen < per_warp; ++round) {
      kth = __reduce_max_sync(0xffffffffu, key);
      seen += __popc(__ballot_sync(0xffffffffu, key == kth));
      if (key == kth) key = 0;
    }
    if (lane == 0) warp_bound[warp] = kth;
  }
  if constexpr (kRadix) {  // the row's largest key, for the sort's digits
    const uint32_t warp_most = __reduce_max_sync(0xffffffffu, order_key(top));
    if (lane == 0) warp_b[warp] = warp_most;
  }
  __syncthreads();  // also: the copy and the zeroed histograms
  uint32_t bound = 0, most = 0;
  if (per_warp <= 32)
    bound = __reduce_min_sync(0xffffffffu, lane < full ? warp_bound[lane] : 0xffffffffu);
  if constexpr (kRadix) most = __reduce_max_sync(0xffffffffu, warp_b[lane]);
  const bool all = bound <= 0x007fffffu;  // at most -inf's key: every entry
  const float least = all ? neg_inf() : key_value(bound);

  // Warp w sweeps a contiguous run of the row's vectors, 32 lanes' vectors
  // at a time, so a warp's ballots see its entries in index order.
  unsigned long long* surv = reinterpret_cast<unsigned long long*>(work);
  const int per = (nv + kSelectWarps - 1) / kSelectWarps;
  const int w0 = min(nv, warp * per), w1 = min(nv, w0 + per);
  const unsigned below = (1u << lane) - 1u;

  // ---- the entries that reach the bound (below a finite bound, NaN fails
  // the compare, as it ranks as -inf): when they fit the sort, they are
  // the survivors
  auto kept = [&](const float4& v, int q, int c) -> bool {
    const bool in_row = static_cast<unsigned>(4 * q - s + c) < static_cast<unsigned>(n);
    return in_row && (all || lane_of(v, c) >= least);
  };
  // One sweep: each warp places its kept entries in index order in its
  // own run of kRunWords words. They are the survivors when no run
  // overflows and all fit the sort.
  uint32_t m = static_cast<uint32_t>(n), placed = 0;
  bool fits = false;
  if (!all || n <= kMaxSelect) {
    for (int q0 = w0; q0 < w1; q0 += 32) {  // the same trips in every lane
      const int q = q0 + lane;
      const float4 v = row[q < w1 ? q : nv];
      bool kd[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kd[c] = q < w1 && kept(v, q, c);
      if (__ballot_sync(0xffffffffu, kd[0] || kd[1] || kd[2] || kd[3]) == 0) continue;
      uint32_t at = placed;  // before this lane's first entry
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned b = __ballot_sync(0xffffffffu, kd[c]);
        at += __popc(b & below);
        placed += __popc(b);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!kd[c]) continue;
        if (at < kRunWords)
          surv[warp * kRunWords + at] =
              (static_cast<unsigned long long>(order_key(ranked(lane_of(v, c)))) << 32) |
              ~static_cast<uint32_t>(4 * q - s + c);
        ++at;
      }
    }
    if (lane == 0) warp_a[warp] = placed;
    __syncthreads();
    placed = warp_a[lane];
    m = __shfl_sync(0xffffffffu, warp_inclusive(placed), 31);
    fits = !__any_sync(0xffffffffu, placed > static_cast<uint32_t>(kRunWords)) &&
           m <= static_cast<uint32_t>(kMaxSelect);
  }
  unsigned long long mine = 0;
  if (fits) {
    // survivor t: the (t - runs before)-th of the first run that ends past
    // t, found by halving over the 32 runs' ends (lane l holds run l's)
    const uint32_t ends = warp_inclusive(placed);
    int w = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(0xffffffffu, ends, min(w + step - 1, 31)) <= static_cast<uint32_t>(t)) w += step;
    const uint32_t start = __shfl_sync(0xffffffffu, ends - placed, min(w, 31));
    if (static_cast<uint32_t>(t) < m) mine = surv[w * kRunWords + (t - start)];
  } else {
    for (int i = t; i < 2 * kBins; i += kSelectThreads) work[i] = 0;
    __syncthreads();
    // ---- else passes over them: prefix = key >> shift of the k-th
    // largest key
    uint32_t prefix = 0, above = 0, at = 0;
    int shift = 32;
    for (int pass = 0; pass < kPasses; ++pass) {
      const int prev = shift;
      shift = digit_shift(pass);
      const uint32_t mask = (1u << digit_bits(pass)) - 1u;
      uint32_t* hist = work + (pass & 1) * kBins;
      for (int q0 = 0; q0 < nv; q0 += kLoadUnroll * kSelectThreads) {
        float4 v[kLoadUnroll];
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) v[u] = row[q0 + t + u * kSelectThreads];
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          const int q = q0 + t + u * kSelectThreads;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (!kept(v[u], q, c)) continue;
            const uint32_t key = order_key(ranked(lane_of(v[u], c)));
            if (pass == 0 || (key >> prev) == prefix) atomicAdd(hist + ((key >> shift) & mask), 1u);
          }
        }
      }
      __syncthreads();

      // The bin of the k-th largest key: thread t holds bins kBins-1-2t
      // and kBins-2-2t, and the count of keys in the bins above them.
      const uint32_t needed = static_cast<uint32_t>(k) - above;
      const uint32_t c_hi = hist[kBins - 1 - 2 * t], c_lo = hist[kBins - 2 - 2 * t];
      const uint32_t inc = warp_inclusive(c_hi + c_lo);
      if (lane == 31) warp_a[warp] = inc;
      uint32_t* other = work + ((pass + 1) & 1) * kBins;  // the next pass's
      for (int i = t; i < kBins; i += kSelectThreads) other[i] = 0;
      __syncthreads();
      const uint32_t w = warp_a[lane];
      const uint32_t w_inc = warp_inclusive(w);
      const uint32_t before = __shfl_sync(0xffffffffu, w_inc - w, warp) + inc - (c_hi + c_lo);
      const uint32_t bin_hi = kBins - 1 - 2 * t;
      if (before < needed && needed <= before + c_hi) {
        chosen[0] = (prefix << digit_bits(pass)) | bin_hi;
        chosen[1] = above + before;
        chosen[2] = c_hi;
      } else if (before + c_hi < needed && needed <= before + c_hi + c_lo) {
        chosen[0] = (prefix << digit_bits(pass)) | (bin_hi - 1);
        chosen[1] = above + before + c_hi;
        chosen[2] = c_lo;
      }
      __syncthreads();
      prefix = chosen[0];
      above = chosen[1];
      at = chosen[2];
      if (above + at <= cap) break;
    }
    // Every key above the prefix survives (side 1), and the first `quota`
    // at it (side 2): all of them when they fit, else the k-th key's
    // lowest-index ties. A first sweep counts each warp's entries of each
    // side; after a barrier, a scan of the 32 counts gives those before
    // this warp's run; a second sweep places each word (or, for the radix
    // sort, each index in `sort_a`) at the count of side 1 before it plus
    // the count of side 2 before it, the latter capped at the quota.
    // kRadix: the sort's two tables of counters and its index buffers
    constexpr int kTableBytes = kSelectWarps * sort_stride<kResident>() * sizeof(S);
    char* const dyn = reinterpret_cast<char*>(row_smem) + (kResident ? 16 * ((n + 6) / 4) : 0);
    S* const t0 = kResident ? reinterpret_cast<S*>(work) : reinterpret_cast<S*>(dyn);
    S* const t1 = reinterpret_cast<S*>(dyn + (kResident ? 0 : kTableBytes));
    char* const after = dyn + (kResident ? 1 : 2) * kTableBytes;
    const uint32_t sort_per = (k + kSelectWarps - 1) / kSelectWarps;  // a warp's run in the sort
    S* const ws_row = static_cast<S*>(ws) + r * (2 - in_smem) * k;
    S* const sort_a = in_smem > 0 ? reinterpret_cast<S*>(after) : ws_row;
    S* const sort_b = in_smem > 1 ? reinterpret_cast<S*>(after) + k
                                  : in_smem > 0 ? ws_row : ws_row + k;
    const uint32_t quota = above + at <= cap ? at : static_cast<uint32_t>(k) - above;
    auto side = [&](const float4& v, int q, int c, uint32_t& key) -> int {
      if (!kept(v, q, c)) return 0;
      key = order_key(ranked(lane_of(v, c)));
      const uint32_t pre = key >> shift;
      return pre > prefix ? 1 : pre == prefix ? 2 : 0;
    };
    uint32_t n1 = 0, n2 = 0;
    for (int q = w0 + lane; q < w1; q += 32) {
      const float4 v = row[q];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t key;
        const int sd = side(v, q, c, key);
        n1 += sd == 1;
        n2 += sd == 2;
      }
    }
    n1 = __reduce_add_sync(0xffffffffu, n1);
    n2 = __reduce_add_sync(0xffffffffu, n2);
    if constexpr (kRadix)  // the passes' histograms are read: pass 0's counters
      for (int i = t; i < kTableBytes / 4; i += kSelectThreads) reinterpret_cast<uint32_t*>(t0)[i] = 0;
    if (lane == 0) {
      warp_a[warp] = n1;
      warp_b[warp] = n2;
    }
    __syncthreads();
    const uint32_t a = warp_a[lane], b = warp_b[lane];
    uint32_t g = __shfl_sync(0xffffffffu, warp_inclusive(a) - a, warp);
    uint32_t e = __shfl_sync(0xffffffffu, warp_inclusive(b) - b, warp);
    for (int q0 = w0; q0 < w1; q0 += 32) {  // the same trips in every lane
      const int q = q0 + lane;
      const float4 v = row[q < w1 ? q : nv];
      uint32_t key[4];
      int sd[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) sd[c] = q < w1 ? side(v, q, c, key[c]) : 0;
      if (__ballot_sync(0xffffffffu, sd[0] | sd[1] | sd[2] | sd[3]) == 0) continue;
      uint32_t gl = g, el = e;  // before this lane's first entry
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned b1 = __ballot_sync(0xffffffffu, sd[c] == 1);
        const unsigned b2 = __ballot_sync(0xffffffffu, sd[c] == 2);
        gl += __popc(b1 & below);
        el += __popc(b2 & below);
        g += __popc(b1);
        e += __popc(b2);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (sd[c] == 0) continue;
        const uint32_t j = 4 * q - s + c;
        if (sd[c] == 1 || el < quota) {
          const uint32_t place = sd[c] == 1 ? gl + min(el, quota) : gl + el;
          if constexpr (kRadix) {
            sort_a[place] = static_cast<S>(j);
            count_at<kResident>(t0, place, key[c] & (kSortBins - 1), sort_per);
          } else
            surv[place] = (static_cast<unsigned long long>(key[c]) << 32) | ~j;
        }
        if (sd[c] == 1)
          ++gl;
        else
          ++el;
      }
    }
    m = above + quota;
    __syncthreads();
    if constexpr (kRadix) {
      // ---- k > kMaxSelect: the radix sort of the k survivors (m = k), over
      // the digits below the highest bit in which their least possible key
      // (the prefix) and the row's largest differ
      const uint32_t differ = (prefix << shift) ^ most;
      const int digits = differ == 0 ? 0 : (31 - __clz(differ)) / kSortBits + 1;
      const S* sorted = radix_sort(row, sort_a, sort_b, t0, t1, warp_a, k, digits);
      for (int p = t; p < k; p += kSelectThreads) {
        const int j = sorted[p];
        values[r * k + p] = ranked(row.at(j));
        indices[r * k + p] = j;
      }
      return;
    }
    if (static_cast<uint32_t>(t) < m) mine = surv[t];
  }

  // ---- the sort, by the first size_all threads
  uint32_t size_all = 32;
  while (size_all < m) size_all <<= 1;
  if (t >= static_cast<int>(size_all)) return;
  named_barrier(1, size_all);  // every survivor read: the buffers are free
  switch (size_all) {
    case 32: mine = bitonic<32>(mine, surv); break;
    case 64: mine = bitonic<64>(mine, surv); break;
    case 128: mine = bitonic<128>(mine, surv); break;
    case 256: mine = bitonic<256>(mine, surv); break;
    case 512: mine = bitonic<512>(mine, surv); break;
    default: mine = bitonic<1024>(mine, surv); break;
  }
  if (t < k) {
    const int j = static_cast<int>(~static_cast<uint32_t>(mine));
    values[r * k + t] = ranked(row.at(j));
    indices[r * k + t] = j;
  }
}

static_assert(kMaxCluster * kWarps <= 32, "rank 0's warp takes one list a lane");
static_assert((kUnroll & (kUnroll - 1)) == 0, "the thread's max is a tree of 2 * kUnroll");
static_assert(kSelectWarps == 32, "the scans give one warp total per lane");
static_assert(2 * kSelectThreads == kBins, "a thread scans two bins");
static_assert(2 * kMaxSelect * 8 <= 2 * kBins * 4, "the sort's two buffers fit the histograms");
static_assert(kSelectWarps * kSortBins == 8 * kSelectThreads, "a thread scans 8 of the radix sort's counters");
static_assert(kSelectWarps * sort_stride<true>() * 2 <= kWorkWords * 4, "the 16-bit counters fit the work words");
static_assert(kRowVecs * 4 < 65536, "a resident row's indices fit 16 bits");
static_assert(kSelectWarps * kRunWords * 8 <= 2 * kBins * 4, "the warps' runs fit the histograms");

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

// Where topk_select keeps what it needs for (n, k): the row in shared
// memory when it fits (its float4s, for any start alignment; for k >
// kMaxSelect with the radix sort's second table of counters beside it),
// else read from device memory in each pass; for k > kMaxSelect as many
// of the sort's two index buffers as the block's shared memory still
// holds, the rest in a workspace of `ws_row` bytes a row. The static
// shared memory is the same in every instance of the kernel.
struct SelectPlan {
  bool resident;
  int in_smem;    // index buffers in shared memory
  size_t smem;    // dynamic shared memory bytes
  size_t ws_row;  // workspace bytes a row
};

cudaError_t select_plan(int n, int k, SelectPlan* plan) {
  const long long vecs = (static_cast<long long>(n) + 6) / 4;
  plan->resident = vecs <= kRowVecs;
  plan->in_smem = 0;
  plan->smem = plan->resident ? static_cast<size_t>(16 * vecs) : 0;
  plan->ws_row = 0;
  if (k <= kMaxSelect) return cudaSuccess;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, topk_select<true, true>);
  if (err != cudaSuccess) return err;
  const size_t room = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  // the resident row, the second table of 16-bit counters beside it, or
  // both tables of 32-bit counters
  const size_t resident = plan->smem + kSelectWarps * sort_stride<true>() * sizeof(Slot<true>);
  plan->resident = plan->resident && resident <= room;
  plan->smem = plan->resident ? resident : 2 * kSelectWarps * sort_stride<false>() * sizeof(Slot<false>);
  const size_t buf = static_cast<size_t>(k) * (plan->resident ? sizeof(Slot<true>) : sizeof(Slot<false>));
  plan->in_smem = plan->smem + 2 * buf <= room ? 2 : plan->smem + buf <= room ? 1 : 0;
  plan->smem += plan->in_smem * buf;
  plan->ws_row = (2 - plan->in_smem) * buf;
  return cudaSuccess;
}

int launch_select(const float* x, float* values, int64_t* indices, int rows,
                  int n, int k, void* ws, cudaStream_t stream) {
  SelectPlan plan;
  const cudaError_t err = select_plan(n, k, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.ws_row > 0 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool radix = k > kMaxSelect;
  auto* kernel = plan.resident ? (radix ? topk_select<true, true> : topk_select<true, false>)
                               : (radix ? topk_select<false, true> : topk_select<false, false>);
  return launch_cluster_grid(kernel, dim3(rows, 1, 1), 1, kSelectThreads, plan.smem, stream,
                             x, values, indices, n, k, ws, plan.in_smem);
}

}  // namespace

// The workspace bytes a row that sat_topk_f32 needs at (n, k), in *bytes
// (0 for most k: everything fits the block's shared memory). Returns the
// CUDA error of the device queries.
extern "C" int sat_topk_workspace_bytes(int n, int k, int64_t* bytes) {
  *bytes = 0;
  if (k <= kMaxK) return static_cast<int>(cudaSuccess);
  SelectPlan plan;
  const cudaError_t err = select_plan(n, k, &plan);
  if (err == cudaSuccess) *bytes = static_cast<int64_t>(plan.ws_row);
  return static_cast<int>(err);
}

// x (rows, n) f32 contiguous -> values (rows, k) f32, indices (rows, k)
// int64. Needs 0 < k <= n and rows >= 1; `cluster` (1..4) is the blocks a
// row for k <= 16, and larger k ignores it; `workspace` holds rows times
// sat_topk_workspace_bytes(n, k) bytes (null when that is 0). Returns the
// CUDA error of the launch (cudaErrorInvalidValue for a cluster out of
// range or a missing workspace).
extern "C" int sat_topk_f32(const float* x, float* values, int64_t* indices,
                            int rows, int n, int k, int cluster, void* workspace,
                            cudaStream_t stream) {
  if (k > kMaxK) return launch_select(x, values, indices, rows, n, k, workspace, stream);
  if (k < 1 || cluster < 1 || cluster > kMaxCluster || rows > INT_MAX / cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  return kLaunch[k - 1](x, values, indices, rows, n, cluster, stream);
}

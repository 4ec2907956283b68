// Exact k-nearest-neighbour kernels for Hopper (sm_90a).
//
// Each replaces one Pallas TPU kernel of cilantro_tpu/neighbors/pallas_nn.py
// and computes what that kernel computes:
//
//   knn_full_kernel,
//   knn_full_warp_kernel <- _knn_kernel          (_knn_pallas_full, knn_pallas)
//   knn_compact_kernel   <- _knn_kernel_compact  (_knn_pallas_compact)
//
// The full search has two designs, one launcher each; the wrapper picks one
// from the shapes (fused_knn._full_plan): a thread per query
// (knn_full_kernel, items 1-3 below) and a warp per query
// (knn_full_warp_kernel, item 5).
//
// Inputs are augmented rows of 8 float32 (q^ = [-2q, |q|^2, 1, 0...],
// k^ = [k, 1, |k|^2, 0...], see fused_nn.py), so that the squared distance is
// one 8-term dot product, summed left to right with __fmul_rn / __fadd_rn
// (never contracted into FMAs, no tensor cores), exactly as the nn1 kernels
// and the plain PyTorch versions in fused_knn.py sum it.
//
// The one invariant. For each query row the kernels return the k
// lexicographically smallest (distance, key position) pairs over the visited
// keys, ascending, with (3e38, 0) in the slots that no key fills; a NaN sum,
// a sum >= 3e38 (masked and padding keys carry 3e38 in the |k|^2 slot) and,
// with exclude_diag, the key whose position equals the query's row never
// enter. That is the TPU kernels' result too: they visit keys in ascending
// position and insert a key after every slot <= it only if it is strictly
// below the k-th, which for ascending positions is the lexicographic order.
// Here every comparison is between pairs, never distances alone, so the
// result is a set: it does not depend on the order in which keys are visited
// or on how the key range is split and merged again, and kernel and plain
// version agree bit for bit.
//
// Design.
//
// 1. Batched insertion. One thread per query; keys are staged 512 at a time
//    in shared memory and read by the warp as broadcasts. A key passes the
//    filter when its distance is <= the current k-th (or < 3e38 while fewer
//    than k slots are filled) and then only goes into the thread's queue of
//    kQueue (distance, position) pairs in shared memory: one store, no
//    shifting. Before every step of kChains keys the warp votes (__any_sync)
//    whether a queue could overflow; then, and at the end, the warp merges,
//    with the exact pair comparison. The filter's bound moves only at
//    merges, so more keys pass than with an insertion per key.
//    - k <= 32: the slots live in registers, a template over the buckets
//      K = 1, 4, 8, 12, 16, 24, 32. The K - k unused slots sit at the front as
//      sentinels (-inf, -1) that no pair is below, so the k-th is always the
//      last register. Each lane inserts its queued pairs by one branch-free
//      pass of compares and selects over the K registers, all lanes at once:
//      a merge costs the warp the longest queue's insertions, where the
//      per-key insertion stalled the warp once for every entering key.
//    - k > 32: each query's sorted list is a row in device memory (the
//      output row, or a partial row), so neither shared memory nor occupancy
//      grows with k. A merge walks the warp's queries whose queue is nearly
//      full; for each, the 32 lanes merge its queue into its list by ranks:
//      a candidate lands at (#list pairs below it) + (#candidates below it),
//      counted over windows of 32 * W list pairs held in registers (W = 2,
//      3, 4, 8 by k) and summed with __reduce_add_sync, and the list moves
//      right, window by window from the end, stopping at the first window
//      that does not move. This is the ranking form of the merge in Johnson,
//      Douze and Jegou's WarpSelect ("Billion-scale similarity search with
//      GPUs", arXiv:1702.08734, 4.2): a sorted list spread over the warp's
//      lanes, each candidate placed by a count of compares spread over the
//      lanes in place of a walk of up to k slots; no bitonic network, since
//      every lane can read the list.
// 2. A full grid. The full kernel splits the key range across gridDim.y
//    blocks when the query blocks alone are fewer than a few per SM (the
//    wrapper picks the split from the shapes and the SM count). Each split
//    block writes its partial lists to scratch; the last block of a query
//    block to finish (a ticket per query block, after a __threadfence) merges
//    the partial lists of its queries through the same queue, in the same
//    launch. By the invariant the result is the unsplit one.
// 3. Independent work: kChains = 4 distances in flight per thread, each
//    staged key read once by the warp for its 32 queries. (Two queries a
//    thread, which halves the shared-memory reads, measured slower on the
//    compact path: the doubled slots cost occupancy.)
// 4. The compact kernel takes work items that the wrapper builds from the
//    pair list on the device, with no read-back: the live entries sorted by
//    query tile (dead ones last), one item per block of 256 queries of a
//    tile (128 when tile_q is an odd multiple of 128) and part of its run of
//    at most 16,384 keys, the longest runs first, so that no long run starts
//    last and the split items come first (only they get partial rows); the
//    grid is a bound from the caller's live count, and the items past the
//    real ones are spare. Each live chunk is staged once per block. A block
//    visits its tile's chunks nearest first by their distance in key order
//    from its rows' own place (both sides share one Morton order in
//    knn_pruned), so the k-th tightens early; the parts of a long run take
//    turns along that order, and the last part to finish merges the partial
//    lists as in 2. A tile that no live entry names keeps the starting state
//    (the TPU kernel leaves those rows undefined; knn_pruned's `visited`
//    gate never reads them).
//
// What bounds them: arithmetic. Per visited (query, key) pair of 3-D points
// the function needs 5 products, 4 sums and a compare (10 operations; the
// other 3 products and sums multiply zero padding) at 67 TFLOP/s float32 off
// the tensor cores. These kernels issue the 8 products and 7 sums unfused
// for bit-exactness, plus the filter and the queue, about 24 instructions a
// pair, so at best about 40% of that bound; the merges come on top, and at
// k > 32 in the thread design they dominate (PERF.md §6 has the times). The
// warp design reads a key from shared memory per lane (32 bytes a pair,
// where the thread design's broadcast reads 1 byte), so on large grids its
// shared-memory reads bound it before its arithmetic; its merges cost a
// warp-wide network of shuffles each.
//
// 5. A warp per query (knn_full_warp_kernel), for k > 32 and for grids that
//    one thread per query leaves short of blocks: a block of W warps takes W
//    queries and stages 1,024 keys at a time in shared memory (the two
//    float4 halves of a key in two arrays, so that the lanes' loads are
//    conflict-free); lane l of a query's warp takes keys l, l + 32, ..., so
//    a query's walk is 32 times shorter than with a thread per query. This
//    is Johnson, Douze and Jegou's WarpSelect (arXiv:1702.08734, 4-5):
//    - the query's sorted list lives in registers, P = 32 * 2^i >= k slots
//      over the warp (P / 32 pairs a lane, slot e in register e / 32 of
//      lane e % 32), so up to k = 1,024;
//    - each lane filters its keys against the list's k-th into a queue of
//      T pairs of its own, in registers; before every step the warp votes
//      whether a queue could overflow, and then merges;
//    - a merge sorts the 32 * T queued pairs with a warp-wide bitonic
//      network (pad pairs (inf, INT_MAX) sort last), keeps the smaller of
//      list[e] and queue[P - 1 - e] (the P smallest of both, a bitonic
//      sequence) and sorts that with a bitonic merge; every compare is the
//      exact pair compare, so the network's result is the pair order's.
//    Key splits and the ticket merge of item 2 carry over: the last warp of
//    a query offers its partial lists' pairs to a fresh list through the
//    same queue. The queries need not fill the last block.
//
// Each launcher enqueues on the caller's stream, does not synchronise, and
// returns the first CUDA error of its setup or launch, so that a refused
// launch is reported.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kDim = 8;
constexpr int kStage = 512;        // keys staged in shared memory at a time
constexpr int kChains = 4;         // distances in flight per thread
constexpr int kQueue = 16;         // candidate queue slots per query
constexpr int kFullQueries = 128;  // queries per block of the full kernel
constexpr int kMaxQueries = 256;   // queries per block of the compact kernel
constexpr float kInvalid = 3.0e38f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float aug_dot(const float (&q)[kDim], float4 a,
                                         float4 b) {
  float acc = __fmul_rn(q[0], a.x);
  acc = __fadd_rn(acc, __fmul_rn(q[1], a.y));
  acc = __fadd_rn(acc, __fmul_rn(q[2], a.z));
  acc = __fadd_rn(acc, __fmul_rn(q[3], a.w));
  acc = __fadd_rn(acc, __fmul_rn(q[4], b.x));
  acc = __fadd_rn(acc, __fmul_rn(q[5], b.y));
  acc = __fadd_rn(acc, __fmul_rn(q[6], b.z));
  acc = __fadd_rn(acc, __fmul_rn(q[7], b.w));
  return acc;
}

__device__ __forceinline__ void load_query(const float* __restrict__ qp,
                                           int row, float (&q)[kDim]) {
  const float4* src = reinterpret_cast<const float4*>(qp) + 2 * (size_t)row;
  const float4 a = src[0];
  const float4 b = src[1];
  q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
  q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
}

// (ad, ap) < (bd, bp) lexicographically. NaN is below nothing.
__device__ __forceinline__ bool pair_less(float ad, int ap, float bd, int bp) {
  return ad < bd || (ad == bd && ap < bp);
}

// The filter bound for a k-th distance: a key passes when d <= bound. While
// the k-th is the starting 3e38 the bound is the float below it, so that
// exactly the sums < 3e38 pass; afterwards it is the k-th itself (a key equal
// to it passes, and the merge's pair comparison decides).
__device__ __forceinline__ float filter_bound(float kth) {
  return kth < kInvalid ? kth : __int_as_float(__float_as_int(kInvalid) - 1);
}

// One query's candidate queue in shared memory: (distance, position bits)
// pairs, slot i at first[i * stride] (a block's queues interleave, so
// consecutive lanes store to consecutive addresses).
struct Queue {
  float2* first;
  float2* next;
  int stride;
  int cnt;

  __device__ __forceinline__ void push(float dist, int pos) {
    *next = make_float2(dist, __int_as_float(pos));
    next += stride;
    ++cnt;
  }
  __device__ __forceinline__ float2 at(int i) const { return first[i * stride]; }
  __device__ __forceinline__ void clear() {
    next = first;
    cnt = 0;
  }
};

// k <= K slots in registers, ascending, the K - k unused ones at the front
// as (-inf, -1) sentinels: the k-th is always slot K - 1.
template <int K>
struct RegSlots {
  float d[K];
  int32_t p[K];
  float bound;

  __device__ __forceinline__ void init(float*, int32_t*, int, int k) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool sentinel = j < K - k;
      d[j] = sentinel ? -CUDART_INF_F : kInvalid;
      p[j] = sentinel ? -1 : 0;
    }
    bound = filter_bound(d[K - 1]);
  }

  // Insert (cd, cp) after every slot below it, dropping the last; a pair not
  // below the last slot (or (inf, .)) changes nothing.
  __device__ __forceinline__ void insert(float cd, int cp) {
    bool below = pair_less(cd, cp, d[K - 1], p[K - 1]);  // below slot j
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      const bool below_prev = pair_less(cd, cp, d[j - 1], p[j - 1]);
      const float nd = below_prev ? d[j - 1] : (below ? cd : d[j]);
      const int np = below_prev ? p[j - 1] : (below ? cp : p[j]);
      d[j] = nd;
      p[j] = np;
      below = below_prev;
    }
    if (below) {
      d[0] = cd;
      p[0] = cp;
    }
  }

  // Warp-collective: every lane inserts all its queued candidates.
  __device__ __forceinline__ void merge(Queue& qu, int) {
    const int most = __reduce_max_sync(kAll, qu.cnt);
    for (int i = 0; i < most; ++i) {
      const float2 c = i < qu.cnt ? qu.at(i) : make_float2(CUDART_INF_F, 0.0f);
      insert(c.x, __float_as_int(c.y));
    }
    qu.clear();
    bound = filter_bound(d[K - 1]);
  }

  __device__ __forceinline__ void store(float* __restrict__ out_d,
                                        int32_t* __restrict__ out_i, int row,
                                        int k) const {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j >= K - k) {
        out_d[(size_t)row * k + j - (K - k)] = d[j];
        out_i[(size_t)row * k + j - (K - k)] = p[j];
      }
    }
  }
};

// k > 32: each query's ascending list is a row of (ld, li) in device memory
// (the warp's 32 rows are contiguous). A merge reads the list in windows of
// 32 * W pairs, W a lane.
template <int W>
struct MemSlots {
  float* ld;
  int32_t* li;
  int k;
  int row0;  // the warp's first list row
  float bound;

  // Warp-collective: (3e38, 0) in the warp's rows.
  __device__ __forceinline__ void init(float* d, int32_t* p, int row, int kk) {
    const int lane = threadIdx.x & 31;
    ld = d;
    li = p;
    k = kk;
    row0 = row - lane;
    float* rd = d + (size_t)row0 * k;
    int32_t* ri = p + (size_t)row0 * k;
    for (int t = lane; t < 32 * k; t += 32) {
      rd[t] = kInvalid;
      ri[t] = 0;
    }
    __syncwarp();
    bound = filter_bound(kInvalid);
  }

  // Warp-collective: merge the queue of every lane holding more than `above`
  // candidates into its list, one query at a time, the 32 lanes together
  // (see the design note at the top).
  __device__ void merge(Queue& qu, int above) {
    const int lane = threadIdx.x & 31;
    // Lanes read each other's queues below: order the pushes before them
    // (the vote and shuffle intrinsics order no memory).
    __syncwarp();
    unsigned pending = __ballot_sync(kAll, qu.cnt > above);
    while (pending) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const int n = __shfl_sync(kAll, qu.cnt, src);
      float* rd = ld + (size_t)(row0 + src) * k;
      int32_t* ri = li + (size_t)(row0 + src) * k;
      // Candidate `lane` of query `src` (queue columns of a warp are
      // consecutive) and its rank among the candidates: positions are
      // distinct keys, so no two candidates tie, nor a candidate and a list
      // pair (queued distances are < 3e38).
      float cd = CUDART_INF_F;
      int cp = 0;
      if (lane < n) {
        const float2 c = (qu.first + (src - lane))[lane * qu.stride];
        cd = c.x;
        cp = __float_as_int(c.y);
      }
      int rank = 0;
      for (int m = 0; m < n; ++m) {
        rank += pair_less(__shfl_sync(kAll, cd, m), __shfl_sync(kAll, cp, m), cd, cp);
      }
      float kth = CUDART_NAN_F;  // set by the lane that writes place k - 1
      // Windows from the end: count the list pairs below each candidate and
      // move each pair right by the number of candidates below it. Every
      // write lands on a place whose old pair has been read; a window where
      // nothing moves ends it (every pair before it is below every
      // candidate).
      for (int w0 = (k - 1) / (32 * W) * (32 * W); w0 >= 0; w0 -= 32 * W) {
        float ed[W];
        int ep[W];
        int shift[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int j = w0 + e * 32 + lane;
          ed[e] = j < k ? rd[j] : CUDART_INF_F;
          ep[e] = j < k ? ri[j] : 0;
          shift[e] = 0;
        }
        for (int m = 0; m < n; ++m) {
          const float md = __shfl_sync(kAll, cd, m);
          const int mp = __shfl_sync(kAll, cp, m);
          int below = 0;
#pragma unroll
          for (int e = 0; e < W; ++e) {
            const bool lt = pair_less(ed[e], ep[e], md, mp);  // never past k
            below += lt;
            shift[e] += !lt;
          }
          below = __reduce_add_sync(kAll, below);
          if (lane == m) rank += below;
        }
        bool moves = false;
#pragma unroll
        for (int e = 0; e < W; ++e) moves |= w0 + e * 32 + lane < k && shift[e] > 0;
        if (!__any_sync(kAll, moves)) {
          rank += w0;
          break;
        }
        __syncwarp();
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int j = w0 + e * 32 + lane;
          if (j < k && shift[e] > 0 && j + shift[e] < k) {
            rd[j + shift[e]] = ed[e];
            ri[j + shift[e]] = ep[e];
            if (j + shift[e] == k - 1) kth = ed[e];
          }
        }
        __syncwarp();
      }
      if (lane < n && rank < k) {
        rd[rank] = cd;
        ri[rank] = cp;
        if (rank == k - 1) kth = cd;
      }
      // The new k-th is whatever landed on place k - 1 (if nothing did,
      // nothing entered).
      const unsigned wrote = __ballot_sync(kAll, kth == kth);
      if (wrote) kth = __shfl_sync(kAll, kth, __ffs(wrote) - 1);
      __syncwarp();
      if (lane == src) {
        if (wrote) bound = filter_bound(kth);
        qu.clear();
      }
    }
  }

  __device__ __forceinline__ void store(float*, int32_t*, int, int) const {}
};

// A thread's query: row row0 + threadIdx.x of its block, list row
// list_row0 + threadIdx.x, queue column threadIdx.x.
template <class Slots>
struct Query {
  float q[kDim];
  int row;
  Slots s;
  Queue qu;

  // Rows past n_queries (the last block's padding) repeat the last query.
  __device__ __forceinline__ void init(const float* __restrict__ qp, int row0,
                                       int n_queries, float2* queue,
                                       float* list_d, int32_t* list_i,
                                       int list_row0, int k) {
    row = row0 + threadIdx.x;
    load_query(qp, min(row, n_queries - 1), q);
    qu = Queue{queue + threadIdx.x, queue + threadIdx.x, (int)blockDim.x, 0};
    s.init(list_d, list_i, list_row0 + threadIdx.x, k);
  }

  // Warp-collective: merge when some queue of the warp holds more than
  // `above` candidates (every queue when above = 0).
  __device__ __forceinline__ void merge_if(int above) {
    if (__any_sync(kAll, qu.cnt > above)) s.merge(qu, above);
  }

  // Offer entry j of the query's partial list, row part_row0 + threadIdx.x
  // of (part_d, part_i).
  __device__ __forceinline__ void offer_partial(const float* part_d,
                                                const int32_t* part_i,
                                                int part_row0, int j, int k) {
    merge_if(kQueue - 1);
    const size_t at = ((size_t)part_row0 + threadIdx.x) * k + j;
    const float cd = __ldcg(part_d + at);
    if (cd <= s.bound) qu.push(cd, __ldcg(part_i + at));
  }

  __device__ __forceinline__ void store(float* out_d, int32_t* out_i,
                                        int list_row0, int k) {
    s.store(out_d, out_i, list_row0 + threadIdx.x, k);
  }
};

// Filter the staged keys [0, n_pad) (positions pos0 + m) into the queue,
// kChains distances in flight.
template <bool kDiag, class Slots>
__device__ __forceinline__ void scan_stage(const float4* stage, int n_pad,
                                           int pos0, Query<Slots>& b) {
  for (int m = 0; m < n_pad; m += kChains) {
    b.merge_if(kQueue - kChains);
    float d[kChains];
#pragma unroll
    for (int u = 0; u < kChains; ++u) {
      d[u] = aug_dot(b.q, stage[2 * (m + u)], stage[2 * (m + u) + 1]);
    }
#pragma unroll
    for (int u = 0; u < kChains; ++u) {
      const int pos = pos0 + m + u;
      if (d[u] <= b.s.bound && (!kDiag || pos != b.row)) b.qu.push(d[u], pos);
    }
  }
}

// Filter keys [k0, k0 + len) into the queues. Every thread of the block
// calls it with the same k0 and len (it synchronises); the block's queries
// are rows [row0, row0 + blockDim.x).
template <class Slots>
__device__ void fold_keys(const float* __restrict__ kp, int k0, int len,
                          int row0, bool exclude_diag, Query<Slots>& b,
                          float4* stage) {
  const float4* src = reinterpret_cast<const float4*>(kp) + 2 * (size_t)k0;
  const float4 nan4 = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                                  CUDART_NAN_F);
  for (int s0 = 0; s0 < len; s0 += kStage) {
    const int n = min(kStage, len - s0);
    const int n_pad = (n + kChains - 1) / kChains * kChains;
    __syncthreads();  // the previous stage has been read by every thread
    for (int t = threadIdx.x; t < 2 * n_pad; t += blockDim.x) {
      // NaN rows pad the stage to whole steps: a NaN sum never passes.
      stage[t] = t < 2 * n ? src[2 * (size_t)s0 + t] : nan4;
    }
    __syncthreads();
    const int pos0 = k0 + s0;
    if (exclude_diag && pos0 < row0 + (int)blockDim.x && row0 < pos0 + n) {
      scan_stage<true>(stage, n_pad, pos0, b);
    } else {
      scan_stage<false>(stage, n_pad, pos0, b);
    }
  }
}

// grid (ceil(n_queries / 128), splits), one query a thread: block (x, y)
// folds keys [y * split_len, min((y + 1) * split_len, n_keys)) for queries
// [128 x, 128 x + 128). The output and the partial lists have n_rows =
// 128 * gridDim.x rows (the padding rows repeat the last query). With one
// split it writes the output; with more, partial lists to part (splits,
// n_rows, k), and the last block of each x merges them into the output.
template <class Slots>
__global__ void __launch_bounds__(kFullQueries)
knn_full_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                int n_queries, int n_keys, int k, int exclude_diag,
                int split_len, float* part_d, int32_t* part_i,
                int32_t* tickets, float* out_d, int32_t* out_i) {
  __shared__ float4 stage[2 * kStage];
  __shared__ float2 queue[kQueue * kFullQueries];
  __shared__ int last;
  const int splits = gridDim.y;
  const int n_rows = gridDim.x * kFullQueries;
  const int row0 = blockIdx.x * kFullQueries;
  float* list_d = out_d;
  int32_t* list_i = out_i;
  int list_row0 = row0;
  if (splits > 1) {
    list_d = part_d;
    list_i = part_i;
    list_row0 = blockIdx.y * n_rows + row0;
  }
  Query<Slots> b;
  b.init(qp, row0, n_queries, queue, list_d, list_i, list_row0, k);
  const int k0 = blockIdx.y * split_len;
  fold_keys(kp, k0, min(split_len, n_keys - k0), row0, exclude_diag != 0, b,
            stage);
  b.merge_if(0);
  b.store(list_d, list_i, list_row0, k);
  if (splits == 1) return;

  // The last split block of this query block merges the partial lists.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  b.s.init(out_d, out_i, row0 + threadIdx.x, k);
  for (int y = 0; y < splits; ++y) {
    for (int j = 0; j < k; ++j) b.offer_partial(part_d, part_i, y * n_rows + row0, j, k);
  }
  b.merge_if(0);
  b.store(out_d, out_i, row0, k);
}

// One block per work item (tile, sub, part, parts): rows [tile * tile_q +
// sub * blockDim.x, + blockDim.x) of query tile `tile`, against part `part`
// of `parts` of the tile's live key chunks kt_live[starts[tile] ..
// starts[tile + 1]) (the wrapper compacts the list, splits long runs and
// orders the items by run length, longest first; items with tile < 0 are
// spare). The chunks are visited nearest first by their distance in key
// order from the rows' own place, and the parts take turns along that order,
// so that each starts near. One part writes the output; with more, each
// writes a partial list to part rows blockIdx.x * blockDim.x .. (the split
// items are the first ones) and the last to finish merges them. The dynamic
// shared memory holds the queues.
template <class Slots>
__global__ void __launch_bounds__(kMaxQueries)
knn_compact_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                   const int32_t* __restrict__ kt_live,
                   const int32_t* __restrict__ starts,
                   const int4* __restrict__ items, int n_queries, int n_keys,
                   int tile_q, int tile_m, int k, int exclude_diag,
                   float* part_d, int32_t* part_i, int32_t* tickets,
                   float* out_d, int32_t* out_i) {
  __shared__ float4 stage[2 * kStage];
  __shared__ int last;
  extern __shared__ float2 queue[];
  const int4 item = items[blockIdx.x];
  if (item.x < 0) return;
  const int row0 = item.x * tile_q + item.y * blockDim.x;
  const bool split = item.w > 1;
  float* list_d = split ? part_d : out_d;
  int32_t* list_i = split ? part_i : out_i;
  const int list_row0 = split ? blockIdx.x * blockDim.x : row0;
  Query<Slots> b;
  b.init(qp, row0, n_queries, queue, list_d, list_i, list_row0, k);
  const int lo = starts[item.x];
  const int hi = starts[item.x + 1];
  const int center =
      (int)(((long long)row0 + blockDim.x / 2) * n_keys / n_queries) / tile_m;
  int near = lo;
  for (int e = lo + 1; e < hi; ++e) {
    if (abs(kt_live[e] - center) < abs(kt_live[near] - center)) near = e;
  }
  int left = near - 1, right = near;
  for (int n = 0; n < hi - lo; ++n) {
    int e;
    if (right < hi && (left < lo || abs(kt_live[right] - center) <=
                                        abs(kt_live[left] - center))) {
      e = right++;
    } else {
      e = left--;
    }
    if (n % item.w == item.z) {
      fold_keys(kp, kt_live[e] * tile_m, tile_m, row0, exclude_diag != 0, b,
                stage);
    }
  }
  b.merge_if(0);
  b.store(list_d, list_i, list_row0, k);
  if (!split) return;

  // The last part of these rows merges the partial lists of all parts
  // (items blockIdx.x - part .. + parts).
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int qb = item.x * (tile_q / blockDim.x) + item.y;
    last = atomicAdd(&tickets[qb], 1) == item.w - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  b.s.init(out_d, out_i, row0 + threadIdx.x, k);
  for (int p = 0; p < item.w; ++p) {
    const int part_row0 = (blockIdx.x - item.z + p) * blockDim.x;
    for (int j = 0; j < k; ++j) b.offer_partial(part_d, part_i, part_row0, j, k);
  }
  b.merge_if(0);
  b.store(out_d, out_i, row0, k);
}

template <class Slots>
cudaError_t launch_full(const void* qp, const void* kp, int n_queries,
                        int n_keys, int k, int exclude_diag, int splits,
                        int split_len, void* part_d, void* part_i,
                        void* tickets, void* out_d, void* out_i,
                        cudaStream_t stream) {
  const dim3 grid((n_queries + kFullQueries - 1) / kFullQueries, splits);
  knn_full_kernel<Slots><<<grid, kFullQueries, 0, stream>>>(
      static_cast<const float*>(qp), static_cast<const float*>(kp), n_queries,
      n_keys, k, exclude_diag, split_len, static_cast<float*>(part_d),
      static_cast<int32_t*>(part_i), static_cast<int32_t*>(tickets),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i));
  return cudaGetLastError();
}

template <class Slots>
cudaError_t launch_compact(const void* qp, const void* kp, const void* kt_live,
                           const void* starts, const void* items, int n_items,
                           int rows, int n_queries, int n_keys, int tile_q,
                           int tile_m, int k, int exclude_diag, void* part_d,
                           void* part_i, void* tickets, void* out_d,
                           void* out_i, cudaStream_t stream) {
  if ((rows != kFullQueries && rows != kMaxQueries) || tile_q % rows != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes = (size_t)kQueue * rows * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      knn_compact_kernel<Slots>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  knn_compact_kernel<Slots><<<n_items, rows, bytes, stream>>>(
      static_cast<const float*>(qp), static_cast<const float*>(kp),
      static_cast<const int32_t*>(kt_live), static_cast<const int32_t*>(starts),
      static_cast<const int4*>(items), n_queries, n_keys, tile_q, tile_m, k,
      exclude_diag, static_cast<float*>(part_d), static_cast<int32_t*>(part_i),
      static_cast<int32_t*>(tickets), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Design 5: a warp per query (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int kWarpKeys = 1;  // keys a lane takes a step (distances in flight)
constexpr int kWarpQueueMin = 4;  // queue pairs a lane: P / 32 clamped to these
constexpr int kWarpQueueMax = 8;
constexpr int kWarpStage = 1024;  // keys staged in shared memory at a time
constexpr int kMaxWarps = 8;      // warps (queries) a block at most
constexpr int kNoPos = 0x7fffffff;
static_assert(kWarpStage % (32 * kWarpKeys) == 0, "whole steps a stage");
static_assert(kWarpQueueMin >= kWarpKeys, "a step fits an empty queue");

// Afterwards (ad, ap) holds the smaller pair if up, else the larger.
__device__ __forceinline__ void pair_cas(float& ad, int& ap, float& bd, int& bp,
                                         bool up) {
  const bool swap = up ? pair_less(bd, bp, ad, ap) : pair_less(ad, ap, bd, bp);
  const float td = swap ? bd : ad;
  const int tp = swap ? bp : ap;
  bd = swap ? ad : bd;
  bp = swap ? ap : bp;
  ad = td;
  ap = tp;
}

// One compare-exchange between lanes lane and lane ^ s (s < 32): the lane
// keeps the smaller pair of the two if keep_min, else the larger.
__device__ __forceinline__ void lane_cas(float& d, int& p, int s, bool keep_min) {
  const float od = __shfl_xor_sync(kAll, d, s);
  const int op = __shfl_xor_sync(kAll, p, s);
  const bool take = keep_min ? pair_less(od, op, d, p) : pair_less(d, p, od, op);
  d = take ? od : d;
  p = take ? op : p;
}

// Sort the warp's 32 * N pairs ascending (pair e in register e / 32 of lane
// e % 32): a bitonic sorting network.
template <int N>
__device__ __forceinline__ void warp_sort(float (&d)[N], int (&p)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * N; size <<= 1) {
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        if (s >= 32) {
          const int r2 = r ^ (s >> 5);
          if (r2 > r) pair_cas(d[r], p[r], d[r2], p[r2], ((r * 32) & size) == 0);
        } else {
          const bool up = ((r * 32 + lane) & size) == 0;
          lane_cas(d[r], p[r], s, ((lane & s) == 0) == up);
        }
      }
    }
  }
}

// The 32 * P smallest pairs of the sorted list (ld, lp) and the sorted queue
// (qd, qp) of 32 * T pairs, sorted, into the list: list[e] against
// queue[32 P - 1 - e] leaves a bitonic sequence, which a bitonic merge sorts.
template <int P, int T>
__device__ __forceinline__ void warp_merge(float (&ld)[P], int (&lp)[P],
                                           const float (&qd)[T],
                                           const int (&qp)[T]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int j = P - 1 - r;  // queue register of pair 32 P - 1 - e
    if (j < T) {
      const float od = __shfl_xor_sync(kAll, qd[j], 31);
      const int op = __shfl_xor_sync(kAll, qp[j], 31);
      const bool take = pair_less(od, op, ld[r], lp[r]);
      ld[r] = take ? od : ld[r];
      lp[r] = take ? op : lp[r];
    }
  }
#pragma unroll
  for (int s = 16 * P; s > 0; s >>= 1) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      if (s >= 32) {
        const int r2 = r ^ (s >> 5);
        if (r2 > r) pair_cas(ld[r], lp[r], ld[r2], lp[r2], true);
      } else {
        lane_cas(ld[r], lp[r], s, (lane & s) == 0);
      }
    }
  }
}

// A warp's query: the row, its augmented coordinates, its list of 32 * P
// slots (ascending; slots past k hold pairs above the k-th, or the starting
// (3e38, 0)) and this lane's queue of T pairs. Every member function but
// push is warp-collective.
template <int P, int T>
struct WarpQuery {
  float q[kDim];
  int row;
  float ld[P];
  int lp[P];
  float qd[T];
  int qi[T];
  int cnt;
  float bound;

  __device__ __forceinline__ void init_list() {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      ld[r] = kInvalid;
      lp[r] = 0;
    }
    cnt = 0;
    bound = filter_bound(kInvalid);
  }

  __device__ __forceinline__ void push(float d, int pos) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      qd[i] = i == cnt ? d : qd[i];
      qi[i] = i == cnt ? pos : qi[i];
    }
    ++cnt;
  }

  __device__ __forceinline__ void merge(int k) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      qd[i] = i < cnt ? qd[i] : CUDART_INF_F;
      qi[i] = i < cnt ? qi[i] : kNoPos;
    }
    warp_sort<T>(qd, qi);
    warp_merge<P, T>(ld, lp, qd, qi);
    cnt = 0;
    const int kr = (k - 1) >> 5;
    float kth = ld[0];
#pragma unroll
    for (int r = 1; r < P; ++r) kth = r == kr ? ld[r] : kth;
    bound = filter_bound(__shfl_sync(kAll, kth, (k - 1) & 31));
  }

  // Merge when some queue of the warp holds more than `above` pairs.
  __device__ __forceinline__ void merge_if(int above, int k) {
    if (__any_sync(kAll, cnt > above)) merge(k);
  }

  __device__ __forceinline__ void store(float* __restrict__ out_d,
                                        int32_t* __restrict__ out_i,
                                        size_t at, int k) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int j = r * 32 + lane;
      if (j < k) {
        out_d[at + j] = ld[r];
        out_i[at + j] = lp[r];
      }
    }
  }
};

// Filter the staged keys [0, n_pad) (positions pos0 + m), lane l taking
// keys l, l + 32, ..., kWarpKeys of them a step.
template <bool kDiag, int P, int T>
__device__ __forceinline__ void warp_scan(const float4* sa, const float4* sb,
                                          int n_pad, int pos0, int k,
                                          WarpQuery<P, T>& w) {
  const int lane = threadIdx.x & 31;
  for (int m = lane; m < n_pad; m += 32 * kWarpKeys) {
    w.merge_if(T - kWarpKeys, k);
    float d[kWarpKeys];
#pragma unroll
    for (int u = 0; u < kWarpKeys; ++u) {
      d[u] = aug_dot(w.q, sa[m + 32 * u], sb[m + 32 * u]);
    }
#pragma unroll
    for (int u = 0; u < kWarpKeys; ++u) {
      const int pos = pos0 + m + 32 * u;
      if (d[u] <= w.bound && (!kDiag || pos != w.row)) w.push(d[u], pos);
    }
  }
}

// grid (ceil(n_queries / W), splits), W = blockDim.x / 32 warps a block, a
// warp a query: block (x, y) folds keys [y * split_len, min((y + 1) *
// split_len, n_keys)) for queries [W x, W x + W) (warps past n_queries only
// stage keys). With one split it writes the output (n_queries, k); with
// more, partial lists to part (splits, n_queries, k), and the last block of
// each x merges them into the output.
template <int P, int T>
__global__ void __launch_bounds__(32 * kMaxWarps)
knn_full_warp_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                     int n_queries, int n_keys, int k, int exclude_diag,
                     int split_len, float* part_d, int32_t* part_i,
                     int32_t* tickets, float* out_d, int32_t* out_i) {
  __shared__ float4 sa[kWarpStage];
  __shared__ float4 sb[kWarpStage];
  __shared__ int last;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool active = row < n_queries;
  const int splits = gridDim.y;
  WarpQuery<P, T> w;
  w.row = row;
  load_query(qp, active ? row : 0, w.q);
  w.init_list();
  const int k0 = blockIdx.y * split_len;
  const int len = min(split_len, n_keys - k0);
  const float4* src = reinterpret_cast<const float4*>(kp) + 2 * (size_t)k0;
  const float4 nan4 = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                                  CUDART_NAN_F);
  for (int s0 = 0; s0 < len; s0 += kWarpStage) {
    const int n = min(kWarpStage, len - s0);
    const int n_pad = (n + 32 * kWarpKeys - 1) / (32 * kWarpKeys) * (32 * kWarpKeys);
    __syncthreads();  // the previous stage has been read by every warp
    for (int t = threadIdx.x; t < 2 * n_pad; t += blockDim.x) {
      // NaN rows pad the stage to whole steps: a NaN sum never passes.
      const float4 v = t < 2 * n ? src[2 * (size_t)s0 + t] : nan4;
      if (t & 1) {
        sb[t >> 1] = v;
      } else {
        sa[t >> 1] = v;
      }
    }
    __syncthreads();
    if (active) {
      const int pos0 = k0 + s0;
      if (exclude_diag && pos0 <= row && row < pos0 + n) {
        warp_scan<true>(sa, sb, n_pad, pos0, k, w);
      } else {
        warp_scan<false>(sa, sb, n_pad, pos0, k, w);
      }
    }
  }
  if (active) {
    w.merge_if(0, k);
    if (splits == 1) {
      w.store(out_d, out_i, (size_t)row * k, k);
    } else {
      w.store(part_d, part_i, ((size_t)blockIdx.y * n_queries + row) * k, k);
    }
  }
  if (splits == 1) return;

  // The last split block of these queries merges the partial lists.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last || !active) return;
  __threadfence();
  w.init_list();
  const int k_pad = (k + 32 * kWarpKeys - 1) / (32 * kWarpKeys) * (32 * kWarpKeys);
  for (int y = 0; y < splits; ++y) {
    const size_t at = ((size_t)y * n_queries + row) * k;
    for (int j0 = lane; j0 < k_pad; j0 += 32 * kWarpKeys) {
      w.merge_if(T - kWarpKeys, k);
#pragma unroll
      for (int u = 0; u < kWarpKeys; ++u) {
        const int j = j0 + 32 * u;
        if (j < k) {
          const float d = __ldcg(part_d + at + j);
          if (d <= w.bound) w.push(d, __ldcg(part_i + at + j));
        }
      }
    }
  }
  w.merge_if(0, k);
  w.store(out_d, out_i, (size_t)row * k, k);
}

template <int P>
cudaError_t launch_full_warp(const void* qp, const void* kp, int n_queries,
                             int n_keys, int k, int exclude_diag, int warps,
                             int splits, int split_len, void* part_d,
                             void* part_i, void* tickets, void* out_d,
                             void* out_i, cudaStream_t stream) {
  constexpr int T = P < kWarpQueueMin   ? kWarpQueueMin
                    : P > kWarpQueueMax ? kWarpQueueMax
                                        : P;
  if (warps < 1 || warps > kMaxWarps) return cudaErrorInvalidValue;
  const dim3 grid((n_queries + warps - 1) / warps, splits);
  knn_full_warp_kernel<P, T><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const float*>(qp), static_cast<const float*>(kp), n_queries,
      n_keys, k, exclude_diag, split_len, static_cast<float*>(part_d),
      static_cast<int32_t*>(part_i), static_cast<int32_t*>(tickets),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i));
  return cudaGetLastError();
}

}  // namespace

// The slot template the wrapper picked for k (fused_knn._slot_bucket): K > 0
// keeps k <= K slots in registers; -W keeps list rows in device memory, for
// k > 32, merged over windows of 32 * W pairs. Any other bucket is refused.
#define KNN_DISPATCH(launch, ...)                                          \
  if (bucket > 0 ? k > bucket : k <= 32) {                                 \
    return static_cast<int>(cudaErrorInvalidValue);                       \
  }                                                                        \
  switch (bucket) {                                                        \
    case 1: return static_cast<int>(launch<RegSlots<1>>(__VA_ARGS__));    \
    case 4: return static_cast<int>(launch<RegSlots<4>>(__VA_ARGS__));    \
    case 8: return static_cast<int>(launch<RegSlots<8>>(__VA_ARGS__));    \
    case 12: return static_cast<int>(launch<RegSlots<12>>(__VA_ARGS__));  \
    case 16: return static_cast<int>(launch<RegSlots<16>>(__VA_ARGS__));  \
    case 24: return static_cast<int>(launch<RegSlots<24>>(__VA_ARGS__));  \
    case 32: return static_cast<int>(launch<RegSlots<32>>(__VA_ARGS__));  \
    case -2: return static_cast<int>(launch<MemSlots<2>>(__VA_ARGS__));   \
    case -3: return static_cast<int>(launch<MemSlots<3>>(__VA_ARGS__));   \
    case -4: return static_cast<int>(launch<MemSlots<4>>(__VA_ARGS__));   \
    case -8: return static_cast<int>(launch<MemSlots<8>>(__VA_ARGS__));   \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

extern "C" {

// n_queries >= 1, n_rows = n_queries rounded up to a multiple of 128, k >= 1,
// n_rows * k < 2^31; out_d / out_i hold (n_rows, k), and with splits > 1
// part_d / part_i hold (splits, n_rows, k) and tickets n_rows / 128 zeros
// (the wrapper checks and allocates them).
int knn_full_launch(const void* qp, const void* kp, int n_queries, int n_keys,
                    int k, int bucket, int exclude_diag, int splits,
                    int split_len, void* part_d, void* part_i, void* tickets,
                    void* out_d, void* out_i, void* stream) {
  KNN_DISPATCH(launch_full, qp, kp, n_queries, n_keys, k, exclude_diag, splits,
               split_len, part_d, part_i, tickets, out_d, out_i,
               static_cast<cudaStream_t>(stream))
}

// The warp design: n_queries >= 1, 1 <= k <= 1024, n_queries * k < 2^31,
// 1 <= warps <= 8 (queries a block); out_d / out_i hold (n_queries, k), and
// with splits > 1 part_d / part_i hold (splits, n_queries, k) and tickets
// ceil(n_queries / warps) zeros (the wrapper checks and allocates them). The
// list has the least 32 * 2^i >= k slots.
int knn_full_warp_launch(const void* qp, const void* kp, int n_queries,
                         int n_keys, int k, int exclude_diag, int warps,
                         int splits, int split_len, void* part_d, void* part_i,
                         void* tickets, void* out_d, void* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KNN_WARP_CASE(P)                                                      \
  if (k <= 32 * (P)) {                                                        \
    return static_cast<int>(launch_full_warp<P>(                              \
        qp, kp, n_queries, n_keys, k, exclude_diag, warps, splits, split_len, \
        part_d, part_i, tickets, out_d, out_i, st));                          \
  }
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  KNN_WARP_CASE(1)
  KNN_WARP_CASE(2)
  KNN_WARP_CASE(4)
  KNN_WARP_CASE(8)
  KNN_WARP_CASE(16)
  KNN_WARP_CASE(32)
#undef KNN_WARP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// tile_q is a multiple of rows (128 or 256, the queries of a block); kt_live
// holds the live chunks of the pair list sorted by query tile, starts[t] ..
// starts[t + 1] those of tile t; items (n_items, 4) the blocks' work items,
// the split ones first, and part_d / part_i (split items * rows, k) their
// partial lists; tickets n_queries / rows zeros (the wrapper builds and
// checks them).
int knn_compact_launch(const void* qp, const void* kp, const void* kt_live,
                       const void* starts, const void* items, int n_items,
                       int rows, int n_queries, int n_keys, int tile_q,
                       int tile_m, int k, int bucket, int exclude_diag,
                       void* part_d, void* part_i, void* tickets, void* out_d,
                       void* out_i, void* stream) {
  KNN_DISPATCH(launch_compact, qp, kp, kt_live, starts, items, n_items, rows,
               n_queries, n_keys, tile_q, tile_m, k, exclude_diag, part_d,
               part_i, tickets, out_d, out_i, static_cast<cudaStream_t>(stream))
}

}  // extern "C"

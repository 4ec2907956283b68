// Exact single-nearest-neighbour kernels for Hopper (sm_90a).
//
// Each replaces one Pallas TPU kernel of cilantro_tpu/neighbors/pallas_nn.py
// and computes what that kernel computes:
//
//   nn1_fused_kernel    <- _nn1_kernel          (nn1_pallas)
//   nn1_masked_kernel   <- _nn1_kernel_masked   (_nn1_pallas_masked)
//   nn1_compact_kernel  <- _nn1_kernel_compact  (_nn1_pallas_compact)
//
// Inputs are augmented rows of 8 float32 (q^ = [-2q, |q|^2, 1, 0...],
// k^ = [k, 1, |k|^2, 0...], see fused_nn.py), so that the squared distance is
// one 8-term dot product (D + 2 terms carry data for D-dimensional points).
// For each query row q the kernels return
//
//   d[q]   = min over the visited keys m of  sum_{j=0..7} q^[q,j] * k^[m,j]
//   idx[q] = the smallest key position m that reaches it
//
// starting from (3e38, 0): a key whose sum is not below 3e38 (padding and
// masked keys carry 3e38 in the |k|^2 slot) never wins. The sum is taken
// left to right with __fmul_rn / __fadd_rn, which nvcc never contracts into
// FMAs, so the plain PyTorch versions (the same 8 products and 7 sums as
// separate float32 ops) agree bit for bit, indices included. A NaN sum
// (only an invalid query at 1e30 against an invalid key produces one, and
// the wrappers gate invalid queries) never wins.
//
// Keys are visited in ascending position with a strict '<', which gives the
// TPU kernels' tie rule (strict '<' across key chunks, smallest column within
// a chunk). The masked kernel visits the key chunks of tile_m keys that its
// (n_qt, n_mt) mask row allows; the compact kernel visits the live entries of
// its (qt, kt, flags) list (the row-major nonzeros of the mask, live ones
// first, padded by repeats of the last entry; flags bit 1 = live).
//
// What bounds them: arithmetic. For 3-D points a (query, key) pair needs
// 5 products, 4 sums and a compare, at best as FMAs on the CUDA cores
// (float32, no tensor cores, no TF32). The bytes are small: a block stages
// each key chunk through shared memory once for all its queries.
//
// All three share one design (the split kernels below):
//
// 1. D + 2 terms. The distance is templated on NT, the count of data
//    columns: 4 for 2-D points, 5 for 3-D, 8 for any row. The wrappers pass
//    NT = D + 2 for rows from _augment_queries / _augment_keys, whose columns
//    past D + 1 are +0 in both operands. Why the bits stay those of the
//    8-term sum: each dropped product is +0 * +0 = +0, and adding +0 leaves
//    a sum's bits unless the sum is -0. After term D the running sum is never
//    -0: term D is |q|^2 * k^[D] with k^[D] in {1, 0} and |q|^2 >= +0, so it
//    is >= +0 or NaN, and round-to-nearest gives -0 only for (-0) + (-0).
//    NaN stays NaN. The products by 1 stay (padding queries are all zeros,
//    padding keys have k^[D] = 0), so all D + 2 products are taken, with
//    __fmul_rn / __fadd_rn left to right as before.
// 2. R queries a thread (4, or 2 / 1 when a block of 128 R rows would not
//    fit in one query tile; 4 measured fastest on the H100, PERF.md §6; the
//    fused kernel's rows are one tile, which nn1_fused pads to 128, 256 or
//    a multiple of 512 rows): each staged key is read from shared memory
//    once for R pairs, staged as a float4 of columns 0-3
//    and a float (or a second float4) for the rest, so a key costs one or
//    two broadcast loads. kChains / R keys are in flight a thread: their
//    R distances each are independent chains, compared in key order after.
//    The compiled loop of the 3-D, R = 4 masked and compact instances (their
//    SASS, counted by tools/nn1_variants.py) issues 205 instructions for 4 keys x 4
//    queries, 12.8 a pair: 5 FMUL, 4 FADD, one FSETP and 1.9 SEL a pair,
//    5 LDS.128 for the 4 keys (the compiler joins their 4 column-4 floats
//    into one), the rest loop control; 2-D: 170 for 16 pairs, 10.6 a pair;
//    8 terms: 18.9. No local memory in these loops (the masked kernel keeps a few words of its window loop on the
//    stack).
// 3. Split work merged by a lexicographic minimum. With a strict '<' over
//    ascending keys from (3e38, 0), a fold's result is the lexicographic
//    minimum of (d, pos) over {(3e38, 0)} and the keys with d not NaN. So
//    any split of a query row's keys into parts, each folded alone and
//    merged by that minimum, gives the unsplit result bit for bit. The merge
//    is one 64-bit atomicMax a query a part on ~((order_key(d) << 32) | pos)
//    (order_key: the float bits mapped to an ascending uint32; no -0 reaches
//    it, by 1), in scratch that the launcher clears to 0 ("no key"), so it
//    needs no starting pattern; a plain read first skips the atomic when the
//    scratch already holds at least the part's value. A small kernel unpacks
//    the scratch to (dist, idx), 0 to (3e38, 0).
//    - Fused: every key is live, so contiguous key ranges balance exactly.
//      Blocks (query sub-block, split s) fold the keys [s * span, (s + 1) *
//      span), the last split the tail (the keys are not padded). The split
//      count aims at kFusedWaves times the resident blocks of the card over
//      the query blocks; span is a multiple of kFusedMinKeys (128: one key
//      a thread of the block stages them in one pass), so that no split is
//      all staging.
//    - Compact: a persistent grid (resident blocks of the card) takes items
//      (list entry, query sub-block) from a counter, each one key chunk for
//      128 R rows, so every item is the same work and no long run starts
//      last; the first dead entry ends the work. No binary search, no
//      read-back.
//    - Masked: blocks (query sub-block, split s) scan their tile's mask row
//      in windows of 128 columns, rank the live columns by a warp vote, and
//      take those whose rank is s modulo the split count (kWaves times the
//      resident blocks over the query blocks, at most n_mt): Morton order
//      puts a row's live columns side by side, so contiguous ranges would not
//      balance. No nonzero, no read-back.
// The TPU kernels carried a running best in VMEM scratch across a sequential
// grid of (query tile, key chunk) steps; here the parts run in parallel and
// only the atomic merge joins them.
//
// Each launcher enqueues on the caller's stream, does not synchronise, and
// returns the first CUDA error of its steps so that a refused launch is
// reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr float kInvalid = 3.0e38f;
constexpr unsigned kAll = 0xffffffffu;

// ---------------------------------------------------------------------------
// The split kernels: NT = D + 2 terms, R queries a thread and split work
// merged by a lexicographic minimum (see the header).
// ---------------------------------------------------------------------------

constexpr int kSplitStage = 512;  // keys staged in shared memory at a time
constexpr int kChains = 16;       // independent distances in flight a thread
constexpr int kWaves = 16;        // masked kernel: blocks per resident slot
constexpr int kFusedWaves = 4;    // fused kernel: blocks per resident slot, at least
constexpr int kFusedMinKeys = kThreads;  // fused kernel: the least keys a split

// The NT live columns of kSplitStage staged keys: columns 0-3 as one float4,
// the rest as one float (NT = 5) or one more float4 (NT = 8), so that a
// thread reads a key with one or two broadcast loads.
template <int NT> struct Stage;

template <> struct Stage<4> {
  float4 a[kSplitStage];
  __device__ __forceinline__ void put(int m, const float4* row) { a[m] = __ldg(row); }
  __device__ __forceinline__ void get(int m, float (&k)[4]) const {
    const float4 x = a[m];
    k[0] = x.x; k[1] = x.y; k[2] = x.z; k[3] = x.w;
  }
};

template <> struct Stage<5> {
  float4 a[kSplitStage];
  float b[kSplitStage];
  __device__ __forceinline__ void put(int m, const float4* row) {
    a[m] = __ldg(row);
    b[m] = __ldg(reinterpret_cast<const float*>(row) + 4);
  }
  __device__ __forceinline__ void get(int m, float (&k)[5]) const {
    const float4 x = a[m];
    k[0] = x.x; k[1] = x.y; k[2] = x.z; k[3] = x.w; k[4] = b[m];
  }
};

template <> struct Stage<8> {
  float4 a[kSplitStage];
  float4 b[kSplitStage];
  __device__ __forceinline__ void put(int m, const float4* row) {
    a[m] = __ldg(row);
    b[m] = __ldg(row + 1);
  }
  __device__ __forceinline__ void get(int m, float (&k)[8]) const {
    const float4 x = a[m], y = b[m];
    k[0] = x.x; k[1] = x.y; k[2] = x.z; k[3] = x.w;
    k[4] = y.x; k[5] = y.y; k[6] = y.z; k[7] = y.w;
  }
};

// sum_{j < NT} q[j] * k[j], left to right, one rounding per product and sum.
template <int NT>
__device__ __forceinline__ float dist_terms(const float (&q)[NT], const float (&k)[NT]) {
  float acc = __fmul_rn(q[0], k[0]);
#pragma unroll
  for (int j = 1; j < NT; ++j) acc = __fadd_rn(acc, __fmul_rn(q[j], k[j]));
  return acc;
}

// A thread's R query rows, row0 + r * kThreads + threadIdx.x, and their
// running bests.
template <int NT, int R>
struct Rows {
  float q[R][NT];
  float bd[R];
  int bi[R];

  __device__ __forceinline__ void load(const float* __restrict__ qp, int row0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4* src =
          reinterpret_cast<const float4*>(qp) + 2 * (size_t)(row0 + r * kThreads + threadIdx.x);
      const float4 a = __ldg(src);
      q[r][0] = a.x; q[r][1] = a.y; q[r][2] = a.z; q[r][3] = a.w;
      if constexpr (NT == 5) q[r][4] = __ldg(reinterpret_cast<const float*>(src) + 4);
      if constexpr (NT == 8) {
        const float4 b = __ldg(src + 1);
        q[r][4] = b.x; q[r][5] = b.y; q[r][6] = b.z; q[r][7] = b.w;
      }
      bd[r] = kInvalid;
      bi[r] = 0;
    }
  }
};

// Fold n staged keys at positions pos0.. into the bests, ascending, with a
// strict '<'. kChains / R keys are in flight at once: their R distances
// each are independent, and they are compared in key order afterwards.
template <int NT, int R>
__device__ __forceinline__ void fold_stage(const Stage<NT>& st, int n, int pos0,
                                           Rows<NT, R>& w) {
  constexpr int U = kChains / R;
  int m = 0;
  for (; m + U <= n; m += U) {
    float d[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float k[NT];
      st.get(m + u, k);
#pragma unroll
      for (int r = 0; r < R; ++r) d[u][r] = dist_terms<NT>(w.q[r], k);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (d[u][r] < w.bd[r]) {
          w.bd[r] = d[u][r];
          w.bi[r] = pos0 + m + u;
        }
      }
    }
  }
  for (; m < n; ++m) {
    float k[NT];
    st.get(m, k);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float d = dist_terms<NT>(w.q[r], k);
      if (d < w.bd[r]) {
        w.bd[r] = d;
        w.bi[r] = pos0 + m;
      }
    }
  }
}

// Fold the keys [k0, k0 + len). Every thread of the block calls it with the
// same arguments (it synchronises).
template <int NT, int R>
__device__ void fold_chunk(const float* __restrict__ kp, int k0, int len,
                           Rows<NT, R>& w, Stage<NT>& st) {
  const float4* src = reinterpret_cast<const float4*>(kp) + 2 * (size_t)k0;
  for (int s0 = 0; s0 < len; s0 += kSplitStage) {
    const int n = min(kSplitStage, len - s0);
    __syncthreads();  // the previous stage has been read by every thread
    for (int t = threadIdx.x; t < n; t += kThreads) st.put(t, src + 2 * (size_t)(s0 + t));
    __syncthreads();
    fold_stage<NT, R>(st, n, k0 + s0, w);
  }
}

// The float's bits as an unsigned key in the float order (no -0 reaches it).
__device__ __forceinline__ uint32_t order_key(float d) {
  const uint32_t b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Merge the bests into best[row] = ~pack(order_key(d), pos): the running
// lexicographic minimum of (d, pos) as a maximum of its complement, so that
// 0 (the cleared scratch) stands for "no key yet". A part that found no key
// below 3e38 has nothing to add. best[] only grows, so a read that is
// already at least this part's value (stale or not) makes the atomic
// needless.
template <int NT, int R>
__device__ __forceinline__ void merge_rows(const Rows<NT, R>& w, int row0,
                                           unsigned long long* __restrict__ best) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (w.bd[r] < kInvalid) {
      unsigned long long* slot = best + row0 + r * kThreads + threadIdx.x;
      const unsigned long long x =
          ~((static_cast<unsigned long long>(order_key(w.bd[r])) << 32) |
            static_cast<uint32_t>(w.bi[r]));
      if (x > __ldcg(slot)) atomicMax(slot, x);
    }
  }
}

// Block (x, s) takes kThreads * R query rows and folds the keys [s * span,
// min(n_keys, (s + 1) * span)).
template <int NT, int R>
__global__ void __launch_bounds__(kThreads)
nn1_fused_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                 int n_keys, int span, unsigned long long* __restrict__ best) {
  __shared__ Stage<NT> st;
  const int row0 = blockIdx.x * (kThreads * R);
  const int k0 = blockIdx.y * span;
  Rows<NT, R> w;
  w.load(qp, row0);
  fold_chunk<NT, R>(kp, k0, min(span, n_keys - k0), w, st);
  merge_rows<NT, R>(w, row0, best);
}

// #{r in [0, rank) : r = s (mod splits)}
__device__ __forceinline__ int taken_before(int rank, int s, int splits) {
  return (rank + splits - 1 - s) / splits;
}

// Block (x, s) takes kThreads * R rows of one query tile and, of the live
// columns of the tile's mask row, those whose rank among them is s modulo
// gridDim.y, in ascending order. The row is read in windows of kThreads
// columns; a warp vote and the warps' counts rank the live ones.
template <int NT, int R>
__global__ void __launch_bounds__(kThreads)
nn1_masked_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                  const int32_t* __restrict__ mask, int n_mt, int tile_q,
                  int tile_m, unsigned long long* __restrict__ best) {
  __shared__ Stage<NT> st;
  __shared__ int cols[kThreads];
  __shared__ int warp_live[kThreads / 32];
  const int splits = gridDim.y, s = blockIdx.y;
  const int row0 = blockIdx.x * (kThreads * R);
  const int32_t* mrow = mask + (size_t)(row0 / tile_q) * n_mt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Rows<NT, R> w;
  w.load(qp, row0);
  int base = 0;  // live columns of the row before this window
  for (int c0 = 0; c0 < n_mt; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    const bool live = c < n_mt && __ldg(mrow + c) != 0;
    const unsigned vote = __ballot_sync(kAll, live);
    __syncthreads();  // the previous window's columns have been read
    if (lane == 0) warp_live[warp] = __popc(vote);
    __syncthreads();
    int before = base, total = 0;
#pragma unroll
    for (int v = 0; v < kThreads / 32; ++v) {
      before += v < warp ? warp_live[v] : 0;
      total += warp_live[v];
    }
    const int rank = before + __popc(vote & ((1u << lane) - 1u));
    const int first = taken_before(base, s, splits);
    if (live && rank % splits == s) cols[taken_before(rank, s, splits) - first] = c;
    const int n_taken = taken_before(base + total, s, splits) - first;
    __syncthreads();
    for (int j = 0; j < n_taken; ++j) fold_chunk<NT, R>(kp, cols[j] * tile_m, tile_m, w, st);
    base += total;
  }
  merge_rows<NT, R>(w, row0, best);
}

// A persistent grid: each block takes items (list entry e, query sub-block
// b), item = e * n_sub + b, from a counter, and folds entry e's key chunk
// for kThreads * R rows of e's query tile. The live entries form a prefix
// of the list (the padding repeats sit at its end), so the first dead entry
// ends the work.
template <int NT, int R>
__global__ void __launch_bounds__(kThreads)
nn1_compact_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                   const int32_t* __restrict__ qt_list,
                   const int32_t* __restrict__ kt_list,
                   const int32_t* __restrict__ flags, int budget, int tile_q,
                   int tile_m, unsigned long long* __restrict__ best,
                   int* __restrict__ next_item) {
  __shared__ Stage<NT> st;
  __shared__ int item_s;
  const int n_sub = tile_q / (kThreads * R);
  const int n_items = budget * n_sub;  // below 2^31 (the wrapper checks)
  for (;;) {
    // Every thread read the last item before the last fold's first barrier.
    if (threadIdx.x == 0) item_s = atomicAdd(next_item, 1);
    __syncthreads();
    const int item = item_s;
    if (item >= n_items) break;
    const int e = item / n_sub;
    if ((__ldg(flags + e) & 2) == 0) break;
    const int row0 = __ldg(qt_list + e) * tile_q + (item - e * n_sub) * (kThreads * R);
    Rows<NT, R> w;
    w.load(qp, row0);
    fold_chunk<NT, R>(kp, __ldg(kt_list + e) * tile_m, tile_m, w, st);
    merge_rows<NT, R>(w, row0, best);
  }
}

// best[] back to (dist, idx); a row that no part reached keeps (3e38, 0).
__global__ void nn1_unpack_kernel(const unsigned long long* __restrict__ best,
                                  int n, float* __restrict__ out_d,
                                  int32_t* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const unsigned long long x = best[row];
  if (x == 0) {
    out_d[row] = kInvalid;
    out_i[row] = 0;
    return;
  }
  const unsigned long long p = ~x;
  out_d[row] = from_order_key(static_cast<uint32_t>(p >> 32));
  out_i[row] = static_cast<int32_t>(static_cast<uint32_t>(p));
}

struct SplitArgs {
  const float* qp;
  const float* kp;
  const int32_t* mask;     // masked: the (n_qt, n_mt) mask
  const int32_t* qt_list;  // compact: the pair list
  const int32_t* kt_list;
  const int32_t* flags;
  int budget;
  int n_queries;
  int n_keys;  // fused
  int n_mt;
  int tile_q;
  int tile_m;
  unsigned long long* best;  // n_queries (+ 1 for the compact item counter)
  cudaStream_t stream;
  int* design;  // out, may be null: rows a thread, splits, blocks
};

int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return max(1, sms * per_sm);
}

template <int NT, int R>
void launch_fused(SplitArgs& a) {
  const int q_blocks = a.n_queries / (kThreads * R);
  const int slots = resident_blocks(reinterpret_cast<const void*>(nn1_fused_kernel<NT, R>));
  const int most = min(max(1, (a.n_keys + kFusedMinKeys - 1) / kFusedMinKeys), 65535);
  const int want = (kFusedWaves * slots + q_blocks - 1) / q_blocks;
  int span = (a.n_keys + min(want, most) - 1) / min(want, most);
  span = max(kFusedMinKeys, (span + kFusedMinKeys - 1) / kFusedMinKeys * kFusedMinKeys);
  const int splits = max(1, (a.n_keys + span - 1) / span);
  nn1_fused_kernel<NT, R><<<dim3(q_blocks, splits), kThreads, 0, a.stream>>>(
      a.qp, a.kp, a.n_keys, span, a.best);
  if (a.design) {
    a.design[0] = R;
    a.design[1] = splits;
    a.design[2] = q_blocks * splits;
  }
}

template <int NT, int R>
void launch_masked(SplitArgs& a) {
  const int q_blocks = a.n_queries / (kThreads * R);
  const int slots = resident_blocks(reinterpret_cast<const void*>(nn1_masked_kernel<NT, R>));
  const int splits = max(1, min((kWaves * slots + q_blocks - 1) / q_blocks, min(a.n_mt, 65535)));
  nn1_masked_kernel<NT, R><<<dim3(q_blocks, splits), kThreads, 0, a.stream>>>(
      a.qp, a.kp, a.mask, a.n_mt, a.tile_q, a.tile_m, a.best);
  if (a.design) {
    a.design[0] = R;
    a.design[1] = splits;
    a.design[2] = q_blocks * splits;
  }
}

template <int NT, int R>
void launch_compact(SplitArgs& a) {
  const int n_items = a.budget * (a.tile_q / (kThreads * R));
  const int grid = max(1, min(n_items, resident_blocks(
      reinterpret_cast<const void*>(nn1_compact_kernel<NT, R>))));
  nn1_compact_kernel<NT, R><<<grid, kThreads, 0, a.stream>>>(
      a.qp, a.kp, a.qt_list, a.kt_list, a.flags, a.budget, a.tile_q, a.tile_m,
      a.best, reinterpret_cast<int*>(a.best + a.n_queries));
  if (a.design) {
    a.design[0] = R;
    a.design[1] = 1;
    a.design[2] = grid;
  }
}

// The rows a thread takes: the largest of 4, 2, 1 that keeps a block of
// kThreads * R rows inside one query tile (4 measured fastest on the H100).
int rows_per_thread(int tile_q) {
  for (int r = 4; r > 1; r /= 2) {
    if (tile_q % (kThreads * r) == 0) return r;
  }
  return 1;
}

enum Kind { kFused, kMasked, kCompact };

template <int NT, int R>
void launch_kind(Kind kind, SplitArgs& a) {
  switch (kind) {
    case kFused: launch_fused<NT, R>(a); break;
    case kMasked: launch_masked<NT, R>(a); break;
    default: launch_compact<NT, R>(a); break;
  }
}

template <int NT>
void launch_by_rows(Kind kind, int rows, SplitArgs& a) {
  switch (rows) {
    case 4: launch_kind<NT, 4>(kind, a); break;
    case 2: launch_kind<NT, 2>(kind, a); break;
    default: launch_kind<NT, 1>(kind, a); break;
  }
}

// Clear the scratch (and the compact kernel's item counter behind it), run
// the split kernel, unpack: the first CUDA error of the three steps. The
// fused kernel's query rows are one tile.
int launch_split(Kind kind, int terms, SplitArgs& a, float* out_d,
                 int32_t* out_i) {
  if (terms != 4 && terms != 5 && terms != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_queries == 0) return 0;
  const bool counter = kind == kCompact;
  cudaError_t err = cudaMemsetAsync(
      a.best, 0, sizeof(unsigned long long) * (a.n_queries + (counter ? 1 : 0)), a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = rows_per_thread(kind == kFused ? a.n_queries : a.tile_q);
  switch (terms) {
    case 4: launch_by_rows<4>(kind, rows, a); break;
    case 5: launch_by_rows<5>(kind, rows, a); break;
    default: launch_by_rows<8>(kind, rows, a); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn1_unpack_kernel<<<(a.n_queries + 255) / 256, 256, 0, a.stream>>>(
      a.best, a.n_queries, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n_queries is a multiple of 128 (the wrappers check it). best: n_queries
// 64-bit words of scratch; design: null, or 3 ints for the rows a thread,
// the key splits and blocks.
int nn1_fused_launch(const void* qp, const void* kp, int n_queries,
                     int n_keys, int terms, void* best, void* out_d,
                     void* out_i, void* design, void* stream) {
  SplitArgs a{};
  a.qp = static_cast<const float*>(qp);
  a.kp = static_cast<const float*>(kp);
  a.n_queries = n_queries;
  a.n_keys = n_keys;
  a.best = static_cast<unsigned long long*>(best);
  a.stream = static_cast<cudaStream_t>(stream);
  a.design = static_cast<int*>(design);
  return launch_split(kFused, terms, a, static_cast<float*>(out_d),
                      static_cast<int32_t*>(out_i));
}

// best: n_queries (+ 1 for the compact kernel) 64-bit words of scratch;
// design: null, or 3 ints for the rows a thread, the key splits and blocks.
int nn1_masked_launch(const void* qp, const void* kp, const void* mask,
                      int n_queries, int n_mt, int tile_q, int tile_m,
                      int terms, void* best, void* out_d, void* out_i,
                      void* design, void* stream) {
  SplitArgs a{};
  a.qp = static_cast<const float*>(qp);
  a.kp = static_cast<const float*>(kp);
  a.mask = static_cast<const int32_t*>(mask);
  a.n_queries = n_queries;
  a.n_mt = n_mt;
  a.tile_q = tile_q;
  a.tile_m = tile_m;
  a.best = static_cast<unsigned long long*>(best);
  a.stream = static_cast<cudaStream_t>(stream);
  a.design = static_cast<int*>(design);
  return launch_split(kMasked, terms, a, static_cast<float*>(out_d),
                      static_cast<int32_t*>(out_i));
}

int nn1_compact_launch(const void* qp, const void* kp, const void* qt_list,
                       const void* kt_list, const void* flags, int budget,
                       int n_queries, int tile_q, int tile_m, int terms,
                       void* best, void* out_d, void* out_i, void* design,
                       void* stream) {
  SplitArgs a{};
  a.qp = static_cast<const float*>(qp);
  a.kp = static_cast<const float*>(kp);
  a.qt_list = static_cast<const int32_t*>(qt_list);
  a.kt_list = static_cast<const int32_t*>(kt_list);
  a.flags = static_cast<const int32_t*>(flags);
  a.budget = budget;
  a.n_queries = n_queries;
  a.tile_q = tile_q;
  a.tile_m = tile_m;
  a.best = static_cast<unsigned long long*>(best);
  a.stream = static_cast<cudaStream_t>(stream);
  a.design = static_cast<int*>(design);
  return launch_split(kCompact, terms, a, static_cast<float*>(out_d),
                      static_cast<int32_t*>(out_i));
}

}  // extern "C"

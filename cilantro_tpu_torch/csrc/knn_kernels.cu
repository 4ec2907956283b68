// Exact k-nearest-neighbour kernels for Hopper (sm_90a).
//
// Each replaces one Pallas TPU kernel of cilantro_tpu/neighbors/pallas_nn.py
// and computes what that kernel computes:
//
//   knn_full_kernel     <- _knn_kernel          (_knn_pallas_full, knn_pallas)
//   knn_compact_kernel  <- _knn_kernel_compact  (_knn_pallas_compact)
//
// Inputs are augmented rows of 8 float32 (q^ = [-2q, |q|^2, 1, 0...],
// k^ = [k, 1, |k|^2, 0...], see fused_nn.py), so that the squared distance is
// one 8-term dot product, summed left to right with __fmul_rn / __fadd_rn
// (never contracted into FMAs), exactly as the nn1 kernels and the plain
// PyTorch versions in fused_knn.py sum it. For each query row the kernels
// return the k smallest (distance, key position) pairs over the visited keys
// in lexicographic order, ascending, starting from (3e38, 0) in every slot:
//
// - keys are visited in ascending position, and a key enters only if its
//   distance is strictly below the current k-th, inserted after every slot
//   whose distance is <= its own. That is the TPU kernels' tie rule
//   (_fold_block_topk extracts the first minimum of a chunk and inserts it
//   after every slot <= it; `dist < bound` drops a key equal to the k-th);
// - a NaN sum never enters, nor does a sum >= 3e38 (masked and padding keys
//   carry 3e38 in the |k|^2 slot);
// - with exclude_diag the key whose position equals the query's row is
//   skipped (_diag_mask: same-cloud searches drop the self pair).
//
// The full kernel visits every key. The compact kernel visits the key chunks
// of tile_m keys that the live entries (flags bit 1) of its (qt, kt, flags)
// list name for the block's query tile; the list is sorted by query tile and
// each block finds its run by binary search. A query tile that no live entry
// names keeps the starting state (the TPU kernel leaves those rows
// undefined; knn_pruned's `visited` gate never reads them).
//
// Slots. Each thread keeps its query's k slots in dynamic shared memory,
// slot j of thread t at [j * 128 + t] (a warp's threads touch consecutive
// banks), while 128 * k * 8 bytes fit beside the key stage; above that
// (k > kMaxSharedK) the slots live in the output rows in device memory. Both
// go through the same code with a pointer and a stride, so every k >= 1 is
// served. The current k-th distance stays in a register: most keys cost the
// distance and one compare.
//
// What bounds them: arithmetic. Per visited (query, key) pair of 3-D points
// the function needs 5 products, 4 sums and a compare (10 operations; the
// other 3 products and sums multiply zero padding), the top-k insertion on
// top for the few keys that enter; at 67 TFLOP/s float32 off the tensor cores
// (an FMA counted as two) that is the least time. These kernels issue the 8
// products and 7 sums unfused for bit-exactness, on one dependent add chain
// per query, so they cannot reach it. The bytes are small: each block stages
// the keys through shared memory once for 128 queries. Design: one thread per
// query, 128 queries per block (all inside one query tile of tile_q rows),
// keys staged 256 at a time as float4 pairs and read by every thread as a
// broadcast. The TPU design carried the k-slot running best in VMEM scratch
// across a sequential grid of (query tile, key chunk) steps and extracted
// minima from whole (TQ, TM) blocks; here the loop over key chunks runs
// inside the block and each key is inserted as it comes.
//
// Each launcher enqueues on the caller's stream, does not synchronise, and
// returns the first CUDA error of its setup or launch, so that a refused
// launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 8;
constexpr int kThreads = 128;  // queries per block, one per thread
constexpr int kStage = 256;    // keys staged in shared memory at a time
constexpr int kMaxSharedK = 192;  // 128 * 192 * 8 B = 192 KiB of slots at most
constexpr float kInvalid = 3.0e38f;

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

// A query's k ascending slots: distance and key position of slot j at
// d[j * stride], i[j * stride] (shared or device memory).
struct Slots {
  float* d;
  int32_t* i;
  int stride;
  int k;
  float kth;  // d[(k - 1) * stride]

  __device__ void init() {
    for (int j = 0; j < k; ++j) {
      d[j * stride] = kInvalid;
      i[j * stride] = 0;
    }
    kth = kInvalid;
  }

  // Insert (dist, pos), dist < kth: after every slot <= dist, dropping the
  // last.
  __device__ void insert(float dist, int pos) {
    int j = k - 1;
    while (j > 0) {
      const float prev = d[(j - 1) * stride];
      if (!(prev > dist)) break;
      d[j * stride] = prev;
      i[j * stride] = i[(j - 1) * stride];
      --j;
    }
    d[j * stride] = dist;
    i[j * stride] = pos;
    kth = d[(k - 1) * stride];
  }
};

__device__ __forceinline__ Slots make_slots(unsigned char* dyn, bool in_shared,
                                            int k, int row,
                                            float* __restrict__ out_d,
                                            int32_t* __restrict__ out_i) {
  Slots s;
  s.k = k;
  if (in_shared) {
    float* sd = reinterpret_cast<float*>(dyn);
    int32_t* si = reinterpret_cast<int32_t*>(dyn + (size_t)kThreads * k * 4);
    s.d = sd + threadIdx.x;
    s.i = si + threadIdx.x;
    s.stride = kThreads;
  } else {
    s.d = out_d + (size_t)row * k;
    s.i = out_i + (size_t)row * k;
    s.stride = 1;
  }
  s.init();
  return s;
}

__device__ __forceinline__ void write_slots(const Slots& s, bool in_shared,
                                            int row, float* __restrict__ out_d,
                                            int32_t* __restrict__ out_i) {
  if (!in_shared) return;  // the slots are the output rows
  for (int j = 0; j < s.k; ++j) {
    out_d[(size_t)row * s.k + j] = s.d[j * s.stride];
    out_i[(size_t)row * s.k + j] = s.i[j * s.stride];
  }
}

// Fold keys [k0, k0 + len) into the slots in ascending order. Every thread
// of the block calls it with the same k0 and len (it synchronises).
__device__ void fold_keys(const float* __restrict__ kp, int k0, int len,
                          const float (&q)[kDim], int row, bool exclude_diag,
                          Slots& s, float4* stage) {
  const float4* src = reinterpret_cast<const float4*>(kp) + 2 * (size_t)k0;
  for (int s0 = 0; s0 < len; s0 += kStage) {
    const int n = min(kStage, len - s0);
    __syncthreads();  // the previous stage has been read by every thread
    for (int t = threadIdx.x; t < 2 * n; t += blockDim.x) {
      stage[t] = src[2 * (size_t)s0 + t];
    }
    __syncthreads();
    for (int m = 0; m < n; ++m) {
      const float d = aug_dot(q, stage[2 * m], stage[2 * m + 1]);
      if (d < s.kth) {
        const int pos = k0 + s0 + m;
        if (!(exclude_diag && pos == row)) s.insert(d, pos);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn_full_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                int n_keys, int k, int exclude_diag, int in_shared,
                float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  __shared__ float4 stage[2 * kStage];
  extern __shared__ unsigned char dyn[];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  float q[kDim];
  load_query(qp, row, q);
  Slots s = make_slots(dyn, in_shared != 0, k, row, out_d, out_i);
  fold_keys(kp, 0, n_keys, q, row, exclude_diag != 0, s, stage);
  write_slots(s, in_shared != 0, row, out_d, out_i);
}

__global__ void __launch_bounds__(kThreads)
knn_compact_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                   const int32_t* __restrict__ qt_list,
                   const int32_t* __restrict__ kt_list,
                   const int32_t* __restrict__ flags, int budget, int tile_q,
                   int tile_m, int k, int exclude_diag, int in_shared,
                   float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  __shared__ float4 stage[2 * kStage];
  extern __shared__ unsigned char dyn[];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int qt = (blockIdx.x * kThreads) / tile_q;
  // This query tile's run [begin, end) of the qt-sorted list.
  int lo = 0, hi = budget;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (qt_list[mid] < qt) lo = mid + 1; else hi = mid;
  }
  const int begin = lo;
  hi = budget;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (qt_list[mid] <= qt) lo = mid + 1; else hi = mid;
  }
  const int end = lo;
  float q[kDim];
  load_query(qp, row, q);
  Slots s = make_slots(dyn, in_shared != 0, k, row, out_d, out_i);
  for (int e = begin; e < end; ++e) {
    if (flags[e] & 2) {
      fold_keys(kp, kt_list[e] * tile_m, tile_m, q, row, exclude_diag != 0, s,
                stage);
    }
  }
  write_slots(s, in_shared != 0, row, out_d, out_i);
}

// Dynamic shared memory for k slots, 0 when they go to device memory; opts
// the kernel in above the default 48 KiB.
template <typename Kernel>
cudaError_t slot_bytes(Kernel kernel, int k, int* in_shared, size_t* bytes) {
  *in_shared = k <= kMaxSharedK;
  *bytes = *in_shared ? (size_t)kThreads * k * 8 : 0;
  if (*bytes == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

}  // namespace

extern "C" {

// n_queries is a multiple of 128, k >= 1 and n_queries * k < 2^31 (the
// wrappers check them).
int knn_full_launch(const void* qp, const void* kp, int n_queries, int n_keys,
                    int k, int exclude_diag, void* out_d, void* out_i,
                    void* stream) {
  int in_shared;
  size_t bytes;
  cudaError_t err = slot_bytes(knn_full_kernel, k, &in_shared, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_full_kernel<<<n_queries / kThreads, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qp), static_cast<const float*>(kp), n_keys, k,
      exclude_diag, in_shared, static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

int knn_compact_launch(const void* qp, const void* kp, const void* qt_list,
                       const void* kt_list, const void* flags, int budget,
                       int n_queries, int tile_q, int tile_m, int k,
                       int exclude_diag, void* out_d, void* out_i,
                       void* stream) {
  int in_shared;
  size_t bytes;
  cudaError_t err = slot_bytes(knn_compact_kernel, k, &in_shared, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_compact_kernel<<<n_queries / kThreads, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qp), static_cast<const float*>(kp),
      static_cast<const int32_t*>(qt_list),
      static_cast<const int32_t*>(kt_list),
      static_cast<const int32_t*>(flags), budget, tile_q, tile_m, k,
      exclude_diag, in_shared, static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

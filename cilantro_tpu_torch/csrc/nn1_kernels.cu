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
// one 8-term dot product. For each query row q the kernels return
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
// its (qt, kt, flags) list, which is sorted by query tile (the row-major
// nonzeros of the mask, padded by repeats of the last entry; flags bit 1 =
// live). Each block finds its run in that list by binary search.
//
// What bounds them: arithmetic. For 3-D points a (query, key) pair needs
// 5 products, 4 sums and a compare (the other 3 products and sums multiply
// zero padding), at best as FMAs on the CUDA cores (float32, no tensor
// cores, no TF32); these kernels issue 8 products, 7 sums and a compare,
// unfused for bit-exactness. The bytes are small, since each block stages the keys of a chunk through
// shared memory once for 128 queries. Design: one thread per query, 128
// queries per block (all inside one query tile of tile_q rows), keys staged
// 256 at a time as float4 pairs and read by every thread as a broadcast. The
// TPU design carried a running best in VMEM scratch across a sequential grid
// of (query tile, key chunk) steps; here the loop over key chunks runs inside
// the block, so no state carries between blocks.
//
// Each launcher enqueues on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 8;
constexpr int kThreads = 128;  // queries per block, one per thread
constexpr int kStage = 256;    // keys staged in shared memory at a time
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

// Fold keys [k0, k0 + len) into (bd, bi) in ascending order. Every thread
// of the block calls it with the same k0 and len (it synchronises).
__device__ void fold_keys(const float* __restrict__ kp, int k0, int len,
                          const float (&q)[kDim], float& bd, int& bi,
                          float4* stage) {
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
      if (d < bd) {
        bd = d;
        bi = k0 + s0 + m;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nn1_fused_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                 int n_keys, float* __restrict__ out_d,
                 int32_t* __restrict__ out_i) {
  __shared__ float4 stage[2 * kStage];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  float q[kDim];
  load_query(qp, row, q);
  float bd = kInvalid;
  int bi = 0;
  fold_keys(kp, 0, n_keys, q, bd, bi, stage);
  out_d[row] = bd;
  out_i[row] = bi;
}

__global__ void __launch_bounds__(kThreads)
nn1_masked_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                  const int32_t* __restrict__ mask, int n_mt, int tile_q,
                  int tile_m, float* __restrict__ out_d,
                  int32_t* __restrict__ out_i) {
  __shared__ float4 stage[2 * kStage];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int qt = (blockIdx.x * kThreads) / tile_q;
  const int32_t* mrow = mask + (size_t)qt * n_mt;
  float q[kDim];
  load_query(qp, row, q);
  float bd = kInvalid;
  int bi = 0;
  for (int kt = 0; kt < n_mt; ++kt) {
    if (mrow[kt] != 0) fold_keys(kp, kt * tile_m, tile_m, q, bd, bi, stage);
  }
  out_d[row] = bd;
  out_i[row] = bi;
}

__global__ void __launch_bounds__(kThreads)
nn1_compact_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                   const int32_t* __restrict__ qt_list,
                   const int32_t* __restrict__ kt_list,
                   const int32_t* __restrict__ flags, int budget, int tile_q,
                   int tile_m, float* __restrict__ out_d,
                   int32_t* __restrict__ out_i) {
  __shared__ float4 stage[2 * kStage];
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
  float bd = kInvalid;
  int bi = 0;
  for (int s = begin; s < end; ++s) {
    if (flags[s] & 2) fold_keys(kp, kt_list[s] * tile_m, tile_m, q, bd, bi, stage);
  }
  out_d[row] = bd;
  out_i[row] = bi;
}

}  // namespace

extern "C" {

// n_queries is a multiple of 128 (the wrappers check it).
int nn1_fused_launch(const void* qp, const void* kp, int n_queries,
                     int n_keys, void* out_d, void* out_i, void* stream) {
  nn1_fused_kernel<<<n_queries / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qp), static_cast<const float*>(kp), n_keys,
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

int nn1_masked_launch(const void* qp, const void* kp, const void* mask,
                      int n_queries, int n_mt, int tile_q, int tile_m,
                      void* out_d, void* out_i, void* stream) {
  nn1_masked_kernel<<<n_queries / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qp), static_cast<const float*>(kp),
      static_cast<const int32_t*>(mask), n_mt, tile_q, tile_m,
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

int nn1_compact_launch(const void* qp, const void* kp, const void* qt_list,
                       const void* kt_list, const void* flags, int budget,
                       int n_queries, int tile_q, int tile_m, void* out_d,
                       void* out_i, void* stream) {
  nn1_compact_kernel<<<n_queries / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qp), static_cast<const float*>(kp),
      static_cast<const int32_t*>(qt_list),
      static_cast<const int32_t*>(kt_list),
      static_cast<const int32_t*>(flags), budget, tile_q, tile_m,
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The pool pipeline's wide-row gather for Hopper (sm_90a).
//
//   coalesced_gather_kernel  <- _make_kernel / _window_fetch
//                               (cilantro_tpu/core/coalesced.py, coalesced_gather)
//
// out[i, :] = src[clamp(idx[i], 0, C-1), :] for float32 rows of width 8 or
// 16. A copy: the output equals the plain gather bit for bit on every row,
// wildcards (idx < 0 -> row 0) and indices >= C (-> row C-1) included.
//
// Bound by device-memory bytes: per output row it reads one 4-byte index
// and 32 or 64 bytes of source and writes as many, with no arithmetic.
//
// Why the TPU design is not carried over: the TPU paid one DMA descriptor
// per gathered row, so its kernel planned runs of consecutive indices,
// fetched an aligned (2, 128)-lane window per run and realigned lanes with
// a one-hot matmul. On Hopper a gathered row costs no descriptor: each
// thread copies one 16-byte float4 of the output (4 threads per row at
// width 16, 2 at width 8), so a warp covers 8 or 16 consecutive output
// rows, and when their indices run consecutively (fusion's streams are
// 96-100% runs, because the pool is appended in image order) the warp's
// loads fall on neighbouring source rows and merge into full 32-byte
// sectors by themselves. No plan, no window, no realignment.
//
// The launcher enqueues on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

// One float4 of the output per thread and step of a grid-stride loop;
// q = width / 4 float4s per row.
__global__ void coalesced_gather_kernel(const float4* __restrict__ src,
                                        const int32_t* __restrict__ idx,
                                        float4* __restrict__ out, int C, int q,
                                        long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long row = t / q;
    const int part = static_cast<int>(t - row * q);
    int r = __ldg(idx + row);
    r = r < 0 ? 0 : (r >= C ? C - 1 : r);
    out[t] = __ldg(src + static_cast<long long>(r) * q + part);
  }
}

}  // namespace

extern "C" {

int coalesced_gather_launch(const void* src, const void* idx, void* out, int C,
                            int width, int N, void* stream) {
  const int q = width / 4;
  const long long total = static_cast<long long>(N) * q;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  coalesced_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<const int32_t*>(idx),
      static_cast<float4*>(out), C, q, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

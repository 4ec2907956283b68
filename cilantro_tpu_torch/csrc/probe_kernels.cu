// The wide-row probe's kernel for Hopper (sm_90a).
//
//   scale2_kernel  <- copy_kernel (tools/wide_row_probe.py), o = 2 * x
//
// The TPU probe timed the compile and run of its smallest Pallas kernel, a
// doubling copy of the (CAP / 8, 128) float32 pool view in (840, 128)
// blocks. Here it is one elementwise pass: 2 * x is exact in float32, so the
// kernel and its plain version (2.0 * x) agree bit for bit.
//
// What bounds it: bytes. Each element is read once and written once; at the
// probe's shape (CAP = 430,080 rows of 16, 27.5 MB each way) that is 55 MB
// over 3.35 TB/s. Design: one thread per 16-byte float4, 256 threads a block,
// a grid-stride loop; neighbouring threads touch neighbouring addresses, so
// every warp's loads and stores are whole 512-byte runs.
//
// The launcher enqueues on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scale2_kernel(const float4* __restrict__ x, float4* __restrict__ o, long n4) {
  for (long t = blockIdx.x * (long)kThreads + threadIdx.x; t < n4;
       t += (long)gridDim.x * kThreads) {
    const float4 v = __ldg(x + t);
    o[t] = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
  }
}

}  // namespace

extern "C" {

// n is a multiple of 4 and both pointers are 16-byte aligned (the wrapper
// checks them).
int scale2_launch(const void* x, void* o, long n, void* stream) {
  const long n4 = n / 4;
  long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  scale2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o), n4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

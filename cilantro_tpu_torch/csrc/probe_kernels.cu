// The wide-row probe's kernel for Hopper (sm_90a).
//
//   scale2_kernel  <- copy_kernel (tools/wide_row_probe.py), o = 2 * x
//
// The TPU probe timed the compile and run of its smallest Pallas kernel, a
// doubling copy of the (CAP / 8, 128) float32 pool view in (840, 128)
// blocks. Here it is one elementwise pass: 2 * x is exact in float32, so the
// kernel and its plain version (2.0 * x) agree bit for bit.
//
// What bounds it: bytes. Each element is read once and written once, and at
// the probe's shape (CAP = 430,080 rows of 16) the data is larger than the
// card's L2. Design, a streaming copy:
// - each thread issues kUnroll independent 16-byte loads before its first
//   store; neighbouring threads touch neighbouring 16-byte words, so every
//   warp instruction moves whole 512-byte runs. A full grid of one load a
//   thread already keeps enough bytes in flight: 2, 4 and 8 loads a thread
//   measured no faster (8 slower);
// - loads are streaming (ld.global.cs: evict first), as every input byte
//   is touched once; stores keep the default policy. Timed back to back,
//   each call finds the L2 as the previous one left it, and there either
//   hint alone beats both together or neither; the gain over torch.mul
//   is of that kind (both were also timed with the L2 cleared before each
//   call; PERF.md §6, row 10);
// - one block for each kThreads * kUnroll float4 words, with no
//   grid-stride loop; the last block checks each word against the end.
// This design was timed beside the previous one (one load in flight a
// thread, a grid-stride loop), a 1-D bulk-copy (TMA) design and variants of
// the constants and cache hints below (PERF.md §6, row 10).
//
// The launcher enqueues on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 1;  // 16-byte loads in flight a thread

__device__ __forceinline__ float4 load(const float4* p) { return __ldcs(p); }

__device__ __forceinline__ void store(float4* p, float4 v) { *p = v; }

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
}

__global__ void __launch_bounds__(kThreads)
scale2_kernel(const float4* __restrict__ x, float4* __restrict__ o, long n4) {
  const long t = blockIdx.x * static_cast<long>(kThreads * kUnroll) + threadIdx.x;
  float4 v[kUnroll];
  if (t + (kUnroll - 1) * kThreads < n4) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load(x + t + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) store(o + t + u * kThreads, twice(v[u]));
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u * kThreads < n4) v[u] = load(x + t + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u * kThreads < n4) store(o + t + u * kThreads, twice(v[u]));
    }
  }
}

}  // namespace

extern "C" {

// n is a multiple of 4 and both pointers are 16-byte aligned (the wrapper
// checks them).
int scale2_launch(const void* x, void* o, long n, void* stream) {
  const long n4 = n / 4;
  const long blocks = n4 > 0 ? (n4 + kThreads * kUnroll - 1) / (kThreads * kUnroll) : 1;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  scale2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o), n4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Other designs of coalesced_gather (csrc/gather_kernels.cu), built and
// timed beside it by tools/gather_variants.py; nothing else uses them. Each
// takes the arguments of coalesced_gather_launch and computes the same
// function bit for bit: out[i] = src[clamp(idx[i], 0, C-1)] for float32
// rows of width 8 or 16.
//
//   coalesced_gather_first_launch  the first design: one float4 of the
//                                  output a thread in a grid-stride loop of
//                                  at most 65,536 blocks, a 64-bit division
//                                  by the runtime width for every float4,
//                                  each thread loading its row's index,
//                                  default stores.
//   coalesced_gather_width_launch  the same with the width a template
//                                  parameter and 32-bit offsets (no
//                                  division); still one index load and one
//                                  float4 in flight a thread.
//   coalesced_gather_tiles_launch  the built design with two 32-row
//                                  sub-tiles a warp tile (2 Q float4 loads
//                                  a lane in flight), every row through L1,
//                                  on the resident grid at every size.
//   coalesced_gather_bulk_launch   tiles of 8 / Q sub-tiles, where a
//                                  32-row sub-tile whose indices run
//                                  consecutively is copied by lane 0 with one
//                                  1-D bulk copy (TMA, cp.async.bulk) into
//                                  the warp's shared memory, completion on
//                                  an mbarrier, and one bulk store back to
//                                  the output; other sub-tiles take plain
//                                  loads and streaming stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

bool refused(int C, int width, int N) {
  return (width != 8 && width != 16) || C < 1 || N < 0 ||
         static_cast<long long>(C) * (width / 4) >= (1LL << 31) ||
         static_cast<long long>(N) * (width / 4) >= (1LL << 31);
}

int resident(const void* kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// ---------------------------------------------------------------------------
// The first design.
// ---------------------------------------------------------------------------

__global__ void gather_first_kernel(const float4* __restrict__ src, const int32_t* __restrict__ idx,
                                    float4* __restrict__ out, int C, int q, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long row = t / q;
    const int part = static_cast<int>(t - row * q);
    int r = __ldg(idx + row);
    r = r < 0 ? 0 : (r >= C ? C - 1 : r);
    out[t] = __ldg(src + static_cast<long long>(r) * q + part);
  }
}

// ---------------------------------------------------------------------------
// The width at compile time, nothing else changed.
// ---------------------------------------------------------------------------

template <int Q>
__global__ void __launch_bounds__(kThreads)
gather_width_kernel(const float4* __restrict__ src, const int32_t* __restrict__ idx,
                    float4* __restrict__ out, int C, int total) {
  const int stride = gridDim.x * kThreads;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < total; t += stride) {
    int r = __ldg(idx + t / Q);
    r = r < 0 ? 0 : (r >= C ? C - 1 : r);
    out[t] = __ldg(src + r * Q + t % Q);
  }
}

// ---------------------------------------------------------------------------
// Tiles of T 32-row sub-tiles, with or without bulk copies (TMA) for runs.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

template <int Q, int T, bool kBulk>
__global__ void __launch_bounds__(kThreads)
gather_tiles_kernel(const float4* __restrict__ src, const int32_t* __restrict__ idx,
                    float4* __restrict__ out, int C, int N) {
  constexpr int kTile = 32 * T;
  constexpr int kRowsAStep = 32 / Q;
  constexpr unsigned kSubBytes = 32 * Q * 16;
  __shared__ __align__(128) float4 buf[kBulk ? kThreads / 32 : 1][kBulk ? T : 1][kBulk ? 32 * Q : 1];
  __shared__ __align__(8) unsigned long long bars[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int part = lane % Q;
  const int sub = lane / Q;
  const unsigned bar = smem_addr(&bars[w]);
  if (kBulk && lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  unsigned parity = 0;
  const int warps = gridDim.x * (kThreads / 32);
  const int tiles = (N + kTile - 1) / kTile;
  for (int tile = blockIdx.x * (kThreads / 32) + w; tile < tiles; tile += warps) {
    const int first = tile * kTile;
    int r[T];
    unsigned runs = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int i = first + 32 * t + lane;
      int v = i < N ? __ldg(idx + i) : 0;
      r[t] = v < 0 ? 0 : (v >= C ? C - 1 : v);
      const int r0 = __shfl_sync(0xffffffffu, r[t], 0);
      if (kBulk && __all_sync(0xffffffffu, i < N && r[t] == r0 + lane)) runs |= 1u << t;
    }
    if (runs != 0 && lane == 0) {
      // The previous tile's bulk stores must have read the buffer.
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(static_cast<unsigned>(__popc(runs)) * kSubBytes)
                   : "memory");
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (!(runs >> t & 1u)) continue;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(&buf[w][t][0])),
            "l"(src + static_cast<long long>(r[t]) * Q), "r"(kSubBytes), "r"(bar)
            : "memory");
      }
    }
    float4 v[T][Q];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int k = j * kRowsAStep + sub;
        const int row = __shfl_sync(0xffffffffu, r[t], k);
        if (!(runs >> t & 1u) && first + 32 * t + k < N) v[t][j] = __ldg(src + row * Q + part);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int k = j * kRowsAStep + sub;
        if (!(runs >> t & 1u) && first + 32 * t + k < N) {
          __stcs(out + (first + 32 * t) * Q + j * 32 + lane, v[t][j]);
        }
      }
    }
    if (runs != 0 && lane == 0) {
      while (!mbar_try_wait(bar, parity)) {
      }
      parity ^= 1u;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (!(runs >> t & 1u)) continue;
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                         out + static_cast<long long>(first + 32 * t) * Q),
                     "r"(smem_addr(&buf[w][t][0])), "r"(kSubBytes)
                     : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (kBulk && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// On the resident grid, walking the tiles.
template <int Q, int T, bool kBulk>
void tiles(const void* src, const void* idx, void* out, int C, int N, cudaStream_t s) {
  constexpr int kTile = 32 * T;
  long long blocks = ((static_cast<long long>(N) + kTile - 1) / kTile + 7) / 8;
  const int cap = resident(reinterpret_cast<const void*>(gather_tiles_kernel<Q, T, kBulk>), kThreads, 0);
  if (blocks > cap) blocks = cap;
  gather_tiles_kernel<Q, T, kBulk><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float4*>(src), static_cast<const int32_t*>(idx), static_cast<float4*>(out),
      C, N);
}

}  // namespace

extern "C" {

int coalesced_gather_first_launch(const void* src, const void* idx, void* out, int C, int width, int N,
                                void* stream) {
  if (refused(C, width, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const int q = width / 4;
  const long long total = static_cast<long long>(N) * q;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1 << 16)) blocks = 1 << 16;
  gather_first_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<const int32_t*>(idx), static_cast<float4*>(out),
      C, q, total);
  return static_cast<int>(cudaGetLastError());
}

int coalesced_gather_width_launch(const void* src, const void* idx, void* out, int C, int width,
                                  int N, void* stream) {
  if (refused(C, width, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const int total = N * (width / 4);
  long long blocks = (static_cast<long long>(total) + kThreads - 1) / kThreads;
  if (blocks > (1 << 16)) blocks = 1 << 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* sp = static_cast<const float4*>(src);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float4* op = static_cast<float4*>(out);
  if (width == 16) {
    gather_width_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(sp, ip, op, C, total);
  } else {
    gather_width_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(sp, ip, op, C, total);
  }
  return static_cast<int>(cudaGetLastError());
}

int coalesced_gather_tiles_launch(const void* src, const void* idx, void* out, int C, int width,
                                  int N, void* stream) {
  if (refused(C, width, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 16) {
    tiles<4, 2, false>(src, idx, out, C, N, s);
  } else {
    tiles<2, 2, false>(src, idx, out, C, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int coalesced_gather_bulk_launch(const void* src, const void* idx, void* out, int C, int width,
                                 int N, void* stream) {
  if (refused(C, width, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 16) {
    tiles<4, 2, true>(src, idx, out, C, N, s);
  } else {
    tiles<2, 4, true>(src, idx, out, C, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

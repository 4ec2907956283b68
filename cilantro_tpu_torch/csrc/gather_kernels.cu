// The pool pipeline's wide-row gather for Hopper (sm_90a).
//
//   coalesced_gather_kernel  <- _make_kernel / _window_fetch
//                               (cilantro_tpu/core/coalesced.py, coalesced_gather)
//
// out[i, :] = src[clamp(idx[i], 0, C-1), :] for float32 rows of width 8 or
// 16. A copy: the output equals the plain gather bit for bit on every row,
// wildcards (idx < 0 -> row 0) and indices >= C (-> row C-1) included.
//
// What bounds it: device-memory bytes. Per output row it reads one 4-byte
// index and 32 or 64 bytes of source and writes as many, with no
// arithmetic. Where neighbouring rows are not neighbours in the source
// (the projective ICP's targets of stride-2 points step by two 32-byte
// rows), the memory system moves whole 64-byte segments, so every such row
// costs twice its bytes: that stream's least time is its 64-byte
// segments' bytes, not its rows' (chip_smoke.py reports both bounds, and
// tools/gather_variants.py times rows at a stride of 1, 2 and 4).
//
// Design. A warp copies a tile of 32 rows:
//   - each lane loads the index of one row (one coalesced 128-byte load)
//     and clamps it; Q = width / 4 lanes copy a row, one float4 each, and
//     take its index from the lane that loaded it (__shfl_sync), so a lane
//     has Q float4 loads in flight and no index is loaded twice;
//   - the next tile's indices are loaded behind this tile's row loads;
//   - the width is a template parameter and offsets are 32-bit (the
//     launcher refuses 2^31 float4s), so no division is left;
//   - stores are streaming (st.global.cs): the output is written once and
//     should not push source lines out of the 50 MB L2;
//   - 8-wide rows of a tile whose indices are not one run load without
//     allocating L1 lines (ld.global.nc.L1::no_allocate); runs, and every
//     16-wide row, load through L1, which is faster for them;
//   - the grid is one warp a tile; where that needs more blocks than the
//     card holds at once but at most kMaxRounds times as many, the resident
//     blocks walk the tiles instead (no last partial wave).
// When a warp's indices run consecutively (fusion's integrate and update
// streams are 96-100% runs, because the pool is appended in image order),
// its loads fall on neighbouring source rows and merge into full sectors.
// The GATHER_* macros let tools/gather_variants.py build variants of these
// choices with -D; the defaults are the built design.
//
// Why the TPU design is not carried over: the TPU paid one DMA descriptor
// per gathered row, so its kernel planned runs of consecutive indices,
// fetched an aligned (2, 128)-lane window per run and realigned lanes with
// a one-hot matmul. On Hopper a gathered row costs no descriptor, a warp's
// loads of a run coalesce by themselves, and 1-D bulk copies (TMA) of the
// runs through shared memory were slower than plain loads on every stream
// (tools/gather_alternatives.cu; PERF.md). No plan, no window, no
// realignment.
//
// The launcher enqueues on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a refused
// launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GATHER_THREADS
#define GATHER_THREADS 256
#endif
#ifndef GATHER_MAX_ROUNDS
#define GATHER_MAX_ROUNDS 4
#endif
#ifndef GATHER_UNCACHED_MAX_WIDTH
#define GATHER_UNCACHED_MAX_WIDTH 8
#endif
#ifndef GATHER_RUNS_THROUGH_L1
#define GATHER_RUNS_THROUGH_L1 1
#endif
#ifndef GATHER_STREAMING_STORES
#define GATHER_STREAMING_STORES 1
#endif

namespace {

constexpr int kThreads = GATHER_THREADS;
constexpr int kMaxRounds = GATHER_MAX_ROUNDS;  // tiles a warp walks at most on the resident grid
constexpr int kUncachedMaxWidth = GATHER_UNCACHED_MAX_WIDTH;  // rows this wide or narrower outside a run skip L1
constexpr bool kRunsThroughL1 = GATHER_RUNS_THROUGH_L1;
constexpr bool kStreamingStores = GATHER_STREAMING_STORES;
constexpr unsigned kAll = 0xffffffffu;

// A read-only load of source that allocates an L1 line, or none.
template <bool kUncached>
__device__ __forceinline__ float4 load_src(const float4* p) {
  if constexpr (kUncached) {
    float4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
    return v;
  } else {
    return __ldg(p);
  }
}

// The clamped index of row i (0 at or past N: such rows are neither loaded
// nor stored).
__device__ __forceinline__ int load_row(const int32_t* __restrict__ idx, int i, int N, int C) {
  const int v = i < N ? __ldg(idx + i) : 0;
  return v < 0 ? 0 : (v >= C ? C - 1 : v);
}

// Whether the tile of rows first ... loads without allocating L1 lines:
// rows of at most kUncachedMaxWidth floats, unless its indices run
// consecutively. Warp-uniform.
template <int Q>
__device__ __forceinline__ bool uncached_tile(int r, int first, int N, int lane) {
  if constexpr (4 * Q > kUncachedMaxWidth) {
    return false;
  } else if constexpr (!kRunsThroughL1) {
    return true;
  } else {
    const int r0 = __shfl_sync(kAll, r, 0);
    return !__all_sync(kAll, first + lane >= N || r == r0 + lane);
  }
}

// The Q float4s of a lane in the tile of rows first ...: its s-th load
// copies part `part` of row s * 32 / Q + sub, whose index lane holds.
template <int Q, bool kUncached>
__device__ __forceinline__ void load_tile(const float4* __restrict__ src, int r, int first, int N,
                                          int part, int sub, float4 (&v)[Q]) {
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const int k = s * (32 / Q) + sub;
    const int row = __shfl_sync(kAll, r, k);
    if (first + k < N) v[s] = load_src<kUncached>(src + row * Q + part);
  }
}

// Q float4s a row, one warp a 32-row tile at a time.
template <int Q>
__global__ void __launch_bounds__(kThreads)
coalesced_gather_kernel(const float4* __restrict__ src, const int32_t* __restrict__ idx,
                        float4* __restrict__ out, int C, int N) {
  const int lane = threadIdx.x & 31;
  const int part = lane % Q;
  const int sub = lane / Q;
  const int warps = gridDim.x * (kThreads / 32);
  const int tiles = (N + 31) / 32;
  int tile = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  int r = load_row(idx, tile * 32 + lane, N, C);
  for (; tile < tiles; tile += warps) {
    const int first = tile * 32;
    float4 v[Q];
    if (uncached_tile<Q>(r, first, N, lane)) {
      load_tile<Q, true>(src, r, first, N, part, sub, v);
    } else {
      load_tile<Q, false>(src, r, first, N, part, sub, v);
    }
    r = load_row(idx, tile + warps < tiles ? (tile + warps) * 32 + lane : N, N, C);
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      if (first + s * (32 / Q) + sub < N) {
        float4* p = out + first * Q + 32 * s + lane;
        if constexpr (kStreamingStores) {
          __stcs(p, v[s]);
        } else {
          *p = v[s];
        }
      }
    }
  }
}

// Blocks of coalesced_gather_kernel<Q> the device holds at once, queried
// once a device.
template <int Q>
int resident_blocks() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& slot = cached[dev & 63];
  if (slot == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coalesced_gather_kernel<Q>, kThreads, 0);
    slot = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return slot;
}

// One warp a tile; where that needs more blocks than the card holds but
// at most kMaxRounds times as many, the resident blocks walk the tiles.
template <int Q>
void launch(const void* src, const void* idx, void* out, int C, int N, cudaStream_t stream) {
  const long long tiles = (static_cast<long long>(N) + 31) / 32;
  long long blocks = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const long long resident = resident_blocks<Q>();
  if (blocks > resident && blocks <= kMaxRounds * resident) blocks = resident;
  coalesced_gather_kernel<Q><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float4*>(src), static_cast<const int32_t*>(idx), static_cast<float4*>(out),
      C, N);
}

}  // namespace

extern "C" {

// Refuses (cudaErrorInvalidValue, nothing launched) a width other than 8
// or 16, C < 1, N < 0, and 2^31 float4s or more of source or output.
int coalesced_gather_launch(const void* src, const void* idx, void* out, int C, int width, int N,
                            void* stream) {
  const int q = width / 4;
  if ((width != 8 && width != 16) || C < 1 || N < 0 ||
      static_cast<long long>(C) * q >= (1LL << 31) || static_cast<long long>(N) * q >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q == 4) {
    launch<4>(src, idx, out, C, N, s);
  } else {
    launch<2>(src, idx, out, C, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

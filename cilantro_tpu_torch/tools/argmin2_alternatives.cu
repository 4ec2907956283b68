// Two other designs of splat_argmin2 (csrc/splat_kernels.cu), built and
// timed beside it by tools/argmin2_variants.py; nothing else uses them.
// Both take the arguments of splat_argmin2_launch and compute the same
// function bit for bit: per target pixel, the best and runner-up (key,
// code) over the L*(2R+1)^2 sources whose offset code lands on it, visited
// in (layer, dv, du) order with a strict '<'.
//
//   argmin2_scan_launch    the previous design: one thread per target, a
//                          dependent check of each of its L*(2R+1)^2
//                          candidate sources in device memory.
//   argmin2_gather_launch  a gather from a shared-memory halo: a block
//                          copies one layer's halo of its kTileW x kTileH
//                          tile with cp.async, then each thread checks all
//                          (2R+1)^2 offsets of kRows targets with selects,
//                          branch-free.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kRows = kTileH * kTileW / kThreads;  // targets a thread, one column

__device__ __forceinline__ void top2(float cand, int32_t code, float& best_k,
                                     int32_t& best_c, float& sec_k, int32_t& sec_c) {
  const bool lt_best = cand < best_k;
  const bool lt_sec = cand < sec_k;
  sec_k = lt_best ? best_k : (lt_sec ? cand : sec_k);
  sec_c = lt_best ? best_c : (lt_sec ? code : sec_c);
  best_k = lt_best ? cand : best_k;
  best_c = lt_best ? code : best_c;
}

__global__ void argmin2_scan_kernel(
    const float* __restrict__ key, const int32_t* __restrict__ off,
    float* __restrict__ bk, int32_t* __restrict__ bc, float* __restrict__ sk,
    int32_t* __restrict__ sc, int L, int H, int W, int R) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int w2 = 2 * R + 1;
  const int wp = W + 2 * R;
  const int plane = (H + 2 * R) * wp;
  float best_k = __int_as_float(0x7f800000);  // +inf
  float sec_k = best_k;
  int32_t best_c = -1, sec_c = -1;
  for (int l = 0; l < L; ++l) {
    const float* kp = key + (b * L + l) * plane;
    const int32_t* op = off + (b * L + l) * plane;
    for (int a = -R; a <= R; ++a) {
      const int row = (y + R - a) * wp + x + R;
      for (int bb = -R; bb <= R; ++bb) {
        const int oc = (a + R) * w2 + (bb + R);
        const int idx = row - bb;
        if (op[idx] != oc) continue;
        top2(kp[idx], oc * L + l, best_k, best_c, sec_k, sec_c);
      }
    }
  }
  const int o = b * H * W + y * W + x;
  bk[o] = best_k;
  bc[o] = best_c;
  sk[o] = sec_k;
  sc[o] = sec_c;
}

__global__ void __launch_bounds__(kThreads) argmin2_gather_kernel(
    const float* __restrict__ key, const int32_t* __restrict__ off,
    float* __restrict__ bk, int32_t* __restrict__ bc, float* __restrict__ sk,
    int32_t* __restrict__ sc, int L, int H, int W, int R) {
  extern __shared__ int32_t halo[];
  const int hh = kTileH + 2 * R, hw = kTileW + 2 * R;
  int32_t* s_code = halo;
  float* s_key = reinterpret_cast<float*>(halo + hh * hw);
  const int w2 = 2 * R + 1;
  const int hp = H + 2 * R, wp = W + 2 * R;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH, b = blockIdx.z;
  const int tx = threadIdx.x % kTileW, ty0 = threadIdx.x / kTileW * kRows;
  float best_k[kRows], sec_k[kRows];
  int32_t best_c[kRows], sec_c[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    best_k[j] = sec_k[j] = __int_as_float(0x7f800000);
    best_c[j] = sec_c[j] = -1;
  }
  for (int l = 0; l < L; ++l) {
    const int layer = (b * L + l) * hp * wp;
    __syncthreads();  // the previous layer's halo has been read
    for (int i = threadIdx.x; i < hh * hw; i += kThreads) {
      const int py = y0 + i / hw, px = x0 + i % hw;
      if (py < hp && px < wp) {
        __pipeline_memcpy_async(s_code + i, off + layer + py * wp + px, sizeof(int32_t));
        __pipeline_memcpy_async(s_key + i, key + layer + py * wp + px, sizeof(float));
      } else {
        s_code[i] = -1;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int dv = -R; dv <= R; ++dv) {
      for (int du = -R; du <= R; ++du) {
        const int oc = (dv + R) * w2 + (du + R);
        // The source with offset (dv, du) that lands on tile (ty, tx) sits
        // at halo (ty + R - dv, tx + R - du).
        const int base = (ty0 + R - dv) * hw + tx + R - du;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int i = base + j * hw;
          const float cand = s_code[i] == oc ? s_key[i] : __int_as_float(0x7f800000);
          top2(cand, oc * L + l, best_k[j], best_c[j], sec_k[j], sec_c[j]);
        }
      }
    }
  }
  const int x = x0 + tx;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y0 + ty0 + j;
    if (y >= H || x >= W) continue;
    const int o = (b * H + y) * W + x;
    bk[o] = best_k[j];
    bc[o] = best_c[j];
    sk[o] = sec_k[j];
    sc[o] = sec_c[j];
  }
}

}  // namespace

extern "C" {

int argmin2_scan_launch(const void* key, const void* off, void* bk, void* bc,
                        void* sk, void* sc, int B, int L, int H, int W, int R,
                        void* design, void* stream) {
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  argmin2_scan_kernel<<<grid, dim3(kBlockX, kBlockY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key), static_cast<const int32_t*>(off),
      static_cast<float*>(bk), static_cast<int32_t*>(bc), static_cast<float*>(sk),
      static_cast<int32_t*>(sc), L, H, W, R);
  if (design) {
    int* d = static_cast<int*>(design);
    d[0] = kBlockX;
    d[1] = kBlockY;
    d[2] = static_cast<int>(grid.x * grid.y * grid.z);
  }
  return static_cast<int>(cudaGetLastError());
}

int argmin2_gather_launch(const void* key, const void* off, void* bk, void* bc,
                          void* sk, void* sc, int B, int L, int H, int W, int R,
                          void* design, void* stream) {
  const size_t smem = 2 * sizeof(int32_t) * (kTileH + 2 * R) * (kTileW + 2 * R);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  argmin2_gather_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key), static_cast<const int32_t*>(off),
      static_cast<float*>(bk), static_cast<int32_t*>(bc), static_cast<float*>(sk),
      static_cast<int32_t*>(sc), L, H, W, R);
  if (design) {
    int* d = static_cast<int*>(design);
    d[0] = kTileW;
    d[1] = kTileH;
    d[2] = static_cast<int>(grid.x * grid.y * grid.z);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

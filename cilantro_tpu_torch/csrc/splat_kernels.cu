// Splat fusion's three stencil-gather kernels for Hopper (sm_90a).
//
// Each replaces one Pallas TPU kernel of cilantro_tpu/slam/splat.py and
// computes exactly what that kernel computes (the outputs are pure selects,
// so kernel and plain PyTorch version agree bit for bit):
//
//   window_read_codes_kernel  <- _window_read_kernel  (window_read_codes)
//   splat_argmin2_kernel      <- _argmin2_kernel      (splat_argmin2)
//   flow_select_rows_kernel   <- _select_rows_kernel  (flow_select_rows)
//
// All three are bound by device-memory bytes: each moves a few to a few
// tens of MB and does a handful of integer operations per byte. The TPU
// design (a VMEM band per grid step and a sweep of selects over all
// (2R+1)^2 offsets, because the TPU has no fast gather) is not carried
// over: on Hopper one thread per output pixel decodes its own offset and
// reads its source directly, so each output byte is written once and the
// window's reuse between neighbouring threads is served by L1/L2.
//
// Layout: every image is row-major and padded by R on each side of its
// last two dims, exactly as the callers pass it (the JAX wrappers' extra
// lane/sublane padding is a TPU tiling need and not part of the contract).
// Offset code oc = (dv + R) * (2R+1) + (du + R); row code = oc * L + layer.
// Indices are 32-bit: the wrappers refuse tensors of 2^31 elements or more.
//
// Each launcher enqueues on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// out[b,c,y,x] = img[b,c,y+R+dv,x+R+du] for off[b,y,x] = code of (dv,du);
// -1 where off is outside [0, (2R+1)^2). img's batch stride may be 0 (one
// frame read by every layer).
__global__ void window_read_codes_kernel(
    const int32_t* __restrict__ img, const int32_t* __restrict__ off,
    int32_t* __restrict__ out, int C, int H, int W, int R, int img_bstride) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int w2 = 2 * R + 1;
  const int hw = H * W;
  const int plane = (H + 2 * R) * (W + 2 * R);
  const int o = off[b * hw + y * W + x];
  int32_t* dst = out + b * C * hw + y * W + x;
  if (o < 0 || o >= w2 * w2) {
    for (int c = 0; c < C; ++c) dst[c * hw] = -1;
    return;
  }
  const int dv = o / w2 - R;
  const int du = o % w2 - R;
  const int32_t* src =
      img + b * img_bstride + (y + R + dv) * (W + 2 * R) + (x + R + du);
  for (int c = 0; c < C; ++c) dst[c * hw] = src[c * plane];
}

// Best and second-best (key, code) per target pixel over the L*(2R+1)^2
// sources whose offset code lands on it, visited in (layer, dv, du) order
// with strict '<' so that the first candidate wins ties; +inf / -1 where
// no candidate.
__global__ void splat_argmin2_kernel(
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
      // The source with offset (a, bb) that lands on (y, x) sits at
      // unpadded (y - a, x - bb), padded (y + R - a, x + R - bb).
      const int row = (y + R - a) * wp + x + R;
      for (int bb = -R; bb <= R; ++bb) {
        const int oc = (a + R) * w2 + (bb + R);
        const int idx = row - bb;
        if (op[idx] != oc) continue;
        const float cand = kp[idx];
        const int32_t code = oc * L + l;
        if (cand < best_k) {
          sec_k = best_k;
          sec_c = best_c;
          best_k = cand;
          best_c = code;
        } else if (cand < sec_k) {
          sec_k = cand;
          sec_c = code;
        }
      }
    }
  }
  const int o = b * H * W + y * W + x;
  bk[o] = best_k;
  bc[o] = best_c;
  sk[o] = sec_k;
  sc[o] = sec_c;
}

// out[b,c,y,x] = rows[b,l,c,y+R-dv,x+R-du] for code[b,y,x] = oc*L + l; 0
// where code is outside [0, L*(2R+1)^2). Copies the 32-bit patterns.
// rows' batch stride may be 0 (winner and runner-up codes of one map).
__global__ void flow_select_rows_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ code,
    uint32_t* __restrict__ out, int L, int C, int H, int W, int R,
    int rows_bstride) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int w2 = 2 * R + 1;
  const int hw = H * W;
  const int plane = (H + 2 * R) * (W + 2 * R);
  const int cd = code[b * hw + y * W + x];
  uint32_t* dst = out + b * C * hw + y * W + x;
  if (cd < 0 || cd >= L * w2 * w2) {
    for (int c = 0; c < C; ++c) dst[c * hw] = 0u;
    return;
  }
  const int l = cd % L;
  const int oc = cd / L;
  const int dv = oc / w2 - R;
  const int du = oc % w2 - R;
  const uint32_t* src = rows + b * rows_bstride + l * C * plane +
                        (y + R - dv) * (W + 2 * R) + (x + R - du);
  for (int c = 0; c < C; ++c) dst[c * hw] = src[c * plane];
}

dim3 grid_for(int B, int H, int W) {
  return dim3((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
}

}  // namespace

extern "C" {

int window_read_codes_launch(const void* img, const void* off, void* out,
                             int B, int C, int H, int W, int R,
                             int img_bstride, void* stream) {
  window_read_codes_kernel<<<grid_for(B, H, W), dim3(kBlockX, kBlockY), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(img), static_cast<const int32_t*>(off),
      static_cast<int32_t*>(out), C, H, W, R, img_bstride);
  return static_cast<int>(cudaGetLastError());
}

int splat_argmin2_launch(const void* key, const void* off, void* bk,
                         void* bc, void* sk, void* sc, int B, int L, int H,
                         int W, int R, void* stream) {
  splat_argmin2_kernel<<<grid_for(B, H, W), dim3(kBlockX, kBlockY), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key), static_cast<const int32_t*>(off),
      static_cast<float*>(bk), static_cast<int32_t*>(bc),
      static_cast<float*>(sk), static_cast<int32_t*>(sc), L, H, W, R);
  return static_cast<int>(cudaGetLastError());
}

int flow_select_rows_launch(const void* rows, const void* code, void* out,
                            int B, int L, int C, int H, int W, int R,
                            int rows_bstride, void* stream) {
  flow_select_rows_kernel<<<grid_for(B, H, W), dim3(kBlockX, kBlockY), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(code),
      static_cast<uint32_t*>(out), L, C, H, W, R, rows_bstride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Other designs of flow_select_rows (csrc/splat_kernels.cu) and scale2
// (csrc/probe_kernels.cu), built and timed beside them by
// tools/select_rows_variants.py; nothing else uses them. Each takes the
// arguments of its kernel's launcher and computes the same function bit
// for bit.
//
//   flow_select_rows_prev_launch  the previous design: one thread a pixel
//                                 (32 x 8 blocks), four divisions to decode
//                                 the code, a loop of C scalar loads and
//                                 stores.
//   flow_select_rows_halo_launch  a shared-memory halo: a block stages the
//                                 source halo of its 32 x 16 tile (every
//                                 layer, kHaloGroup channels at a time) with
//                                 cp.async, then gathers each pixel's
//                                 channels from it; every load is coalesced,
//                                 but the halo holds pixels no code names.
//   scale2_prev_launch            the previous scale2: one 16-byte load in
//                                 flight a thread, a grid-stride loop over
//                                 at most 132 * 16 blocks.
//   scale2_bulk16_launch,         1-D bulk copies (TMA): one thread of a
//   scale2_bulk32_launch          block copies its 16 or 32 KB chunk into
//                                 shared memory (cp.async.bulk, completion on
//                                 an mbarrier), the block doubles it there,
//                                 and one thread bulk-stores it back.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// flow_select_rows, the previous design.
// ---------------------------------------------------------------------------

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void flow_select_rows_prev_kernel(
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

// ---------------------------------------------------------------------------
// flow_select_rows from a shared-memory halo.
// ---------------------------------------------------------------------------

constexpr int kHaloW = 32;  // tile columns (one a lane)
constexpr int kHaloH = 16;  // tile rows (two a thread)
constexpr int kHaloThreads = 256;
constexpr int kHaloGroup = 4;  // channels staged at a time

size_t halo_smem_bytes(int L, int R) {
  const int n_codes = L * (2 * R + 1) * (2 * R + 1);
  return sizeof(uint32_t) * L * kHaloGroup * (kHaloH + 2 * R) * (kHaloW + 2 * R) +
         sizeof(int) * n_codes;
}

__global__ void __launch_bounds__(kHaloThreads) flow_select_rows_halo_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ code,
    uint32_t* __restrict__ out, int L, int C, int H, int W, int R,
    int rows_bstride) {
  extern __shared__ uint32_t halo[];
  const int w2 = 2 * R + 1, n_codes = L * w2 * w2;
  const int hp = H + 2 * R, wp = W + 2 * R, plane = hp * wp, hw = H * W;
  const int hh = kHaloH + 2 * R, hwd = kHaloW + 2 * R, chan = hh * hwd;
  int* table = reinterpret_cast<int*>(halo + L * kHaloGroup * chan);
  const int x0 = blockIdx.x * kHaloW, y0 = blockIdx.y * kHaloH, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = x0 + lane;
  int cd[2], at[2];
  bool ok[2], live[2];
  for (int k = 0; k < 2; ++k) {
    const int y = y0 + warp + 8 * k;
    live[k] = y < H && x < W;
    cd[k] = live[k] ? code[b * hw + y * W + x] : -1;
  }
  for (int i = threadIdx.x; i < n_codes; i += kHaloThreads) {
    const int l = i % L, oc = i / L;
    table[i] = l * kHaloGroup * chan + (2 * R - oc / w2) * hwd + (2 * R - oc % w2);
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    ok[k] = static_cast<unsigned>(cd[k]) < static_cast<unsigned>(n_codes);
    at[k] = (ok[k] ? table[cd[k]] : 0) + (warp + 8 * k) * hwd + lane;
  }
  const uint32_t* src = rows + b * rows_bstride;
  for (int c0 = 0; c0 < C; c0 += kHaloGroup) {
    // Stage padded rows [y0, y0 + hh) and columns [x0, x0 + hwd) of every
    // layer's channels c0 .. c0 + kHaloGroup - 1.
    for (int row = warp; row < L * kHaloGroup * hh; row += kHaloThreads / 32) {
      const int lg = row / hh, hy = row - lg * hh;
      const int l = lg / kHaloGroup, c = c0 + lg - l * kHaloGroup;
      const int py = y0 + hy;
      for (int hx = lane; hx < hwd; hx += 32) {
        uint32_t* d = halo + row * hwd + hx;
        const int px = x0 + hx;
        if (c < C && py < hp && px < wp) {
          __pipeline_memcpy_async(d, src + (l * C + c) * plane + py * wp + px, sizeof(uint32_t));
        } else {
          *d = 0u;
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int k = 0; k < 2; ++k) {
      if (!live[k]) continue;
      uint32_t* dst = out + (b * C + c0) * hw + (y0 + warp + 8 * k) * W + x;
      for (int g = 0; g < kHaloGroup && c0 + g < C; ++g) {
        dst[g * hw] = ok[k] ? halo[at[k] + g * chan] : 0u;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// scale2, the previous design.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scale2_prev_kernel(const float4* __restrict__ x, float4* __restrict__ o, long n4) {
  for (long t = blockIdx.x * (long)kThreads + threadIdx.x; t < n4;
       t += (long)gridDim.x * kThreads) {
    const float4 v = __ldg(x + t);
    o[t] = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
  }
}

// ---------------------------------------------------------------------------
// scale2 by 1-D bulk copies.
// ---------------------------------------------------------------------------

template <int kBytes>
__global__ void __launch_bounds__(kThreads)
scale2_bulk_kernel(const float* __restrict__ x, float* __restrict__ o, long n) {
  extern __shared__ __align__(128) float4 buf[];
  __shared__ __align__(8) unsigned long long bar;
  const long first = blockIdx.x * static_cast<long>(kBytes / 4);
  const long left = (n - first) * 4;
  const unsigned bytes = static_cast<unsigned>(left < kBytes ? left : kBytes);
  const unsigned sbuf = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const unsigned sbar = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(sbar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(sbuf), "l"(x + first), "r"(bytes), "r"(sbar) : "memory");
  }
  __syncthreads();
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(sbar) : "memory");
  for (unsigned i = threadIdx.x; i < bytes / 16; i += kThreads) {
    const float4 v = buf[i];
    buf[i] = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(o + first), "r"(sbuf), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int kBytes>
int scale2_bulk(const void* x, void* o, long n, void* stream) {
  const long per = kBytes / 4;
  const long blocks = n > 0 ? (n + per - 1) / per : 0;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  scale2_bulk_kernel<kBytes><<<static_cast<unsigned>(blocks), kThreads, kBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int flow_select_rows_prev_launch(const void* rows, const void* code, void* out,
                                 int B, int L, int C, int H, int W, int R,
                                 int rows_bstride, void* design, void* stream) {
  (void)design;
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  flow_select_rows_prev_kernel<<<grid, dim3(kBlockX, kBlockY), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(code),
      static_cast<uint32_t*>(out), L, C, H, W, R, rows_bstride);
  return static_cast<int>(cudaGetLastError());
}

// A halo past 48 KB of shared memory is refused with cudaErrorInvalidValue.
int flow_select_rows_halo_launch(const void* rows, const void* code, void* out,
                                 int B, int L, int C, int H, int W, int R,
                                 int rows_bstride, void* design, void* stream) {
  (void)design;
  const size_t smem = halo_smem_bytes(L, R);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kHaloW - 1) / kHaloW, (H + kHaloH - 1) / kHaloH, B);
  flow_select_rows_halo_kernel<<<grid, kHaloThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(code),
      static_cast<uint32_t*>(out), L, C, H, W, R, rows_bstride);
  return static_cast<int>(cudaGetLastError());
}

int scale2_prev_launch(const void* x, void* o, long n, void* stream) {
  const long n4 = n / 4;
  long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  scale2_prev_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o), n4);
  return static_cast<int>(cudaGetLastError());
}

int scale2_bulk16_launch(const void* x, void* o, long n, void* stream) {
  return scale2_bulk<16384>(x, o, n, stream);
}

int scale2_bulk32_launch(const void* x, void* o, long n, void* stream) {
  return scale2_bulk<32768>(x, o, n, stream);
}

}  // extern "C"

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
// over. In window_read_codes one thread per output pixel decodes its own
// offset and reads its source directly, so each output byte is written
// once and the window's reuse between neighbouring threads is served by
// L1/L2; flow_select_rows does the same for two adjacent pixels a thread,
// decoding through a shared-memory table and writing vectors (its design
// is stated above its kernel).
//
// splat_argmin2 inverts the search: a target pixel has L*(2R+1)^2 possible
// sources but about one a layer lands on it, so rather than each target
// checking every source, each source is read once and sent to its target.
// A block owns a kTileW x kTileH tile of targets and two 64-bit slots a
// target in shared memory. Its threads first copy the tile's source halo
// (the tile plus 2R rows and columns, every layer; keys and codes) into
// shared memory with cp.async, so that every load is in flight at once
// (reading them straight from device memory costs two dependent loads a
// source in a row, 1.5 times the time, PERF.md §6), then decode
// each source's offset code, through a table of shifts a code, to its
// target. Why the result is the sequential one, bit for bit:
//
// 1. The candidate that reaches target t from layer l with offset code oc
//    has visit index v = (l << 16) | oc, ascending in the order of the
//    plain sweep over (layer, dv, du) (oc < 2^16 and l < 2^15: the shared
//    memory a block can have holds no halo that large); it comes from
//    exactly one source position, so (key, v) is unique per target.
// 2. With a strict '<' from (+inf, -1), the sequential best and runner-up
//    are the lexicographically smallest and second-smallest (key, v) over
//    the candidates whose key is below +inf: an equal key enters only
//    behind the earlier candidates of that key.
// 3. Keys compare as floats, so -0 equals +0: the packed value is
//    (order_key(key with -0 taken as +0) << 32) | v, order_key mapping the
//    float order onto the uint32 order, and the output key is re-read from
//    the winning source's copy in the halo, so a -0 key keeps its bits.
// 4. A NaN key or +inf never enters (both fail '< +inf'). An offset code
//    outside [0, (2R+1)^2) lands nowhere, as in the plain sweep, which
//    matches only codes in range. A source whose target lies outside the
//    block's tile is left to that tile's block; one whose target lies
//    outside [0, H) x [0, W) reaches no slot, or a slot of the last tiles
//    that is never written out. Sources in the pad land like any other.
//
// The first sweep takes the minimum by a shared atomicMin on the packed
// values (a compare-and-swap loop in SASS: Hopper has no 64-bit shared
// minimum); after a barrier the second takes, by the same atomic, the minimum
// over the candidates whose packed value is not the target's best (exactly
// one candidate, by 1). Each target then writes its pair: codes oc * L + l
// from v, keys from their sources; +inf / -1 where a slot stayed empty.
// A source is read once (the halos of neighbouring tiles overlap by 2R,
// (1 + 2R/kTileW)(1 + 2R/kTileH) reads a source in all) and visited twice
// from shared memory, against the L*(2R+1)^2 dependent checks a target of
// a scan makes. What bounds it: the bytes of the halo copy and the
// sweeps' issue, a few instructions and one shared atomic a candidate;
// 512 threads a block keep more of both in flight than 256 or 128
// (PERF.md §6, row 2).
//
// Layout: every image is row-major and padded by R on each side of its
// last two dims, exactly as the callers pass it (the JAX wrappers' extra
// lane/sublane padding is a TPU tiling need and not part of the contract).
// Offset code oc = (dv + R) * (2R+1) + (du + R); row code = oc * L + layer.
// Indices are 32-bit: the wrappers refuse tensors of 2^31 elements or more.
//
// Each launcher enqueues on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_pipeline.h>
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

constexpr int kTileW = 64;  // splat_argmin2: targets a block, x
constexpr int kTileH = 16;  // and y
constexpr int kElectThreads = 512;
constexpr int kElectWarps = kElectThreads / 32;
constexpr unsigned long long kEmpty = ~0ull;  // no candidate

// The float's bits as an unsigned key in the float order, -0 as +0 (k is
// not NaN).
__device__ __forceinline__ uint32_t order_key(float k) {
  uint32_t b = __float_as_uint(k);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The block's shared memory: two slots a target, the halo's keys and
// codes (L layers of (kTileH + 2R) x (kTileW + 2R), row-major), and for
// each offset code the shift from a source's halo position to its
// target's tile position.
struct Election {
  unsigned long long* best;
  unsigned long long* sec;
  float* key;
  int* code;
  int* dy;
  int* dx;
  int hh, hw;  // halo rows and columns

  __device__ Election(void* smem, int L, int R) {
    hh = kTileH + 2 * R;
    hw = kTileW + 2 * R;
    best = static_cast<unsigned long long*>(smem);
    sec = best + kTileH * kTileW;
    key = reinterpret_cast<float*>(sec + kTileH * kTileW);
    code = reinterpret_cast<int*>(key + L * hh * hw);
    dy = code + L * hh * hw;
    dx = dy + (2 * R + 1) * (2 * R + 1);
  }
};

size_t election_smem_bytes(int L, int R) {
  const int n_oc = (2 * R + 1) * (2 * R + 1);
  return sizeof(unsigned long long) * 2 * kTileH * kTileW +
         sizeof(float) * 2 * static_cast<size_t>(L) * (kTileH + 2 * R) * (kTileW + 2 * R) +
         sizeof(int) * 2 * n_oc;
}

// One sweep over the halo: each candidate that lands in the tile goes to
// its target's slot by atomicMin; in the second sweep only where it is not
// the target's best. A warp takes halo rows, its lanes the columns.
template <bool kSecond>
__device__ __forceinline__ void elect_sweep(const Election& e, int L, int n_oc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = 0; l < L; ++l) {
    for (int hy = warp; hy < e.hh; hy += kElectWarps) {
      for (int hx = lane; hx < e.hw; hx += 32) {
        const int i = (l * e.hh + hy) * e.hw + hx;
        const int oc = e.code[i];
        if (static_cast<unsigned>(oc) >= static_cast<unsigned>(n_oc)) continue;
        const int ty = hy + e.dy[oc], tx = hx + e.dx[oc];
        if (static_cast<unsigned>(ty) >= kTileH || static_cast<unsigned>(tx) >= kTileW) continue;
        const float k = e.key[i];
        if (!(k < __int_as_float(0x7f800000))) continue;  // NaN, +inf
        const unsigned long long packed =
            (static_cast<unsigned long long>(order_key(k)) << 32) |
            static_cast<uint32_t>((l << 16) | oc);
        const int slot = ty * kTileW + tx;
        if (!kSecond) {
          atomicMin(e.best + slot, packed);
        } else if (packed != e.best[slot]) {
          atomicMin(e.sec + slot, packed);
        }
      }
    }
  }
}

// A slot's (key, code): the key re-read from the winning source in the
// halo, the code oc * L + l; +inf / -1 for an empty slot.
__device__ __forceinline__ void write_slot(const Election& e, unsigned long long slot,
                                           int ty, int tx, int L, int n_oc,
                                           float* key_out, int32_t* code_out) {
  if (slot == kEmpty) {
    *key_out = __int_as_float(0x7f800000);
    *code_out = -1;
    return;
  }
  const int v = static_cast<int>(static_cast<uint32_t>(slot));
  const int l = v >> 16, oc = v & 0xffff;
  *key_out = e.key[(l * e.hh + ty - e.dy[oc]) * e.hw + tx - e.dx[oc]];
  *code_out = oc * L + l;
}

// Best and second-best (key, code) per target pixel over the L*(2R+1)^2
// sources whose offset code lands on it, visited in (layer, dv, du) order
// with strict '<' so that the first candidate wins ties; +inf / -1 where
// no candidate. A block elects the pairs of one tile (see the header).
__global__ void __launch_bounds__(kElectThreads) splat_argmin2_kernel(
    const float* __restrict__ key, const int32_t* __restrict__ off,
    float* __restrict__ bk, int32_t* __restrict__ bc, float* __restrict__ sk,
    int32_t* __restrict__ sc, int L, int H, int W, int R) {
  extern __shared__ unsigned long long smem[];
  const Election e(smem, L, R);
  const int w2 = 2 * R + 1, n_oc = w2 * w2;
  const int hp = H + 2 * R, wp = W + 2 * R;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The halo: padded rows [y0, y0 + hh) and columns [x0, x0 + hw), whose
  // sources are all that can land on the tile (a source at padded (py, px)
  // with offset (dv, du) lands on (py - R + dv, px - R + du)), copied with
  // every load in flight; past the padded frame, code -1.
  for (int l = 0; l < L; ++l) {
    const int layer = (b * L + l) * hp * wp;
    for (int hy = warp; hy < e.hh; hy += kElectWarps) {
      for (int hx = lane; hx < e.hw; hx += 32) {
        const int i = (l * e.hh + hy) * e.hw + hx;
        const int py = y0 + hy, px = x0 + hx;
        if (py < hp && px < wp) {
          const int src = layer + py * wp + px;
          __pipeline_memcpy_async(e.code + i, off + src, sizeof(int32_t));
          __pipeline_memcpy_async(e.key + i, key + src, sizeof(float));
        } else {
          e.code[i] = -1;
        }
      }
    }
  }
  __pipeline_commit();
  for (int t = threadIdx.x; t < kTileH * kTileW; t += kElectThreads) {
    e.best[t] = kEmpty;
    e.sec[t] = kEmpty;
  }
  for (int oc = threadIdx.x; oc < n_oc; oc += kElectThreads) {
    e.dy[oc] = oc / w2 - 2 * R;  // ty = hy - R + dv, dv = oc / w2 - R
    e.dx[oc] = oc % w2 - 2 * R;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  elect_sweep<false>(e, L, n_oc);
  __syncthreads();
  elect_sweep<true>(e, L, n_oc);
  __syncthreads();
  for (int t = threadIdx.x; t < kTileH * kTileW; t += kElectThreads) {
    const int ty = t / kTileW, tx = t % kTileW;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const int o = (b * H + y) * W + x;
    write_slot(e, e.best[t], ty, tx, L, n_oc, bk + o, bc + o);
    write_slot(e, e.sec[t], ty, tx, L, n_oc, sk + o, sc + o);
  }
}

// flow_select_rows: out[b,c,y,x] = rows[b,l,c,y+R-dv,x+R-du] for
// code[b,y,x] = oc*L + l; 0 where code is outside [0, L*(2R+1)^2). Copies
// the 32-bit patterns; rows' batch stride may be 0 (winner and runner-up
// codes of one map).
//
// What bounds it: bytes, above all the (B, C, H, W) output it writes
// (B = 2 and C = 8 on splat fusion's path) and the source rows the codes
// name; it does no arithmetic. On the path neighbouring pixels carry the
// same code (a bounded flow moves whole patches by one offset), so the
// sources of a warp's pixels are nearly contiguous, and what decides the
// time is that every load is in flight at once, that the grid fills the
// card in even waves, and that the output does not push the sources out
// of L2. Design:
// - a thread owns kSelectPix horizontally adjacent pixels: one vector load
//   of their codes, and one kSelectPix-wide store a channel when W is a
//   multiple of kSelectPix and the code and output rows are aligned to it
//   (the path's W = 672 is); scalar loads and stores otherwise. Two
//   pixels a thread (8-byte vectors) beat four on the path's frame: with
//   four, the registers allow fewer resident blocks than the grid has and
//   a few blocks run in a second wave of their own;
// - no runtime division a pixel: each block first builds, in shared
//   memory, the source offset of every code, l*C*plane + (2R - oc/w2)*wp
//   + (2R - oc%w2) from the pixel's own padded position (the code loads
//   are in flight meanwhile); a code is range-checked before it indexes
//   the table. A table past kMaxTableCodes entries (L*(2R+1)^2 > 12,288)
//   is decoded by divisions instead, in the same kernel;
// - all C channel loads of the thread's pixels are issued into registers
//   before its first store (C a template constant for the 8- and 11-
//   channel rows of splat fusion; other C in groups of 16 channels);
// - the output is written with streaming stores (st.global.cs), so that
//   it does not evict from L2 the source rows the winner and runner-up
//   images both read.
// This design was timed beside the previous one (one thread a pixel, four
// divisions, scalar stores), a shared-memory halo, and variants of the
// constants below (PERF.md §6, row 3).
constexpr int kSelectThreads = 256;
constexpr int kSelectPix = 2;  // pixels a thread, horizontally adjacent
constexpr int kSelectThreadsX = 32 / kSelectPix;  // a warp covers 32 columns
constexpr int kSelectThreadsY = kSelectThreads / kSelectThreadsX;
constexpr int kSelectGroup = 16;  // channels in registers, generic instance
constexpr int kMaxTableCodes = 12288;  // 48 KB of shared memory
constexpr bool kStreamStores = true;

// kSelectPix int32 words, loaded or stored as one vector.
template <int N> struct Words;
template <> struct Words<1> { using I = int32_t; using U = uint32_t; };
template <> struct Words<2> { using I = int2; using U = uint2; };
template <> struct Words<4> { using I = int4; using U = uint4; };

__device__ __forceinline__ void unpack(int32_t v, int32_t* w) { w[0] = v; }
__device__ __forceinline__ void unpack(int2 v, int32_t* w) { w[0] = v.x; w[1] = v.y; }
__device__ __forceinline__ void unpack(int4 v, int32_t* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
template <int N>
__device__ __forceinline__ typename Words<N>::U pack(const uint32_t* w);
template <> __device__ __forceinline__ uint32_t pack<1>(const uint32_t* w) { return w[0]; }
template <> __device__ __forceinline__ uint2 pack<2>(const uint32_t* w) {
  return make_uint2(w[0], w[1]);
}
template <> __device__ __forceinline__ uint4 pack<4>(const uint32_t* w) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void put(T* p, T v) {
  if (kStreamStores) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// The source offset of an in-range code from the target pixel's padded
// position: layer l's channel 0, row R - dv, column R - du.
__device__ __forceinline__ int code_source(int cd, int L, int C, int plane, int wp, int w2,
                                           int R) {
  const int l = cd % L, oc = cd / L;
  return l * C * plane + (2 * R - oc / w2) * wp + (2 * R - oc % w2);
}

// kCh channels (0: any C, in groups of kSelectGroup); kVec: the vector
// route (W % kSelectPix == 0, rows aligned); by_table: decode by the table
// (the same for every thread).
template <int kCh, bool kVec>
__global__ void __launch_bounds__(kSelectThreads) flow_select_rows_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ code,
    uint32_t* __restrict__ out, int L, int C, int H, int W, int R,
    int rows_bstride, bool by_table) {
  extern __shared__ int table[];
  const int w2 = 2 * R + 1, n_codes = L * w2 * w2;
  const int wp = W + 2 * R, plane = (H + 2 * R) * wp, hw = H * W;
  const int x0 = (blockIdx.x * kSelectThreadsX + threadIdx.x) * kSelectPix;
  const int y = blockIdx.y * kSelectThreadsY + threadIdx.y;
  const int b = blockIdx.z;
  const bool live = y < H && x0 < W;
  const int pix = b * hw + y * W + x0;
  int32_t cd[kSelectPix];
  if (kVec) {
    if (live) {
      unpack(__ldg(reinterpret_cast<const typename Words<kSelectPix>::I*>(code + pix)), cd);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSelectPix; ++j) cd[j] = live && x0 + j < W ? __ldg(code + pix + j) : -1;
  }
  if (by_table) {
    for (int i = threadIdx.y * kSelectThreadsX + threadIdx.x; i < n_codes; i += kSelectThreads) {
      table[i] = code_source(i, L, C, plane, wp, w2, R);
    }
    __syncthreads();
  }
  if (!live) return;
  bool ok[kSelectPix];
  int src[kSelectPix];
#pragma unroll
  for (int j = 0; j < kSelectPix; ++j) {
    ok[j] = static_cast<unsigned>(cd[j]) < static_cast<unsigned>(n_codes);
    const int at = ok[j] ? cd[j] : 0;
    src[j] = (by_table ? table[at] : code_source(at, L, C, plane, wp, w2, R)) + j;
  }
  const int cn = kCh > 0 ? kCh : C;
  const uint32_t* base = rows + b * rows_bstride + y * wp + x0;
  uint32_t* dst = out + b * cn * hw + y * W + x0;
  constexpr int kRegs = kCh > 0 ? kCh : kSelectGroup;
  for (int c0 = 0; c0 < cn; c0 += kRegs) {
    uint32_t v[kRegs][kSelectPix];
#pragma unroll
    for (int c = 0; c < kRegs; ++c) {
#pragma unroll
      for (int j = 0; j < kSelectPix; ++j) {
        v[c][j] = ok[j] && (kCh > 0 || c0 + c < cn)
                      ? __ldg(base + src[j] + (c0 + c) * plane) : 0u;
      }
    }
#pragma unroll
    for (int c = 0; c < kRegs; ++c) {
      if (kCh == 0 && c0 + c >= cn) break;
      uint32_t* d = dst + (c0 + c) * hw;
      if (kVec) {
        put(reinterpret_cast<typename Words<kSelectPix>::U*>(d), pack<kSelectPix>(v[c]));
      } else {
#pragma unroll
        for (int j = 0; j < kSelectPix; ++j) {
          if (x0 + j < W) put(d + j, v[c][j]);
        }
      }
    }
  }
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

// design: null, or 3 ints for the tile's width and height and the blocks.
// A halo past the shared memory a block can have (16 layers or more at R = 4)
// is refused with cudaErrorInvalidValue.
int splat_argmin2_launch(const void* key, const void* off, void* bk,
                         void* bc, void* sk, void* sc, int B, int L, int H,
                         int W, int R, void* design, void* stream) {
  const size_t smem = election_smem_bytes(L, R);
  if (smem > 48 * 1024) {
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        splat_argmin2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  splat_argmin2_kernel<<<grid, kElectThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key), static_cast<const int32_t*>(off),
      static_cast<float*>(bk), static_cast<int32_t*>(bc),
      static_cast<float*>(sk), static_cast<int32_t*>(sc), L, H, W, R);
  if (design) {
    int* d = static_cast<int*>(design);
    d[0] = kTileW;
    d[1] = kTileH;
    d[2] = static_cast<int>(grid.x * grid.y * grid.z);
  }
  return static_cast<int>(cudaGetLastError());
}

// design: null, or 5 ints for the pixels a thread, the decode (1 table, 0
// divisions), the store's bytes, the channel instance (C, or 0 for the
// generic one) and the blocks.
int flow_select_rows_launch(const void* rows, const void* code, void* out,
                            int B, int L, int C, int H, int W, int R,
                            int rows_bstride, void* design, void* stream) {
  const int n_codes = L * (2 * R + 1) * (2 * R + 1);
  const bool table = n_codes <= kMaxTableCodes;
  const bool vec = W % kSelectPix == 0 &&
                   reinterpret_cast<uintptr_t>(code) % (4 * kSelectPix) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * kSelectPix) == 0;
  const int ch = C == 8 || C == 11 ? C : 0;
  const dim3 block(kSelectThreadsX, kSelectThreadsY);
  const dim3 grid((W + kSelectThreadsX * kSelectPix - 1) / (kSelectThreadsX * kSelectPix),
                  (H + kSelectThreadsY - 1) / kSelectThreadsY, B);
  const size_t smem = table ? sizeof(int) * n_codes : 0;
  auto kernel = vec ? flow_select_rows_kernel<0, true> : flow_select_rows_kernel<0, false>;
  if (ch == 8) kernel = vec ? flow_select_rows_kernel<8, true> : flow_select_rows_kernel<8, false>;
  if (ch == 11) kernel = vec ? flow_select_rows_kernel<11, true> : flow_select_rows_kernel<11, false>;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(code),
      static_cast<uint32_t*>(out), L, C, H, W, R, rows_bstride, table);
  if (design) {
    int* d = static_cast<int*>(design);
    d[0] = kSelectPix;
    d[1] = table ? 1 : 0;
    d[2] = vec ? 4 * kSelectPix : 4;
    d[3] = ch;
    d[4] = static_cast<int>(grid.x * grid.y * grid.z);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

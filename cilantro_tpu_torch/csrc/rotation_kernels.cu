// The closest rotation to a 3x3 matrix, for Hopper (sm_90a).
//
//   project_to_rotation_kernel  <- jnp.linalg.svd + det sign fix inside
//                                  cilantro_tpu/core/transforms.py,
//                                  project_to_rotation (XLA, no Pallas kernel)
//
// R = u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T for each matrix A of a
// batch: v1, v2 are the eigenvectors of A^T A of its two largest
// eigenvalues (cyclic Jacobi, 4 sweeps), u1 = A v1 / |A v1| and u2 the unit
// part of A v2 orthogonal to u1. That is U diag(1, 1, det(U V^T)) V^T of
// the SVD A = U S V^T, with no third singular value needed, so a rank-2
// matrix has a proper answer too. Exact zeros fall back so that A = 0
// gives the identity, as the SVD route does.
//
// Why a kernel: the GN and ICP loops re-project their rotation once an
// iteration, and torch.linalg.svd on the card checks its info code on the
// host. A graph capture of the loop cannot hold a host wait, and the same
// routine written as tensor ops is ~840 launches a call.
//
// Bound: by the launch. One 3x3 matrix is 72 bytes and ~700 operations
// (chip_smoke.py ROTATION_OPS); the time is the launch and one thread's
// dependent chain of square roots and divisions. One thread per matrix.
//
// Bit for bit equal to project_to_rotation_plain in
// cilantro_tpu_torch/core/transforms.py: every operation is one IEEE
// rounding (__fmul_rn etc. keep nvcc from contracting a product and a sum
// into an FMA), in the plain version's order.
//
// The launcher enqueues on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// (x0*y0 + x1*y1) + x2*y2
__device__ __forceinline__ float dot3(const float* x, const float* y) {
  return add(add(mul(x[0], y[0]), mul(x[1], y[1])), mul(x[2], y[2]));
}

__device__ __forceinline__ void cross3(const float* x, const float* y, float* o) {
  o[0] = sub(mul(x[1], y[2]), mul(x[2], y[1]));
  o[1] = sub(mul(x[2], y[0]), mul(x[0], y[2]));
  o[2] = sub(mul(x[0], y[1]), mul(x[1], y[0]));
}

__global__ void project_to_rotation_kernel(const float* __restrict__ in,
                                           float* __restrict__ out, int n) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = in[9 * m + 3 * i + j];

  // b = A^T A, v = I.
  float b[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      b[i][j] = add(add(mul(a[0][i], a[0][j]), mul(a[1][i], a[1][j])),
                    mul(a[2][i], a[2][j]));
      v[i][j] = i == j ? 1.0f : 0.0f;
    }

#pragma unroll
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0;
      const int q = pair == 0 ? 1 : 2;
      const int r = 3 - p - q;
      // The rotation that zeroes b[p][q] (the smaller angle).
      const float apq = b[p][q];
      const float theta = dvd(sub(b[q][q], b[p][p]), mul(2.0f, apq));
      float t = dvd(theta >= 0.0f ? 1.0f : -1.0f,
                    add(fabsf(theta), __fsqrt_rn(add(mul(theta, theta), 1.0f))));
      t = apq == 0.0f ? 0.0f : t;
      const float c = dvd(1.0f, __fsqrt_rn(add(mul(t, t), 1.0f)));
      const float s = mul(t, c);
      b[p][p] = sub(b[p][p], mul(t, apq));
      b[q][q] = add(b[q][q], mul(t, apq));
      b[p][q] = b[q][p] = 0.0f;
      const float brp = b[r][p], brq = b[r][q];
      b[r][p] = b[p][r] = sub(mul(c, brp), mul(s, brq));
      b[r][q] = b[q][r] = add(mul(s, brp), mul(c, brq));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float vkp = v[k][p], vkq = v[k][q];
        v[k][p] = sub(mul(c, vkp), mul(s, vkq));
        v[k][q] = add(mul(s, vkp), mul(c, vkq));
      }
    }
  }

  // Largest eigenvalue (the first among equals) and smallest (the last).
  const float d0 = b[0][0], d1 = b[1][1], d2 = b[2][2];
  const int i1 = (d0 >= d1 && d0 >= d2) ? 0 : (d1 >= d2 ? 1 : 2);
  const int i3 = (d2 <= d1 && d2 <= d0) ? 2 : (d1 <= d0 ? 1 : 0);
  const int i2 = 3 - i1 - i3;
  float v1[3], v2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v1[k] = v[k][i1];
    v2[k] = v[k][i2];
  }

  float w1[3], w2[3], u1[3], u2[3], g[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w1[i] = dot3(a[i], v1);
    w2[i] = dot3(a[i], v2);
  }
  const float n1 = __fsqrt_rn(dot3(w1, w1));
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = n1 > 0.0f ? dvd(w1[i], n1) : v1[i];
  const float d12 = dot3(u1, w2);
  const float e12 = dot3(u1, v2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w2[i] = sub(w2[i], mul(d12, u1[i]));
    g[i] = sub(v2[i], mul(e12, u1[i]));
  }
  const float n2 = __fsqrt_rn(dot3(w2, w2));
  const float ng = __fsqrt_rn(dot3(g, g));
  float h[3];
  cross3(u1, v1, h);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    u2[i] = n2 > 0.0f ? dvd(w2[i], n2) : (ng > 0.0f ? dvd(g[i], ng) : h[i]);

  float u3[3], v3[3];
  cross3(u1, u2, u3);
  cross3(v1, v2, v3);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[9 * m + 3 * i + j] =
          add(add(mul(u1[i], v1[j]), mul(u2[i], v2[j])), mul(u3[i], v3[j]));
}

}  // namespace

extern "C" {

int project_to_rotation_launch(const void* in, void* out, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  project_to_rotation_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

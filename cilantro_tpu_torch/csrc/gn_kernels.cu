// One Gauss-Newton step of the rigid 3-D combined and symmetric metrics,
// for Hopper (sm_90a), as three launches:
//
//   gn_means_kernel  the weighted means of src and dst and the rows with
//                    weight > 0, as partials, one a block
//   gn_sums_kernel   JᵀJ's 21 unique entries and g = Σ w J r (6), as
//                    partials, one a block, over rows centred on the means
//                    and moved by the step's current transform
//   gn_solve_kernel  one block: the partials summed, the 6×6 system solved,
//                    the two-sided update applied and the result uncentred
//
// <- cilantro_tpu/registration/transform_estimation.py's
//    estimate_rigid_combined_metric / estimate_rigid_symmetric_metric (XLA,
//    no Pallas kernel): _weighted_means, _gn_accumulate_3d,
//    _solve_normal_equations, _two_sided_update_3d and _uncentre.
//
// Why kernels: written as tensor ops the step is ~350 dispatched operations
// and ~116 launches, with JᵀJ as cuBLAS GEMMs of a 6×6 output over N rows;
// the rows weigh 44-56 bytes each, a few µs of the card's bandwidth.
//
// Bound: by the bytes of the rows (read twice: once for the means, once
// for the sums) and by the launches. A thread takes rows i, i + B·256, ...
// (B blocks); a block sums its threads; the solve is one thread's
// dependent chain of ~300 double operations.
//
// Arithmetic: every row is read as float32 and computed in float64; every
// sum accumulates in float64. The weights are summed in float32 first
// (w = w_pp + w_pl), as the einsum path does. The order of every sum is
// fixed, so two runs give the same bits and no atomics are used:
//   a thread's rows in order of the row index;
//   a block: halving within each warp (lane l adds lane l + 16, then l + 8,
//   ..., l + 1), then halving over the 8 warps' sums (warp w adds w + 4,
//   + 2, + 1);
//   the partials: thread i of one block takes block i's partial (0 past the
//   grid), then the same block order. Every block of gn_sums_kernel and
//   gn_solve_kernel combines the means' partials so, with the same bits.
// The rows' point-to-point terms are skipped where w_pp is 0. The system
// (JᵀJ + 1e-12·I) x = −g is solved by LU with partial pivoting (the first
// row of the largest |pivot|), then back substitution.
//
// Bit for bit equal to gn_step_plain in
// cilantro_tpu_torch/registration/gn_step.py: every operation is one IEEE
// rounding (__dmul_rn etc. keep nvcc from contracting a product and a sum
// into an FMA), in the plain version's order; atan, sin, cos and sqrt are
// the CUDA math library's, as PyTorch's float64 ops on the card.
//
// The launcher enqueues on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after each launch so
// that a refused launch is reported. A CUDA graph capture holds it.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = kThreads;  // the solve's block holds one partial a thread
constexpr int kMeans = 8;             // Σw, Σw·s (3), Σw·d (3), rows with w > 0
constexpr int kSums = 27;             // JᵀJ's upper triangle row by row (21), g (6)
constexpr int kState = 12;            // the step's transform, centred: R (9), t (3)
// The workspace (float64): the means' partials [kMaxBlocks][kMeans], the
// sums' partials [kMaxBlocks][kSums], the state [kState].
constexpr int kSumsAt = kMaxBlocks * kMeans;
constexpr int kStateAt = kSumsAt + kMaxBlocks * kSums;
constexpr double kEps = 1e-12;  // the least weight sum the means divide by; JᵀJ's damping

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

// (x0*y0 + x1*y1) + x2*y2
__device__ __forceinline__ double dot3(const double* x, const double* y) {
  return add(add(mul(x[0], y[0]), mul(x[1], y[1])), mul(x[2], y[2]));
}

struct Rows {
  const float* src;
  const float* dst;
  const float* src_normals;  // null: the combined metric
  const float* dst_normals;
  const float* w_pp;
  const float* w_pl;
  int src_st, dst_st, src_normals_st, dst_normals_st, w_pp_st, w_pl_st;  // row strides
  int n;
};

__device__ __forceinline__ float load1(const float* base, int st, int i) {
  return base[static_cast<long long>(i) * st];
}

__device__ __forceinline__ void load3(const float* base, int st, int i, double* out) {
  const float* p = base + static_cast<long long>(i) * st;
  out[0] = p[0];
  out[1] = p[1];
  out[2] = p[2];
}

// v summed over the block in the fixed order above; every thread returns
// the block's sum. sh: [kWarps][K] of shared memory.
template <int K>
__device__ void block_sum(double (&v)[K], double (*sh)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = add(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) sh[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    double w[kWarps];
#pragma unroll
    for (int i = 0; i < kWarps; ++i) w[i] = sh[i][k];
#pragma unroll
    for (int h = kWarps / 2; h > 0; h >>= 1)
#pragma unroll
      for (int i = 0; i < h; ++i) w[i] = add(w[i], w[i + h]);
    sh[0][k] = w[0];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = sh[0][k];
  __syncthreads();
}

// The means' partials combined, the same bits in every block: m = [Σw,
// Σw·s, Σw·d, rows with w > 0], and the means μs, μd.
__device__ void combine_means(const double* ws, int blocks, double (*sh)[kMeans],
                              double (&m)[kMeans], double* mu_s, double* mu_d) {
#pragma unroll
  for (int k = 0; k < kMeans; ++k)
    m[k] = static_cast<int>(threadIdx.x) < blocks ? ws[threadIdx.x * kMeans + k] : 0.0;
  block_sum<kMeans>(m, sh);
  const double den = m[0] < kEps ? kEps : m[0];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mu_s[c] = dvd(m[1 + c], den);
    mu_d[c] = dvd(m[4 + c], den);
  }
}

__global__ void __launch_bounds__(kThreads) gn_means_kernel(Rows r, double* ws) {
  __shared__ double sh[kWarps][kMeans];
  double v[kMeans];
#pragma unroll
  for (int k = 0; k < kMeans; ++k) v[k] = 0.0;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < r.n; i += stride) {
    const float wf = __fadd_rn(load1(r.w_pp, r.w_pp_st, i), load1(r.w_pl, r.w_pl_st, i));
    const double w = wf;
    double s[3], d[3];
    load3(r.src, r.src_st, i, s);
    load3(r.dst, r.dst_st, i, d);
    v[0] = add(v[0], w);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[1 + c] = add(v[1 + c], mul(w, s[c]));
      v[4 + c] = add(v[4 + c], mul(w, d[c]));
    }
    v[7] = add(v[7], wf > 0.0f ? 1.0 : 0.0);
  }
  block_sum<kMeans>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMeans; ++k) ws[blockIdx.x * kMeans + k] = v[k];
    if (blockIdx.x == 0)  // the step's transform starts at the identity
#pragma unroll
      for (int k = 0; k < kState; ++k) ws[kStateAt + k] = (k < 9 && k % 4 == 0) ? 1.0 : 0.0;
  }
}

// Index of JᵀJ's entry (i, j), i <= j, in its upper triangle row by row.
__host__ __device__ constexpr int tri(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

__global__ void __launch_bounds__(kThreads, 2) gn_sums_kernel(Rows r, double* ws) {
  __shared__ double shm[kWarps][kMeans];
  __shared__ double shs[kWarps][kSums];
  double m[kMeans], mu_s[3], mu_d[3];
  combine_means(ws, gridDim.x, shm, m, mu_s, mu_d);
  double rot[3][3], tr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) rot[i][j] = ws[kStateAt + 3 * i + j];
    tr[i] = ws[kStateAt + 9 + i];
  }

  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < r.n; i += stride) {
    const double wpp = load1(r.w_pp, r.w_pp_st, i), wpl = load1(r.w_pl, r.w_pl_st, i);
    double s[3], d[3], nd[3], cs[3], sp[3], n[3], p[3], e[3];
    load3(r.src, r.src_st, i, s);
    load3(r.dst, r.dst_st, i, d);
    load3(r.dst_normals, r.dst_normals_st, i, nd);
#pragma unroll
    for (int c = 0; c < 3; ++c) cs[c] = sub(s[c], mu_s[c]);
#pragma unroll
    for (int c = 0; c < 3; ++c) sp[c] = add(dot3(rot[c], cs), tr[c]);
    if (r.src_normals) {  // symmetric: n = n_dst + R n_src, not normalised
      double ns[3];
      load3(r.src_normals, r.src_normals_st, i, ns);
#pragma unroll
      for (int c = 0; c < 3; ++c) n[c] = add(nd[c], dot3(rot[c], ns));
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) n[c] = nd[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double cd = sub(d[c], mu_d[c]);
      p[c] = add(sp[c], cd);  // the rotation rows' (s + d)
      e[c] = sub(sp[c], cd);  // s − d
    }
    // Plane row: J = [p × n | n], residual n·(s − d).
    const double jac[6] = {sub(mul(p[1], n[2]), mul(p[2], n[1])),
                           sub(mul(p[2], n[0]), mul(p[0], n[2])),
                           sub(mul(p[0], n[1]), mul(p[1], n[0])), n[0], n[1], n[2]};
    const double res = dot3(n, e);
    double c[kSums];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const double wa = mul(wpl, jac[a]);
#pragma unroll
      for (int b = a; b < 6; ++b) c[tri(a, b)] = mul(wa, jac[b]);
      c[21 + a] = mul(wa, res);
    }
    if (wpp != 0.0) {
      // Point rows: J = [−[p]× | I], residual s − d. JᵀJ's rotation block
      // [p]×ᵀ[p]× = |p|² I − p pᵀ, its cross block [p]×, the translation
      // block I; Jᵀr = [p × e | e].
      const double q0 = mul(p[0], p[0]), q1 = mul(p[1], p[1]), q2 = mul(p[2], p[2]);
      c[tri(0, 0)] = add(c[tri(0, 0)], mul(wpp, add(q1, q2)));
      c[tri(1, 1)] = add(c[tri(1, 1)], mul(wpp, add(q0, q2)));
      c[tri(2, 2)] = add(c[tri(2, 2)], mul(wpp, add(q0, q1)));
      c[tri(0, 1)] = sub(c[tri(0, 1)], mul(wpp, mul(p[0], p[1])));
      c[tri(0, 2)] = sub(c[tri(0, 2)], mul(wpp, mul(p[0], p[2])));
      c[tri(1, 2)] = sub(c[tri(1, 2)], mul(wpp, mul(p[1], p[2])));
      c[tri(0, 4)] = sub(c[tri(0, 4)], mul(wpp, p[2]));
      c[tri(0, 5)] = add(c[tri(0, 5)], mul(wpp, p[1]));
      c[tri(1, 3)] = add(c[tri(1, 3)], mul(wpp, p[2]));
      c[tri(1, 5)] = sub(c[tri(1, 5)], mul(wpp, p[0]));
      c[tri(2, 3)] = sub(c[tri(2, 3)], mul(wpp, p[1]));
      c[tri(2, 4)] = add(c[tri(2, 4)], mul(wpp, p[0]));
      c[tri(3, 3)] = add(c[tri(3, 3)], wpp);
      c[tri(4, 4)] = add(c[tri(4, 4)], wpp);
      c[tri(5, 5)] = add(c[tri(5, 5)], wpp);
      const double h[6] = {sub(mul(p[1], e[2]), mul(p[2], e[1])),
                           sub(mul(p[2], e[0]), mul(p[0], e[2])),
                           sub(mul(p[0], e[1]), mul(p[1], e[0])), e[0], e[1], e[2]};
#pragma unroll
      for (int a = 0; a < 6; ++a) c[21 + a] = add(c[21 + a], mul(wpp, h[a]));
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = add(acc[k], c[k]);
  }
  block_sum<kSums>(acc, shs);
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < kSums; ++k) ws[kSumsAt + blockIdx.x * kSums + k] = acc[k];
}

// out: R (9), t (3) of the uncentred estimate, then the step's norm (float32);
// valid: at least 3 rows of weight > 0.
__global__ void __launch_bounds__(kThreads) gn_solve_kernel(double* ws, int blocks, float* out,
                                                            bool* valid) {
  __shared__ double shm[kWarps][kMeans];
  __shared__ double shs[kWarps][kSums];
  double m[kMeans], mu_s[3], mu_d[3];
  combine_means(ws, blocks, shm, m, mu_s, mu_d);
  double v[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
    v[k] = static_cast<int>(threadIdx.x) < blocks ? ws[kSumsAt + threadIdx.x * kSums + k] : 0.0;
  block_sum<kSums>(v, shs);
  if (threadIdx.x != 0) return;

  double a[6][6], b[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) a[i][j] = a[j][i] = v[tri(i, j)];
    a[i][i] = add(a[i][i], kEps);
    b[i] = -v[21 + i];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    double best = fabs(a[c][c]);
#pragma unroll
    for (int i = c + 1; i < 6; ++i)
      if (fabs(a[i][c]) > best) {
        best = fabs(a[i][c]);
        piv = i;
      }
#pragma unroll
    for (int i = c + 1; i < 6; ++i)
      if (i == piv) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const double t = a[c][j];
          a[c][j] = a[i][j];
          a[i][j] = t;
        }
        const double t = b[c];
        b[c] = b[i];
        b[i] = t;
      }
#pragma unroll
    for (int i = c + 1; i < 6; ++i) {
      const double l = dvd(a[i][c], a[c][c]);
#pragma unroll
      for (int j = c + 1; j < 6; ++j) a[i][j] = sub(a[i][j], mul(l, a[c][j]));
      b[i] = sub(b[i], mul(l, b[c]));
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = sub(s, mul(a[i][j], x[j]));
    x[i] = dvd(s, a[i][i]);
  }

  // The two-sided update Ra · T(cos θ · t) · Ra, θ = atan‖ω‖, Ra the
  // rotation by θ about ω: R = cos θ I + sin θ [u]× + (1 − cos θ) u uᵀ.
  const double na = sqrt(dot3(x, x));
  const double th = atan(na), co = cos(th), si = sin(th), om = sub(1.0, co);
  double u[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = na > 0.0 ? dvd(x[c], na) : 0.0;
  const double k[3][3] = {{0.0, -u[2], u[1]}, {u[2], 0.0, -u[0]}, {-u[1], u[0], 0.0}};
  double rh[3][3], ta[3], rd[3][3], td[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) rh[i][j] = add(mul(mul(om, u[i]), u[j]), i == j ? co : mul(si, k[i][j]));
    ta[i] = mul(co, x[3 + i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double col[3] = {rh[0][j], rh[1][j], rh[2][j]};
      rd[i][j] = dot3(rh[i], col);
    }
    td[i] = dot3(rh[i], ta);
  }
  // The step's transform: delta ∘ state.
  double* st = ws + kStateAt;
  double rs[3][3], ts[3], rn[3][3], tn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) rs[i][j] = st[3 * i + j];
    ts[i] = st[9 + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double col[3] = {rs[0][j], rs[1][j], rs[2][j]};
      rn[i][j] = dot3(rd[i], col);
    }
    tn[i] = add(dot3(rd[i], ts), td[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      st[3 * i + j] = rn[i][j];
      out[3 * i + j] = static_cast<float>(rn[i][j]);
    }
    st[9 + i] = tn[i];
    // Uncentred: T(μd) ∘ state ∘ T(−μs).
    out[9 + i] = static_cast<float>(add(sub(tn[i], dot3(rn[i], mu_s)), mu_d[i]));
  }
  double nrm = 0.0;
#pragma unroll
  for (int c = 0; c < 6; ++c) nrm = add(nrm, mul(x[c], x[c]));
  out[12] = static_cast<float>(sqrt(nrm));
  *valid = m[7] >= 3.0;
}

}  // namespace

extern "C" {

// One GN step: the means pass when `first` (it also sets the step's
// transform to the identity), then the sums pass and the solve. `blocks`
// (1 to 256) is the grid of both passes.
int gn_step_launch(const void* src, int src_st, const void* dst, int dst_st,
                   const void* src_normals, int src_normals_st, const void* dst_normals,
                   int dst_normals_st, const void* w_pp, int w_pp_st, const void* w_pl, int w_pl_st,
                   int n, int blocks, int first, void* ws, void* out, void* valid, void* stream) {
  if (blocks < 1 || blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  const Rows r{static_cast<const float*>(src), static_cast<const float*>(dst),
               static_cast<const float*>(src_normals), static_cast<const float*>(dst_normals),
               static_cast<const float*>(w_pp), static_cast<const float*>(w_pl),
               src_st, dst_st, src_normals_st, dst_normals_st, w_pp_st, w_pl_st, n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* w = static_cast<double*>(ws);
  cudaError_t err;
  if (first) {
    gn_means_kernel<<<blocks, kThreads, 0, s>>>(r, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  gn_sums_kernel<<<blocks, kThreads, 0, s>>>(r, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gn_solve_kernel<<<1, kThreads, 0, s>>>(w, blocks, static_cast<float*>(out),
                                         static_cast<bool*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

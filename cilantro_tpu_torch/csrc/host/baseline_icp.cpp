// Single-core C++ baseline: kd-tree point-to-plane rigid ICP.
//
// This is the honest CPU reference the benchmarks compare against — the same
// algorithm class as the reference pipeline (nanoflann kd-tree + combined-
// metric GN, examples/rigid_icp.cpp:116-133), written from scratch: a
// median-split kd-tree with best-bin-first descent, a point-to-plane
// Gauss-Newton accumulation, and a hand-rolled 6x6 Cholesky solve (no Eigen
// on this image). Compiled -O3 single-thread; timed end-to-end inside
// baseline_icp() so Python overhead is excluded.
//
// ABI:
//   baseline_icp(src, dst, dst_normals, n_src, n_dst, max_iter,
//                max_corr_dist_sq, conv_tol, out_transform[12], out_ms)
//     -> iterations performed (negative on error)
//   out_transform: row-major 3x4 [R | t] mapping src onto dst.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "cpu_geom.hpp"

extern "C" {

int baseline_icp(const float* src, const float* dst, const float* dst_normals,
                 int64_t n_src, int64_t n_dst, int max_iter,
                 float max_corr_dist_sq, float conv_tol, float* out_transform,
                 double* out_ms) {
  if (!src || !dst || !dst_normals || n_src <= 0 || n_dst <= 0) return -1;
  auto t0 = std::chrono::steady_clock::now();

  KDTree tree;
  tree.build(dst, int(n_dst));

  double rot[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  double tr[3] = {0, 0, 0};
  std::vector<float> warped(size_t(n_src) * 3);

  int it = 0;
  for (; it < max_iter; it++) {
    // Transform src.
    for (int64_t i = 0; i < n_src; i++) {
      const float* p = src + 3 * i;
      for (int r = 0; r < 3; r++)
        warped[3 * i + r] = float(rot[r][0] * p[0] + rot[r][1] * p[1] +
                                  rot[r][2] * p[2] + tr[r]);
    }
    // Accumulate point-to-plane normal equations (one GN iteration per
    // correspondence pass, as the reference default).
    double ata[6][6] = {}, atb[6] = {};
    int64_t n_corr = 0;
    for (int64_t i = 0; i < n_src; i++) {
      const float* s = &warped[3 * i];
      float d2;
      int j = tree.nn(s, max_corr_dist_sq, &d2);
      if (j < 0) continue;
      const float* d = dst + 3 * j;
      const float* n = dst_normals + 3 * j;
      // J = [(s x n); n], r = n . (s - d)
      double jrow[6] = {
          double(s[1]) * n[2] - double(s[2]) * n[1],
          double(s[2]) * n[0] - double(s[0]) * n[2],
          double(s[0]) * n[1] - double(s[1]) * n[0],
          n[0], n[1], n[2]};
      double r = double(n[0]) * (s[0] - d[0]) + double(n[1]) * (s[1] - d[1]) +
                 double(n[2]) * (s[2] - d[2]);
      for (int a = 0; a < 6; a++) {
        atb[a] -= jrow[a] * r;
        for (int b = a; b < 6; b++) ata[a][b] += jrow[a] * jrow[b];
      }
      n_corr++;
    }
    if (n_corr < 6) return -2;
    for (int a = 0; a < 6; a++)
      for (int b = 0; b < a; b++) ata[a][b] = ata[b][a];
    for (int a = 0; a < 6; a++) ata[a][a] += 1e-9;
    double x[6];
    if (!chol_solve6(ata, atb, x)) return -3;

    // Update: R(atan||w||) then t (reference update convention).
    double na = std::sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
    double scale = na > 1e-12 ? std::atan(na) / na : 1.0;
    double w[3] = {x[0] * scale, x[1] * scale, x[2] * scale};
    double dr[3][3];
    axis_angle_rot(w, dr);
    double new_rot[3][3];
    mat_mul3(dr, rot, new_rot);
    std::memcpy(rot, new_rot, sizeof(rot));
    const double t_old[3] = {tr[0], tr[1], tr[2]};
    for (int r = 0; r < 3; r++)
      tr[r] = dr[r][0] * t_old[0] + dr[r][1] * t_old[1] +
              dr[r][2] * t_old[2] + x[3 + r];
    double step = 0;
    for (int a = 0; a < 6; a++) step += x[a] * x[a];
    if (std::sqrt(step) < conv_tol) {
      it++;
      break;
    }
  }

  for (int r = 0; r < 3; r++) {
    for (int c = 0; c < 3; c++) out_transform[4 * r + c] = float(rot[r][c]);
    out_transform[4 * r + 3] = float(tr[r]);
  }
  auto t1 = std::chrono::steady_clock::now();
  *out_ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
  return it;
}

// Single-core kd-tree kNN baseline: build over (n, 3) keys, query all
// (m, 3) queries for k neighbors (self excluded when queries == keys and
// exclude_self != 0). out_idx is (m, k) int32 (-1 pads), out_d2 (m, k).
// Returns 0; *out_build_ms / *out_query_ms report the two phases.
int baseline_knn(const float* keys, int64_t n, const float* queries,
                 int64_t m, int k, int exclude_self, int* out_idx,
                 float* out_d2, double* out_build_ms, double* out_query_ms) {
  if (!keys || !queries || n <= 0 || m <= 0 || k <= 0) return -1;
  auto t0 = std::chrono::steady_clock::now();
  KDTree tree;
  tree.build(keys, int(n));
  auto t1 = std::chrono::steady_clock::now();
  for (int64_t i = 0; i < m; i++) {
    tree.knn(queries + 3 * i, k, exclude_self ? int(i) : -1,
             out_idx + size_t(i) * k, out_d2 + size_t(i) * k);
  }
  auto t2 = std::chrono::steady_clock::now();
  *out_build_ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
  *out_query_ms = std::chrono::duration<double, std::milli>(t2 - t1).count();
  return 0;
}

// Single-core kd-tree radius query baseline: up to k nearest within
// sqrt(r2) per query (ascending), plus the true in-radius count in
// out_count (count > k == overflow) — the CPU denominator for the TPU
// radius rows (reference radius search: core/kd_tree.hpp:236-273).
int baseline_radius(const float* keys, int64_t n, const float* queries,
                    int64_t m, float r2, int k, int exclude_self,
                    int* out_idx, float* out_d2, int* out_count,
                    double* out_build_ms, double* out_query_ms) {
  if (!keys || !queries || n <= 0 || m <= 0 || k <= 0 || r2 <= 0) return -1;
  auto t0 = std::chrono::steady_clock::now();
  KDTree tree;
  tree.build(keys, int(n));
  auto t1 = std::chrono::steady_clock::now();
  for (int64_t i = 0; i < m; i++) {
    out_count[i] = tree.radius_knn(queries + 3 * i, r2, k,
                                   exclude_self ? int(i) : -1,
                                   out_idx + size_t(i) * k,
                                   out_d2 + size_t(i) * k);
  }
  auto t2 = std::chrono::steady_clock::now();
  *out_build_ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
  *out_query_ms = std::chrono::duration<double, std::milli>(t2 - t1).count();
  return 0;
}

}  // extern "C"

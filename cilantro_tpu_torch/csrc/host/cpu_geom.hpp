// Shared single-core CPU geometry primitives for the native baselines
// (median-split kd-tree with best-bin-first descent, 6x6 Cholesky,
// axis-angle rotation, 3x3 matmul) — from-scratch code factored out of
// baseline_icp.cpp so baseline_warp.cpp reuses it. Header-only, wrapped in
// an anonymous namespace by the including translation unit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>


struct KDNode {
  float split;
  int axis;       // -1 for leaf
  int left, right;  // children (indices into nodes) or [begin,end) for leaf
};

// A compact median-split kd-tree over (n, 3) float points.
struct KDTree {
  const float* pts;
  std::vector<int> idx;
  std::vector<KDNode> nodes;
  int leaf_size = 16;

  void build(const float* p, int n) {
    pts = p;
    idx.resize(n);
    for (int i = 0; i < n; i++) idx[i] = i;
    nodes.clear();
    nodes.reserve(2 * n / leaf_size + 8);
    build_rec(0, n);
  }

  int build_rec(int begin, int end) {
    int node_id = int(nodes.size());
    nodes.push_back({});
    if (end - begin <= leaf_size) {
      nodes[node_id] = {0.0f, -1, begin, end};
      return node_id;
    }
    // Widest-extent axis.
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = begin; i < end; i++) {
      const float* q = pts + 3 * idx[i];
      for (int a = 0; a < 3; a++) {
        if (q[a] < lo[a]) lo[a] = q[a];
        if (q[a] > hi[a]) hi[a] = q[a];
      }
    }
    int axis = 0;
    float ext = hi[0] - lo[0];
    for (int a = 1; a < 3; a++)
      if (hi[a] - lo[a] > ext) ext = hi[a] - lo[a], axis = a;
    int mid = (begin + end) / 2;
    std::nth_element(idx.begin() + begin, idx.begin() + mid, idx.begin() + end,
                     [&](int a, int b) { return pts[3 * a + axis] < pts[3 * b + axis]; });
    float split = pts[3 * idx[mid] + axis];
    int left = build_rec(begin, mid);
    int right = build_rec(mid, end);
    nodes[node_id] = {split, axis, left, right};
    return node_id;
  }

  // Nearest neighbor within sqrt(max_d2); returns index or -1.
  int nn(const float* q, float max_d2, float* out_d2) const {
    best_i = -1;
    best_d2 = max_d2;
    search(0, q);
    *out_d2 = best_d2;
    return best_i;
  }

  // k nearest neighbors (ascending); skips `self` (pass -1 to keep all).
  // out_i/out_d2 must hold k entries; slots past the found count get
  // idx = -1 and d2 = +huge (so an unchecked distance read cannot be
  // mistaken for a perfect 0-distance neighbor).
  int knn(const float* q, int k, int self, int* out_i, float* out_d2) const {
    k_cap = k;
    k_cnt = 0;
    k_self = self;
    k_i = out_i;
    k_d2 = out_d2;
    search_k(0, q);
    for (int i = k_cnt; i < k; i++) {
      out_i[i] = -1;
      out_d2[i] = 3.0e38f;
    }
    return k_cnt;
  }

  // Up to k nearest neighbors within radius sqrt(r2), ascending; returns
  // the TOTAL number of in-radius neighbors (> k signals overflow — the
  // same contract as the TPU radius_search's capped lists + overflow
  // flag; reference radius search: core/kd_tree.hpp:236-273).
  int radius_knn(const float* q, float r2, int k, int self, int* out_i,
                 float* out_d2) const {
    k_cap = k;
    k_cnt = 0;
    k_self = self;
    k_i = out_i;
    k_d2 = out_d2;
    r_total = 0;
    r_bound = r2;
    search_r(0, q);
    for (int i = k_cnt; i < k; i++) {
      out_i[i] = -1;
      out_d2[i] = 3.0e38f;
    }
    return r_total;
  }

 private:
  mutable int best_i;
  mutable float best_d2;
  mutable int k_cap, k_cnt, k_self;
  mutable int* k_i;
  mutable float* k_d2;
  mutable int r_total;
  mutable float r_bound;

  void search_r(int node_id, const float* q) const {
    const KDNode& nd = nodes[node_id];
    if (nd.axis < 0) {
      for (int i = nd.left; i < nd.right; i++) {
        if (idx[i] == k_self) continue;
        const float* p = pts + 3 * idx[i];
        float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 <= r_bound) {
          r_total++;
          insert_k(idx[i], d2);
        }
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int near = diff <= 0 ? nd.left : nd.right;
    int far = diff <= 0 ? nd.right : nd.left;
    search_r(near, q);
    if (diff * diff <= r_bound) search_r(far, q);
  }

  void search(int node_id, const float* q) const {
    const KDNode& nd = nodes[node_id];
    if (nd.axis < 0) {
      for (int i = nd.left; i < nd.right; i++) {
        const float* p = pts + 3 * idx[i];
        float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best_d2) {
          best_d2 = d2;
          best_i = idx[i];
        }
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int near = diff <= 0 ? nd.left : nd.right;
    int far = diff <= 0 ? nd.right : nd.left;
    search(near, q);
    if (diff * diff < best_d2) search(far, q);
  }

  void insert_k(int id, float d2) const {
    // Insertion into the sorted k-best array (k is small: 10-ish).
    if (k_cnt == k_cap && d2 >= k_d2[k_cnt - 1]) return;
    int pos = k_cnt < k_cap ? k_cnt : k_cap - 1;
    while (pos > 0 && k_d2[pos - 1] > d2) {
      k_d2[pos] = k_d2[pos - 1];
      k_i[pos] = k_i[pos - 1];
      pos--;
    }
    k_d2[pos] = d2;
    k_i[pos] = id;
    if (k_cnt < k_cap) k_cnt++;
  }

  void search_k(int node_id, const float* q) const {
    const KDNode& nd = nodes[node_id];
    if (nd.axis < 0) {
      for (int i = nd.left; i < nd.right; i++) {
        if (idx[i] == k_self) continue;
        const float* p = pts + 3 * idx[i];
        float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
        insert_k(idx[i], dx * dx + dy * dy + dz * dz);
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int near = diff <= 0 ? nd.left : nd.right;
    int far = diff <= 0 ? nd.right : nd.left;
    search_k(near, q);
    float bound = k_cnt == k_cap ? k_d2[k_cap - 1] : 1e30f;
    if (diff * diff < bound) search_k(far, q);
  }
};

// Hand-rolled 6x6 Cholesky solve (A SPD).
inline bool chol_solve6(double a[6][6], const double b[6], double x[6]) {
  double l[6][6] = {};
  for (int i = 0; i < 6; i++) {
    double s = a[i][i];
    for (int k = 0; k < i; k++) s -= l[i][k] * l[i][k];
    if (s <= 0) return false;
    l[i][i] = std::sqrt(s);
    for (int j = i + 1; j < 6; j++) {
      double t = a[j][i];
      for (int k = 0; k < i; k++) t -= l[j][k] * l[i][k];
      l[j][i] = t / l[i][i];
    }
  }
  double y[6];
  for (int i = 0; i < 6; i++) {
    double s = b[i];
    for (int k = 0; k < i; k++) s -= l[i][k] * y[k];
    y[i] = s / l[i][i];
  }
  for (int i = 5; i >= 0; i--) {
    double s = y[i];
    for (int k = i + 1; k < 6; k++) s -= l[k][i] * x[k];
    x[i] = s / l[i][i];
  }
  return true;
}

inline void axis_angle_rot(const double w[3], double r[3][3]) {
  double th = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  if (th < 1e-12) {
    r[0][0] = 1; r[0][1] = -w[2]; r[0][2] = w[1];
    r[1][0] = w[2]; r[1][1] = 1; r[1][2] = -w[0];
    r[2][0] = -w[1]; r[2][1] = w[0]; r[2][2] = 1;
    return;
  }
  double kx = w[0] / th, ky = w[1] / th, kz = w[2] / th;
  double c = std::cos(th), s = std::sin(th), v = 1 - c;
  r[0][0] = c + kx * kx * v;      r[0][1] = kx * ky * v - kz * s; r[0][2] = kx * kz * v + ky * s;
  r[1][0] = ky * kx * v + kz * s; r[1][1] = c + ky * ky * v;      r[1][2] = ky * kz * v - kx * s;
  r[2][0] = kz * kx * v - ky * s; r[2][1] = kz * ky * v + kx * s; r[2][2] = c + kz * kz * v;
}

inline void mat_mul3(const double a[3][3], const double b[3][3], double out[3][3]) {
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double s = 0;
      for (int k = 0; k < 3; k++) s += a[i][k] * b[k][j];
      out[i][j] = s;
    }
}


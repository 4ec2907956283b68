// Single-core C++ baseline: sparse (embedded-deformation-graph) non-rigid
// ICP — the honest CPU denominator for the non-rigid bench row.
//
// Same algorithm class as the reference's sparse warp-field path
// (registration/warp_field_estimation.hpp:1387-1847 driven by
// examples/non_rigid_icp.cpp:41-84), written from scratch single-thread:
// voxel-grid control nodes, kd-tree anchor attachment (normalized RBF
// weights), node k-NN regularization arcs with sqrt-Huber IRLS, and a
// matrix-free Gauss-Newton step per outer iteration whose normal equations
// are solved by block-Jacobi-preconditioned conjugate gradient — mirroring
// the TPU solver's configuration (cilantro_tpu/registration/warp_field.py)
// so the comparison is one implementation strategy against another on the
// same math.
//
// ABI:
//   baseline_warp(src, dst, n, ctrl_res, k_anchors, k_arcs, max_outer,
//                 max_cg, point_weight, stiffness, huber_delta,
//                 max_corr_dist_sq, out_warped[3n], out_ms, out_nodes)
//     -> outer iterations performed (negative on error).
//   Timing (out_ms) covers EVERYTHING from node construction to the last
//   GN update — the full pipeline a user would run.

#include <chrono>
#include <cstdint>
#include <cstring>
#include <unordered_map>

#include "cpu_geom.hpp"

namespace {

struct Node6 {
  double r[3][3];
  double t[3];
};

inline void apply_node(const Node6& nd, const float* p, double out[3]) {
  for (int i = 0; i < 3; i++)
    out[i] = nd.r[i][0] * p[0] + nd.r[i][1] * p[1] + nd.r[i][2] * p[2] +
             nd.t[i];
}

inline void cross3(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

}  // namespace

extern "C" {

int baseline_warp(const float* src, const float* dst, int64_t n,
                  float ctrl_res, int k_anchors, int k_arcs, int max_outer,
                  int max_cg, float point_weight, float stiffness,
                  float huber_delta, float max_corr_dist_sq, float conv_tol,
                  float* out_warped, double* out_ms, int* out_nodes) {
  if (!src || !dst || n <= 0 || ctrl_res <= 0 || k_anchors <= 0 ||
      k_arcs <= 0)
    return -1;
  auto t0 = std::chrono::steady_clock::now();

  // ---- control nodes: voxel-grid bin means --------------------------------
  struct Acc {
    double s[3] = {0, 0, 0};
    int c = 0;
  };
  std::unordered_map<uint64_t, Acc> bins;
  bins.reserve(size_t(n) / 8);
  const double inv_res = 1.0 / ctrl_res;
  for (int64_t i = 0; i < n; i++) {
    const float* p = src + 3 * i;
    int64_t gx = int64_t(std::floor(p[0] * inv_res)) + (1 << 20);
    int64_t gy = int64_t(std::floor(p[1] * inv_res)) + (1 << 20);
    int64_t gz = int64_t(std::floor(p[2] * inv_res)) + (1 << 20);
    uint64_t key = (uint64_t(gx) << 42) | (uint64_t(gy) << 21) | uint64_t(gz);
    Acc& a = bins[key];
    a.s[0] += p[0];
    a.s[1] += p[1];
    a.s[2] += p[2];
    a.c++;
  }
  const int m = int(bins.size());
  if (out_nodes) *out_nodes = m;
  if (m < k_arcs + 1) return -2;
  std::vector<float> nodes(size_t(m) * 3);
  {
    int j = 0;
    for (auto& kv : bins) {
      nodes[3 * j + 0] = float(kv.second.s[0] / kv.second.c);
      nodes[3 * j + 1] = float(kv.second.s[1] / kv.second.c);
      nodes[3 * j + 2] = float(kv.second.s[2] / kv.second.c);
      j++;
    }
  }

  // ---- anchors: k nearest nodes per point, normalized RBF weights ---------
  KDTree node_tree;
  node_tree.build(nodes.data(), m);
  const int ka = k_anchors;
  std::vector<int> anc(size_t(n) * ka);
  std::vector<float> anc_w(size_t(n) * ka);
  {
    std::vector<int> ki(ka);
    std::vector<float> kd(ka);
    for (int64_t i = 0; i < n; i++) {
      int cnt = node_tree.knn(src + 3 * i, ka, -1, ki.data(), kd.data());
      float sig2 = 1e-12f;
      for (int a = 0; a < cnt; a++)
        if (kd[a] > sig2) sig2 = kd[a];
      float wsum = 0;
      for (int a = 0; a < ka; a++) {
        float w = a < cnt ? std::exp(-0.5f * kd[a] / sig2) : 0.0f;
        anc[i * ka + a] = a < cnt ? ki[a] : 0;
        anc_w[i * ka + a] = w;
        wsum += w;
      }
      if (wsum > 0)
        for (int a = 0; a < ka; a++) anc_w[i * ka + a] /= wsum;
    }
  }

  // ---- regularization arcs: node k-NN (excluding self) --------------------
  std::vector<int> arc_i, arc_j;
  arc_i.reserve(size_t(m) * k_arcs);
  arc_j.reserve(size_t(m) * k_arcs);
  {
    std::vector<int> ki(k_arcs);
    std::vector<float> kd(k_arcs);
    for (int j = 0; j < m; j++) {
      int cnt = node_tree.knn(nodes.data() + 3 * j, k_arcs, j, ki.data(),
                              kd.data());
      for (int a = 0; a < cnt; a++) {
        arc_i.push_back(j);
        arc_j.push_back(ki[a]);
      }
    }
  }
  const int na = int(arc_i.size());

  // ---- destination kd-tree (built once) -----------------------------------
  KDTree dst_tree;
  dst_tree.build(dst, int(n));

  // ---- state ---------------------------------------------------------------
  std::vector<Node6> T(m);
  for (int j = 0; j < m; j++) {
    std::memset(&T[j], 0, sizeof(Node6));
    T[j].r[0][0] = T[j].r[1][1] = T[j].r[2][2] = 1.0;
  }

  const double lev = 1e-6;
  std::vector<float> warped(size_t(n) * 3);
  std::vector<int> corr(n);
  // y_ik = T_{anc_ik}(p_i): anchor-transformed positions, the Jacobian
  // application points (matches the TPU solver's linearization).
  std::vector<double> y(size_t(n) * ka * 3);
  std::vector<double> yjl(size_t(na) * 3), yll(size_t(na) * 3);
  std::vector<double> arc_w(na), arc_r0(size_t(na) * 3);

  // CG work vectors over 6m unknowns.
  const int np = 6 * m;
  std::vector<double> rhs(np), xk(np), rk(np), zk(np), pk(np), ap(np);
  std::vector<double> prec(size_t(m) * 36);  // per-node 6x6 block inverses

  int outer = 0;
  for (; outer < max_outer; outer++) {
    // (a) warp points with the blended field + find gated correspondences.
    for (int64_t i = 0; i < n; i++) {
      double bl[3][3] = {}, bt[3] = {0, 0, 0};
      for (int a = 0; a < ka; a++) {
        const double w = anc_w[i * ka + a];
        const Node6& nd = T[anc[i * ka + a]];
        for (int r = 0; r < 3; r++) {
          bt[r] += w * nd.t[r];
          for (int c = 0; c < 3; c++) bl[r][c] += w * nd.r[r][c];
        }
      }
      const float* p = src + 3 * i;
      for (int r = 0; r < 3; r++)
        warped[3 * i + r] = float(bl[r][0] * p[0] + bl[r][1] * p[1] +
                                  bl[r][2] * p[2] + bt[r]);
      float d2;
      corr[i] = dst_tree.nn(warped.data() + 3 * i, max_corr_dist_sq, &d2);
    }

    // (b) linearization geometry.
    for (int64_t i = 0; i < n; i++)
      for (int a = 0; a < ka; a++)
        apply_node(T[anc[i * ka + a]], src + 3 * i, &y[(i * ka + a) * 3]);
    for (int e = 0; e < na; e++) {
      const float* cl = nodes.data() + 3 * arc_j[e];
      apply_node(T[arc_i[e]], cl, &yjl[3 * e]);
      apply_node(T[arc_j[e]], cl, &yll[3 * e]);
      double r0[3];
      for (int r = 0; r < 3; r++) r0[r] = yjl[3 * e + r] - yll[3 * e + r];
      std::memcpy(&arc_r0[3 * e], r0, sizeof(r0));
      double nrm = std::sqrt(r0[0] * r0[0] + r0[1] * r0[1] + r0[2] * r0[2]);
      double h = nrm <= huber_delta ? 1.0 : huber_delta / (nrm + 1e-30);
      arc_w[e] = double(stiffness) * h;
    }

    // (c) rhs = -J^T r and the exact per-node 6x6 diagonal blocks of J^T J
    // (block-Jacobi preconditioner, as the TPU CG path).
    std::fill(rhs.begin(), rhs.end(), 0.0);
    std::fill(prec.begin(), prec.end(), 0.0);
    auto add_block = [&](int node, const double g[3], const double pt[3],
                         double w, double* acc6 /*rhs*/) {
      // row block B = [-[pt]x | I]; contribution w * B^T g to acc6.
      double cr[3];
      double ptd[3] = {pt[0], pt[1], pt[2]};
      cross3(ptd, g, cr);  // (pt x g) = (B_rot)^T g with B_rot = -[pt]x
      for (int r = 0; r < 3; r++) {
        acc6[r] += w * cr[r];
        acc6[3 + r] += w * g[r];
      }
    };
    auto add_prec = [&](int node, const double pt[3], double w) {
      // w * B^T B with B = [-[pt]x | I] (3x6): accumulate into prec block.
      double* P = &prec[size_t(node) * 36];
      // B^T B = [ S^T S   S^T ] with S = -[pt]x  (S^T = [pt]x)
      //         [ S       I   ]
      double s[3][3] = {{0, -pt[2], pt[1]},
                        {pt[2], 0, -pt[0]},
                        {-pt[1], pt[0], 0}};  // [pt]x = S^T
      for (int r = 0; r < 3; r++)
        for (int c = 0; c < 3; c++) {
          double sts = 0;
          for (int k = 0; k < 3; k++) sts += s[r][k] * s[c][k];
          P[r * 6 + c] += w * sts;
          P[r * 6 + 3 + c] += w * s[r][c];
          P[(3 + r) * 6 + c] += w * s[c][r];
        }
      for (int r = 0; r < 3; r++) P[(3 + r) * 6 + 3 + r] += w;
    };

    for (int64_t i = 0; i < n; i++) {
      if (corr[i] < 0) continue;
      const float* d = dst + 3 * corr[i];
      double rres[3] = {warped[3 * i + 0] - d[0], warped[3 * i + 1] - d[1],
                        warped[3 * i + 2] - d[2]};
      for (int a = 0; a < ka; a++) {
        const double w = anc_w[i * ka + a] * point_weight;
        if (w == 0) continue;
        const int nd = anc[i * ka + a];
        double g[3] = {-w * rres[0], -w * rres[1], -w * rres[2]};
        add_block(nd, g, &y[(i * ka + a) * 3], 1.0, &rhs[6 * nd]);
        add_prec(nd, &y[(i * ka + a) * 3],
                 anc_w[i * ka + a] * anc_w[i * ka + a] * point_weight);
      }
    }
    for (int e = 0; e < na; e++) {
      const double w = arc_w[e];
      double g[3] = {-w * arc_r0[3 * e], -w * arc_r0[3 * e + 1],
                     -w * arc_r0[3 * e + 2]};
      add_block(arc_i[e], g, &yjl[3 * e], 1.0, &rhs[6 * arc_i[e]]);
      double gn[3] = {-g[0], -g[1], -g[2]};
      add_block(arc_j[e], gn, &yll[3 * e], 1.0, &rhs[6 * arc_j[e]]);
      add_prec(arc_i[e], &yjl[3 * e], w);
      add_prec(arc_j[e], &yll[3 * e], w);
    }
    // Invert preconditioner blocks (damped).
    for (int j = 0; j < m; j++) {
      double a6[6][6];
      for (int r = 0; r < 6; r++)
        for (int c = 0; c < 6; c++)
          a6[r][c] = prec[size_t(j) * 36 + r * 6 + c] +
                     ((r == c) ? lev + 1e-8 : 0.0);
      // Invert by solving 6 unit systems.
      double inv[6][6];
      bool ok = true;
      for (int c = 0; c < 6 && ok; c++) {
        double e[6] = {0, 0, 0, 0, 0, 0}, x6[6];
        e[c] = 1.0;
        double acopy[6][6];
        std::memcpy(acopy, a6, sizeof(a6));
        ok = chol_solve6(acopy, e, x6);
        for (int r = 0; r < 6; r++) inv[r][c] = x6[r];
      }
      if (!ok)
        for (int r = 0; r < 6; r++)
          for (int c = 0; c < 6; c++) inv[r][c] = (r == c) ? 1.0 : 0.0;
      std::memcpy(&prec[size_t(j) * 36], inv, sizeof(inv));
    }

    // (d) matrix-free normal matvec: ap = (J^T J + lev I) p.
    auto matvec = [&](const std::vector<double>& p, std::vector<double>& out) {
      std::fill(out.begin(), out.end(), 0.0);
      // data rows
      for (int64_t i = 0; i < n; i++) {
        if (corr[i] < 0) continue;
        double v[3] = {0, 0, 0};
        for (int a = 0; a < ka; a++) {
          const double w = anc_w[i * ka + a];
          const int nd = anc[i * ka + a];
          const double* dw = &p[6 * nd];
          double cr[3];
          cross3(dw, &y[(i * ka + a) * 3], cr);
          for (int r = 0; r < 3; r++) v[r] += w * (cr[r] + dw[3 + r]);
        }
        for (int a = 0; a < ka; a++) {
          const double w = anc_w[i * ka + a] * point_weight;
          if (w == 0) continue;
          const int nd = anc[i * ka + a];
          double g[3] = {w * v[0], w * v[1], w * v[2]};
          double cr[3];
          double pt[3] = {y[(i * ka + a) * 3], y[(i * ka + a) * 3 + 1],
                          y[(i * ka + a) * 3 + 2]};
          cross3(pt, g, cr);
          for (int r = 0; r < 3; r++) {
            out[6 * nd + r] += cr[r];
            out[6 * nd + 3 + r] += g[r];
          }
        }
      }
      // arc rows
      for (int e = 0; e < na; e++) {
        const double w = arc_w[e];
        const double* di = &p[6 * arc_i[e]];
        const double* dj = &p[6 * arc_j[e]];
        double ci[3], cj[3];
        cross3(di, &yjl[3 * e], ci);
        cross3(dj, &yll[3 * e], cj);
        double va[3];
        for (int r = 0; r < 3; r++)
          va[r] = ci[r] + di[3 + r] - cj[r] - dj[3 + r];
        double g[3] = {w * va[0], w * va[1], w * va[2]};
        double cri[3], crj[3];
        double pi[3] = {yjl[3 * e], yjl[3 * e + 1], yjl[3 * e + 2]};
        double pj[3] = {yll[3 * e], yll[3 * e + 1], yll[3 * e + 2]};
        cross3(pi, g, cri);
        cross3(pj, g, crj);
        for (int r = 0; r < 3; r++) {
          out[6 * arc_i[e] + r] += cri[r];
          out[6 * arc_i[e] + 3 + r] += g[r];
          out[6 * arc_j[e] + r] -= crj[r];
          out[6 * arc_j[e] + 3 + r] -= g[r];
        }
      }
      for (int q = 0; q < np; q++) out[q] += lev * p[q];
    };

    // (e) block-Jacobi preconditioned CG.
    auto apply_prec = [&](const std::vector<double>& r,
                          std::vector<double>& z) {
      for (int j = 0; j < m; j++) {
        const double* P = &prec[size_t(j) * 36];
        for (int rr = 0; rr < 6; rr++) {
          double s = 0;
          for (int c = 0; c < 6; c++) s += P[rr * 6 + c] * r[6 * j + c];
          z[6 * j + rr] = s;
        }
      }
    };
    double rhs_norm2 = 0;
    for (int q = 0; q < np; q++) rhs_norm2 += rhs[q] * rhs[q];
    std::fill(xk.begin(), xk.end(), 0.0);
    rk = rhs;
    apply_prec(rk, zk);
    pk = zk;
    double rz = 0;
    for (int q = 0; q < np; q++) rz += rk[q] * zk[q];
    const double cg_tol2 = 1e-5 * 1e-5 * rhs_norm2;
    for (int cg = 0; cg < max_cg; cg++) {
      double rk2 = 0;
      for (int q = 0; q < np; q++) rk2 += rk[q] * rk[q];
      if (rk2 <= cg_tol2) break;
      matvec(pk, ap);
      double pap = 1e-30;
      for (int q = 0; q < np; q++) pap += pk[q] * ap[q];
      double alpha = rz / pap;
      for (int q = 0; q < np; q++) {
        xk[q] += alpha * pk[q];
        rk[q] -= alpha * ap[q];
      }
      apply_prec(rk, zk);
      double rz1 = 0;
      for (int q = 0; q < np; q++) rz1 += rk[q] * zk[q];
      double beta = rz1 / (rz + 1e-30);
      rz = rz1;
      for (int q = 0; q < np; q++) pk[q] = zk[q] + beta * pk[q];
    }

    // (f) apply per-node increments: T <- (R(dw), dt) o T; converge on the
    // max per-node motion between outer iterations (the same norm the TPU
    // outer loop uses).
    double max_upd2 = 0.0;
    for (int j = 0; j < m; j++) {
      double rot[3][3];
      axis_angle_rot(&xk[6 * j], rot);
      double rn[3][3];
      mat_mul3(rot, T[j].r, rn);
      double tn[3];
      for (int r = 0; r < 3; r++)
        tn[r] = rot[r][0] * T[j].t[0] + rot[r][1] * T[j].t[1] +
                rot[r][2] * T[j].t[2] + xk[6 * j + 3 + r];
      double u2 = 0;
      for (int r = 0; r < 3; r++) {
        double dt_ = tn[r] - T[j].t[r];
        u2 += dt_ * dt_;
        for (int c = 0; c < 3; c++) {
          double dr = rn[r][c] - T[j].r[r][c];
          u2 += dr * dr;
        }
      }
      if (u2 > max_upd2) max_upd2 = u2;
      std::memcpy(T[j].r, rn, sizeof(rn));
      std::memcpy(T[j].t, tn, sizeof(tn));
    }
    if (max_upd2 < double(conv_tol) * double(conv_tol)) {
      outer++;
      break;
    }
  }

  // Final warp for the caller's accuracy check.
  for (int64_t i = 0; i < n; i++) {
    double bl[3][3] = {}, bt[3] = {0, 0, 0};
    for (int a = 0; a < ka; a++) {
      const double w = anc_w[i * ka + a];
      const Node6& nd = T[anc[i * ka + a]];
      for (int r = 0; r < 3; r++) {
        bt[r] += w * nd.t[r];
        for (int c = 0; c < 3; c++) bl[r][c] += w * nd.r[r][c];
      }
    }
    const float* p = src + 3 * i;
    for (int r = 0; r < 3; r++)
      out_warped[3 * i + r] = float(bl[r][0] * p[0] + bl[r][1] * p[1] +
                                    bl[r][2] * p[2] + bt[r]);
  }

  if (out_ms) {
    *out_ms = std::chrono::duration<double, std::milli>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
  }
  return outer;
}

}  // extern "C"

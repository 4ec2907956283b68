// Single-core C++ baseline: frame-to-model RGBD fusion.
//
// The compiled CPU reference for the headline fusion benchmark — the same
// pipeline the TPU path and bench_baseline.py's numpy implementation run
// (reference algorithm: examples/fusion.cpp:125-254): per frame a z-buffered
// projective index map, 6 iterations of projective point-to-plane ICP
// (hand-rolled 6x6 Cholesky, no Eigen on this image), then a
// fuse/augment/carve map update with confidence-weighted averaging.
// Written from scratch, compiled -O3 -march=native, strictly one thread.
//
// ABI:
//   baseline_fusion(depths, n_frames, h, w, fx, fy, cx, cy, icp_iters,
//                   fuse_depth, occl, out_poses, out_ms)
//     -> 0 on success (negative on error)
//   depths:    (n_frames, h, w) float32, row-major
//   out_poses: n_frames * 16 floats (row-major 4x4 camera-to-world)
//   out_ms:    total milliseconds spent fusing frames 1..n-1 (timed inside)

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float dot(const V3& a, const V3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline V3 sub(const V3& a, const V3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 add(const V3& a, const V3& b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 scale(const V3& a, float s) { return {a.x * s, a.y * s, a.z * s}; }

struct Mat3 {
  float m[9];  // row-major
  static Mat3 identity() { return {{1, 0, 0, 0, 1, 0, 0, 0, 1}}; }
  V3 apply(const V3& v) const {
    return {m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z};
  }
  // Rᵀ v
  V3 applyT(const V3& v) const {
    return {m[0] * v.x + m[3] * v.y + m[6] * v.z,
            m[1] * v.x + m[4] * v.y + m[7] * v.z,
            m[2] * v.x + m[5] * v.y + m[8] * v.z};
  }
  Mat3 mul(const Mat3& o) const {
    Mat3 r;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        r.m[3 * i + j] = 0;
        for (int k = 0; k < 3; k++) r.m[3 * i + j] += m[3 * i + k] * o.m[3 * k + j];
      }
    return r;
  }
};

// exp of axis-angle (Rodrigues).
Mat3 exp_so3(const V3& w) {
  float th = std::sqrt(dot(w, w));
  Mat3 r = Mat3::identity();
  if (th < 1e-12f) return r;
  V3 a = scale(w, 1.0f / th);
  float c = std::cos(th), s = std::sin(th), ic = 1.0f - c;
  r.m[0] = c + a.x * a.x * ic;
  r.m[1] = a.x * a.y * ic - a.z * s;
  r.m[2] = a.x * a.z * ic + a.y * s;
  r.m[3] = a.y * a.x * ic + a.z * s;
  r.m[4] = c + a.y * a.y * ic;
  r.m[5] = a.y * a.z * ic - a.x * s;
  r.m[6] = a.z * a.x * ic - a.y * s;
  r.m[7] = a.z * a.y * ic + a.x * s;
  r.m[8] = c + a.z * a.z * ic;
  return r;
}

// Solve (A + lambda I) x = b for symmetric positive definite 6x6 A
// (upper triangle given) via Cholesky. Returns false if not SPD.
bool solve6(const double A_in[36], const double b_in[6], double x[6]) {
  double a[36];
  std::memcpy(a, A_in, sizeof(a));
  double l[36] = {0};
  for (int i = 0; i < 6; i++) {
    for (int j = 0; j <= i; j++) {
      double s = a[6 * i + j];
      for (int k = 0; k < j; k++) s -= l[6 * i + k] * l[6 * j + k];
      if (i == j) {
        if (s <= 0) return false;
        l[6 * i + j] = std::sqrt(s);
      } else {
        l[6 * i + j] = s / l[6 * j + j];
      }
    }
  }
  double y[6];
  for (int i = 0; i < 6; i++) {
    double s = b_in[i];
    for (int k = 0; k < i; k++) s -= l[6 * i + k] * y[k];
    y[i] = s / l[6 * i + i];
  }
  for (int i = 5; i >= 0; i--) {
    double s = y[i];
    for (int k = i + 1; k < 6; k++) s -= l[6 * k + i] * x[k];
    x[i] = s / l[6 * i + i];
  }
  return true;
}

struct Frame {
  std::vector<V3> pts, nrm;
  std::vector<uint8_t> valid;
};

// Back-project a depth image and estimate normals from central differences
// of neighboring back-projections (same scheme as the numpy baseline and the
// TPU path's depth_to_points_normals).
void frame_from_depth(const float* depth, int h, int w, float fx, float fy,
                      float cx, float cy, Frame& f) {
  int n = h * w;
  f.pts.resize(n);
  f.nrm.resize(n);
  f.valid.resize(n);
  for (int v = 0; v < h; v++)
    for (int u = 0; u < w; u++) {
      int i = v * w + u;
      float z = depth[i];
      f.pts[i] = {(u - cx) * z / fx, (v - cy) * z / fy, z};
      f.valid[i] = z > 0;
    }
  for (int v = 0; v < h; v++)
    for (int u = 0; u < w; u++) {
      int i = v * w + u;
      int ul = v * w + (u - 1 + w) % w, ur = v * w + (u + 1) % w;
      int vu = ((v - 1 + h) % h) * w + u, vd = ((v + 1) % h) * w + u;
      V3 du = sub(f.pts[ur], f.pts[ul]);
      V3 dv = sub(f.pts[vd], f.pts[vu]);
      V3 nn = cross(dv, du);
      float l = std::sqrt(dot(nn, nn));
      nn = l > 1e-30f ? scale(nn, 1.0f / l) : V3{0, 0, 0};
      if (dot(nn, f.pts[i]) > 0) nn = scale(nn, -1.0f);
      f.nrm[i] = nn;
    }
}

}  // namespace

extern "C" int baseline_fusion(const float* depths, int n_frames, int h,
                               int w, float fx, float fy, float cx, float cy,
                               int icp_iters, float fuse_depth, float occl,
                               float* out_poses, double* out_ms) {
  if (n_frames < 1 || h < 2 || w < 2) return -1;
  int npix = h * w;

  // Model (world frame).
  std::vector<V3> m_pts, m_nrm;
  std::vector<float> m_conf;
  Frame f;
  frame_from_depth(depths, h, w, fx, fy, cx, cy, f);
  m_pts.reserve(2 * npix);
  for (int i = 0; i < npix; i++)
    if (f.valid[i]) {
      m_pts.push_back(f.pts[i]);
      m_nrm.push_back(f.nrm[i]);
      m_conf.push_back(1.0f);
    }

  Mat3 R = Mat3::identity();
  V3 T = {0, 0, 0};
  auto store_pose = [&](int fi) {
    float* p = out_poses + 16 * fi;
    for (int i = 0; i < 3; i++) {
      for (int j = 0; j < 3; j++) p[4 * i + j] = R.m[3 * i + j];
    }
    p[3] = T.x;
    p[7] = T.y;
    p[11] = T.z;
    p[12] = p[13] = p[14] = 0;
    p[15] = 1;
  };
  store_pose(0);

  std::vector<V3> model_cam, model_nrm_cam;
  std::vector<int> imap(npix);
  std::vector<float> mdepth(npix);

  auto zbuffer = [&]() {
    // Transform model into camera frame and elect per-pixel min-z winners.
    size_t mcount = m_pts.size();
    model_cam.resize(mcount);
    model_nrm_cam.resize(mcount);
    std::fill(imap.begin(), imap.end(), -1);
    std::fill(mdepth.begin(), mdepth.end(), 1e30f);
    for (size_t i = 0; i < mcount; i++) {
      V3 pc = R.applyT(sub(m_pts[i], T));  // cam = Rᵀ (world − t)
      model_cam[i] = pc;
      model_nrm_cam[i] = R.applyT(m_nrm[i]);
      if (pc.z <= 0) continue;
      // nearbyint under the default FE_TONEAREST mode = half-to-even,
      // matching the numpy pipeline's np.round so cross-check trajectories
      // cannot diverge on exact .5 pixel coordinates.
      int u = int(std::nearbyint(pc.x * fx / pc.z + cx));
      int v = int(std::nearbyint(pc.y * fy / pc.z + cy));
      if (u < 0 || u >= w || v < 0 || v >= h) continue;
      int pix = v * w + u;
      // <= so the LAST equal-depth point wins, matching the numpy
      // pipeline's last-write-wins tie-break on exact depth ties.
      if (pc.z <= mdepth[pix]) {
        mdepth[pix] = pc.z;
        imap[pix] = int(i);
      }
    }
  };

  auto t0 = std::chrono::steady_clock::now();
  for (int fi = 1; fi < n_frames; fi++) {
    frame_from_depth(depths + size_t(fi) * npix, h, w, fx, fy, cx, cy, f);
    zbuffer();

    // Projective point-to-plane ICP: delta (dR, dT) composed onto the pose.
    Mat3 dR = Mat3::identity();
    V3 dT = {0, 0, 0};
    for (int it = 0; it < icp_iters; it++) {
      double A[36] = {0}, b[6] = {0};
      for (int i = 0; i < npix; i++) {
        if (!f.valid[i]) continue;
        V3 s = add(dR.apply(f.pts[i]), dT);
        if (s.z <= 0) continue;
        int u = int(std::nearbyint(s.x * fx / s.z + cx));
        int v = int(std::nearbyint(s.y * fy / s.z + cy));
        if (u < 0 || u >= w || v < 0 || v >= h) continue;
        int hit = imap[v * w + u];
        if (hit < 0) continue;
        V3 d = model_cam[hit];
        V3 diff = sub(d, s);
        if (dot(diff, diff) > 0.01f) continue;
        V3 n = model_nrm_cam[hit];
        double r = dot(n, sub(s, d));
        double j[6] = {double(s.y) * n.z - double(s.z) * n.y,
                       double(s.z) * n.x - double(s.x) * n.z,
                       double(s.x) * n.y - double(s.y) * n.x,
                       n.x, n.y, n.z};
        for (int a = 0; a < 6; a++) {
          b[a] -= j[a] * r;
          for (int c = 0; c <= a; c++) A[6 * a + c] += j[a] * j[c];
        }
      }
      for (int a = 0; a < 6; a++)
        for (int c = a + 1; c < 6; c++) A[6 * a + c] = A[6 * c + a];
      for (int a = 0; a < 6; a++) A[6 * a + a] += 1e-9;
      double x[6];
      if (!solve6(A, b, x)) break;
      Mat3 rr = exp_so3({float(x[0]), float(x[1]), float(x[2])});
      dR = rr.mul(dR);
      dT = add(rr.apply(dT), {float(x[3]), float(x[4]), float(x[5])});
      double n2 = 0;
      for (int a = 0; a < 6; a++) n2 += x[a] * x[a];
      if (std::sqrt(n2) < 5e-4) break;
    }
    // pose = pose ∘ delta  (R ← R·dR, t ← R·dT + t)
    V3 newT = add(R.apply(dT), T);
    R = R.mul(dR);
    T = newT;
    store_pose(fi);

    // Map update at the refined pose.
    zbuffer();
    std::vector<uint8_t> keep(m_pts.size(), 1);
    size_t n_aug = 0;
    for (int i = 0; i < npix; i++) {
      if (!f.valid[i] || f.pts[i].z <= 0) continue;
      int hit = imap[i];
      V3 wp = add(R.apply(f.pts[i]), T);
      V3 wn = R.apply(f.nrm[i]);
      if (hit >= 0) {
        float dd = f.pts[i].z - mdepth[i];
        if (std::fabs(dd) <= fuse_depth) {
          float c = m_conf[hit];
          m_pts[hit] = scale(add(scale(m_pts[hit], c), wp), 1.0f / (c + 1));
          V3 nn = add(scale(m_nrm[hit], c), wn);
          float l = std::sqrt(dot(nn, nn));
          m_nrm[hit] = l > 1e-30f ? scale(nn, 1.0f / l) : m_nrm[hit];
          m_conf[hit] = c + 1;
        } else if (dd > occl) {
          keep[hit] = 0;  // carve
        } else if (dd < -occl) {
          m_pts.push_back(wp);  // augment in front
          m_nrm.push_back(wn);
          m_conf.push_back(1.0f);
          n_aug++;
        }
      } else {
        m_pts.push_back(wp);  // augment into empty space
        m_nrm.push_back(wn);
        m_conf.push_back(1.0f);
        n_aug++;
      }
    }
    // Compact carved rows (stable).
    size_t out = 0, n_old = keep.size();
    for (size_t i = 0; i < n_old; i++) {
      if (!keep[i]) continue;
      if (out != i) {
        m_pts[out] = m_pts[i];
        m_nrm[out] = m_nrm[i];
        m_conf[out] = m_conf[i];
      }
      out++;
    }
    // Move appended augments down next to the kept prefix.
    for (size_t i = 0; i < n_aug; i++) {
      m_pts[out + i] = m_pts[n_old + i];
      m_nrm[out + i] = m_nrm[n_old + i];
      m_conf[out + i] = m_conf[n_old + i];
    }
    m_pts.resize(out + n_aug);
    m_nrm.resize(out + n_aug);
    m_conf.resize(out + n_aug);
  }
  auto t1 = std::chrono::steady_clock::now();
  *out_ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
  return 0;
}

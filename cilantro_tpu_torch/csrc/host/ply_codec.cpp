// Fast PLY point-cloud codec (C++, ctypes ABI).
//
// Native replacement for the role tinyply plays in the reference
// (include/cilantro/utilities/ply_io.hpp wrapping 3rd_party/tinyply) —
// written from scratch against the PLY format spec: ASCII and
// binary_little_endian, vertex properties x/y/z [nx/ny/nz] [red/green/blue |
// r/g/b] in float/double/uchar, other elements (faces etc.) skipped.
//
// ABI (see native/__init__.py):
//   ply_read(path, &points, &normals, &colors, &n) -> 0 ok / negative error
//     points  : malloc'd float[3n] (always set on success)
//     normals : malloc'd float[3n] or nullptr
//     colors  : malloc'd float[3n] in [0,1] or nullptr
//   ply_write(path, points, normals, colors, n, binary) -> 0 ok
//   ply_free(ptr)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Property {
  std::string name;
  int size;        // bytes per scalar
  bool is_float;   // float/double vs integer
  bool is_signed;
};

int scalar_size(const std::string& t) {
  if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
  if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
  if (t == "int" || t == "uint" || t == "int32" || t == "uint32" ||
      t == "float" || t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return -1;
}

bool type_is_float(const std::string& t) {
  return t == "float" || t == "float32" || t == "double" || t == "float64";
}

double read_scalar(const uint8_t* p, const Property& prop,
                   bool swap = false) {
  uint8_t tmp[8];
  if (swap) {
    for (int i = 0; i < prop.size; i++) tmp[i] = p[prop.size - 1 - i];
    p = tmp;
  }
  if (prop.is_float) {
    if (prop.size == 4) {
      float v;
      std::memcpy(&v, p, 4);
      return v;
    }
    double v;
    std::memcpy(&v, p, 8);
    return v;
  }
  int64_t v = 0;
  if (prop.is_signed) {
    switch (prop.size) {
      case 1: v = *reinterpret_cast<const int8_t*>(p); break;
      case 2: { int16_t t; std::memcpy(&t, p, 2); v = t; break; }
      case 4: { int32_t t; std::memcpy(&t, p, 4); v = t; break; }
      default: { int64_t t; std::memcpy(&t, p, 8); v = t; break; }
    }
  } else {
    switch (prop.size) {
      case 1: v = *p; break;
      case 2: { uint16_t t; std::memcpy(&t, p, 2); v = t; break; }
      case 4: { uint32_t t; std::memcpy(&t, p, 4); v = t; break; }
      default: { uint64_t t; std::memcpy(&t, p, 8); v = int64_t(t); break; }
    }
  }
  return double(v);
}

}  // namespace

extern "C" {

void ply_free(void* p) { std::free(p); }

int ply_read(const char* path, float** out_points, float** out_normals,
             float** out_colors, int64_t* out_n) {
  *out_points = nullptr;
  *out_normals = nullptr;
  *out_colors = nullptr;
  *out_n = 0;

  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // Read entire file (fixture clouds are MBs; simplicity beats mmap here).
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 0) {
    std::fclose(f);
    return -2;
  }
  // +1 trailing NUL so the ASCII strtod path can never over-read a file
  // that ends mid-number; `dsize` is the real data size for all bounds.
  const size_t dsize = static_cast<size_t>(fsize);
  std::vector<uint8_t> buf(dsize + 1, 0);
  if (std::fread(buf.data(), 1, dsize, f) != dsize) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  // ---- header ----------------------------------------------------------
  size_t pos = 0;
  auto next_line = [&](std::string& line) -> bool {
    if (pos >= dsize) return false;
    size_t end = pos;
    while (end < dsize && buf[end] != '\n') end++;
    line.assign(reinterpret_cast<const char*>(buf.data() + pos), end - pos);
    if (!line.empty() && line.back() == '\r') line.pop_back();
    pos = end + 1;
    return true;
  };

  std::string line;
  if (!next_line(line) || line != "ply") return -3;
  bool binary = false, big_endian = false;
  int64_t vertex_count = -1;
  std::vector<Property> vprops;
  // (element_name, count, is_vertex); properties only tracked for vertex.
  struct Elem { std::string name; int64_t count; std::vector<Property> props; };
  std::vector<Elem> elems;

  while (next_line(line)) {
    if (line.rfind("comment", 0) == 0 || line.rfind("obj_info", 0) == 0)
      continue;
    if (line == "end_header") break;
    char a[64] = {0}, b[64] = {0}, c[64] = {0};
    if (line.rfind("format", 0) == 0) {
      std::sscanf(line.c_str(), "format %63s", a);
      binary = std::strncmp(a, "binary", 6) == 0;
      big_endian = std::strcmp(a, "binary_big_endian") == 0;
    } else if (line.rfind("element", 0) == 0) {
      long long cnt = 0;
      std::sscanf(line.c_str(), "element %63s %lld", a, &cnt);
      elems.push_back({a, cnt, {}});
      if (std::strcmp(a, "vertex") == 0) vertex_count = cnt;
    } else if (line.rfind("property", 0) == 0 && !elems.empty()) {
      if (line.rfind("property list", 0) == 0) {
        std::sscanf(line.c_str(), "property list %63s %63s %63s", a, b, c);
        Property p{c, -1, false, false};  // size -1 marks a list
        p.name = c;
        Property count_p{std::string("__count_") + c, scalar_size(a), false,
                         a[0] != 'u'};
        Property item_p{std::string("__item_") + c, scalar_size(b),
                        type_is_float(b), b[0] != 'u'};
        // Encode: store list as three pseudo-props.
        p.size = -1;
        elems.back().props.push_back(p);
        elems.back().props.push_back(count_p);
        elems.back().props.push_back(item_p);
      } else {
        std::sscanf(line.c_str(), "property %63s %63s", a, b);
        int sz = scalar_size(a);
        if (sz < 0) return -5;
        elems.back().props.push_back(
            {b, sz, type_is_float(a), a[0] != 'u'});
      }
    }
  }
  if (vertex_count < 0) return -6;

  // ---- locate channel columns in the vertex element --------------------
  const Elem* vx = nullptr;
  for (auto& e : elems)
    if (e.name == "vertex") vx = &e;
  if (!vx) return -6;
  for (auto& p : vx->props)
    if (p.size < 0) return -7;  // list property on vertex: unsupported

  int ix = -1, iy = -1, iz = -1, inx = -1, iny = -1, inz = -1, ir = -1,
      ig = -1, ib2 = -1;
  int stride = 0;
  std::vector<int> offsets(vx->props.size());
  for (size_t i = 0; i < vx->props.size(); i++) {
    offsets[i] = stride;
    stride += vx->props[i].size;
    const std::string& n = vx->props[i].name;
    if (n == "x") ix = int(i);
    else if (n == "y") iy = int(i);
    else if (n == "z") iz = int(i);
    else if (n == "nx") inx = int(i);
    else if (n == "ny") iny = int(i);
    else if (n == "nz") inz = int(i);
    else if (n == "red" || n == "r" || n == "diffuse_red") ir = int(i);
    else if (n == "green" || n == "g" || n == "diffuse_green") ig = int(i);
    else if (n == "blue" || n == "b" || n == "diffuse_blue") ib2 = int(i);
  }
  if (ix < 0 || iy < 0 || iz < 0) return -8;
  bool has_n = inx >= 0 && iny >= 0 && inz >= 0;
  bool has_c = ir >= 0 && ig >= 0 && ib2 >= 0;

  int64_t n = vertex_count;
  // Sanity-bound the claimed vertex count against the file size BEFORE
  // allocating (a hostile 'element vertex N' header must not drive malloc):
  // every vertex needs at least `stride` bytes (binary) / ~2 bytes per
  // property (ASCII).
  if (stride <= 0) return -7;
  int64_t min_bytes_per_vertex = binary ? stride : int64_t(vx->props.size());
  if (n < 0 || min_bytes_per_vertex <= 0 ||
      n > int64_t(dsize) / min_bytes_per_vertex + 1)
    return -10;

  float* pts = static_cast<float*>(std::malloc(sizeof(float) * 3 * n));
  float* nrm =
      has_n ? static_cast<float*>(std::malloc(sizeof(float) * 3 * n)) : nullptr;
  float* col =
      has_c ? static_cast<float*>(std::malloc(sizeof(float) * 3 * n)) : nullptr;

  auto fail = [&](int code) {
    std::free(pts);
    std::free(nrm);
    std::free(col);
    return code;
  };
  if (!pts || (has_n && !nrm) || (has_c && !col)) return fail(-12);

  if (binary) {
    // Vertex element must come first among binary elements we can index.
    // (True for every writer we care about; otherwise bail to error.)
    if (elems.empty() || elems.front().name != "vertex") return fail(-9);
    const uint8_t* base = buf.data() + pos;
    // n·stride can't wrap: n ≤ dsize/stride + 1 was enforced above.
    if (pos > dsize || size_t(stride) * size_t(n) > dsize - pos)
      return fail(-10);

    // Fast path: the ubiquitous all-float32 geometry (+uchar colors) layout
    // — tight strided copies, no per-scalar dispatch. Little-endian only;
    // big_endian rides the general byte-swapping path below.
    auto is_f4 = [&](int i) { return vx->props[i].is_float && vx->props[i].size == 4; };
    bool fast = !big_endian && is_f4(ix) && is_f4(iy) && is_f4(iz) &&
                (!has_n || (is_f4(inx) && is_f4(iny) && is_f4(inz))) &&
                (!has_c || ((vx->props[ir].size == 1 && !vx->props[ir].is_float &&
                             vx->props[ig].size == 1 && vx->props[ib2].size == 1)));
    if (fast) {
      const int ox = offsets[ix], oy = offsets[iy], oz = offsets[iz];
      for (int64_t i = 0; i < n; i++) {
        const uint8_t* row = base + size_t(i) * stride;
        std::memcpy(&pts[3 * i + 0], row + ox, 4);
        std::memcpy(&pts[3 * i + 1], row + oy, 4);
        std::memcpy(&pts[3 * i + 2], row + oz, 4);
      }
      if (has_n) {
        const int o0 = offsets[inx], o1 = offsets[iny], o2 = offsets[inz];
        for (int64_t i = 0; i < n; i++) {
          const uint8_t* row = base + size_t(i) * stride;
          std::memcpy(&nrm[3 * i + 0], row + o0, 4);
          std::memcpy(&nrm[3 * i + 1], row + o1, 4);
          std::memcpy(&nrm[3 * i + 2], row + o2, 4);
        }
      }
      if (has_c) {
        const int o0 = offsets[ir], o1 = offsets[ig], o2 = offsets[ib2];
        constexpr float kInv255 = 1.0f / 255.0f;
        for (int64_t i = 0; i < n; i++) {
          const uint8_t* row = base + size_t(i) * stride;
          col[3 * i + 0] = row[o0] * kInv255;
          col[3 * i + 1] = row[o1] * kInv255;
          col[3 * i + 2] = row[o2] * kInv255;
        }
      }
      *out_points = pts;
      *out_normals = nrm;
      *out_colors = col;
      *out_n = n;
      return 0;
    }

    for (int64_t i = 0; i < n; i++) {
      const uint8_t* row = base + size_t(i) * stride;
      pts[3 * i + 0] = float(read_scalar(row + offsets[ix], vx->props[ix], big_endian));
      pts[3 * i + 1] = float(read_scalar(row + offsets[iy], vx->props[iy], big_endian));
      pts[3 * i + 2] = float(read_scalar(row + offsets[iz], vx->props[iz], big_endian));
      if (has_n) {
        nrm[3 * i + 0] = float(read_scalar(row + offsets[inx], vx->props[inx], big_endian));
        nrm[3 * i + 1] = float(read_scalar(row + offsets[iny], vx->props[iny], big_endian));
        nrm[3 * i + 2] = float(read_scalar(row + offsets[inz], vx->props[inz], big_endian));
      }
      if (has_c) {
        float scale = vx->props[ir].is_float ? 1.0f : (1.0f / 255.0f);
        col[3 * i + 0] =
            float(read_scalar(row + offsets[ir], vx->props[ir], big_endian)) * scale;
        col[3 * i + 1] =
            float(read_scalar(row + offsets[ig], vx->props[ig], big_endian)) * scale;
        col[3 * i + 2] =
            float(read_scalar(row + offsets[ib2], vx->props[ib2], big_endian)) * scale;
      }
    }
  } else {
    // ASCII: stream doubles token by token (buffer is NUL-terminated at
    // dsize, so strtod stops at the end even mid-number).
    if (pos > dsize) return fail(-11);
    const char* s = reinterpret_cast<const char*>(buf.data() + pos);
    const char* end = reinterpret_cast<const char*>(buf.data() + dsize);
    size_t np = vx->props.size();
    std::vector<double> row(np);
    for (int64_t i = 0; i < n; i++) {
      for (size_t j = 0; j < np; j++) {
        char* nxt = nullptr;
        row[j] = std::strtod(s, &nxt);
        if (nxt == s) return fail(-11);
        s = nxt;
        if (s > end) return fail(-11);
      }
      pts[3 * i + 0] = float(row[ix]);
      pts[3 * i + 1] = float(row[iy]);
      pts[3 * i + 2] = float(row[iz]);
      if (has_n) {
        nrm[3 * i + 0] = float(row[inx]);
        nrm[3 * i + 1] = float(row[iny]);
        nrm[3 * i + 2] = float(row[inz]);
      }
      if (has_c) {
        float scale = vx->props[ir].is_float ? 1.0f : (1.0f / 255.0f);
        col[3 * i + 0] = float(row[ir]) * scale;
        col[3 * i + 1] = float(row[ig]) * scale;
        col[3 * i + 2] = float(row[ib2]) * scale;
      }
    }
  }

  *out_points = pts;
  *out_normals = nrm;
  *out_colors = col;
  *out_n = n;
  return 0;
}

int ply_write(const char* path, const float* points, const float* normals,
              const float* colors, int64_t n, int binary) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "ply\nformat %s 1.0\n",
               binary ? "binary_little_endian" : "ascii");
  std::fprintf(f, "element vertex %lld\n", static_cast<long long>(n));
  std::fprintf(f, "property float x\nproperty float y\nproperty float z\n");
  if (normals)
    std::fprintf(f,
                 "property float nx\nproperty float ny\nproperty float nz\n");
  if (colors)
    std::fprintf(
        f, "property uchar red\nproperty uchar green\nproperty uchar blue\n");
  std::fprintf(f, "end_header\n");

  for (int64_t i = 0; i < n; i++) {
    if (binary) {
      std::fwrite(points + 3 * i, sizeof(float), 3, f);
      if (normals) std::fwrite(normals + 3 * i, sizeof(float), 3, f);
      if (colors) {
        uint8_t c[3];
        for (int k = 0; k < 3; k++) {
          float v = colors[3 * i + k] * 255.0f + 0.5f;
          c[k] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
        std::fwrite(c, 1, 3, f);
      }
    } else {
      std::fprintf(f, "%g %g %g", points[3 * i], points[3 * i + 1],
                   points[3 * i + 2]);
      if (normals)
        std::fprintf(f, " %g %g %g", normals[3 * i], normals[3 * i + 1],
                     normals[3 * i + 2]);
      if (colors) {
        for (int k = 0; k < 3; k++) {
          float v = colors[3 * i + k] * 255.0f + 0.5f;
          int c = int(v < 0 ? 0 : (v > 255 ? 255 : v));
          std::fprintf(f, " %d", c);
        }
      }
      std::fprintf(f, "\n");
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"

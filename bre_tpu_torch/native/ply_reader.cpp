// Native PLY mesh reader — the runtime analog of the reference's vendored
// rply (pbrt's src/ext/rply.{h,c}) as used by the plymesh shape
// (pbrt's src/shapes/plymesh.cpp): reads vertex positions and
// triangulated faces from ascii / binary_little_endian / binary_big_endian
// PLY 1.0 files.  Independent implementation (not derived from rply): one
// whole-file read, a header scan into element/property descriptors, then a
// single forward pass that fans polygons into triangles.
//
// C ABI (ctypes from bre_tpu_torch/native/__init__.py):
//   void*  ply_load(path, &n_verts, &n_tris)   -> handle or NULL
//   void   ply_copy(handle, verts[3*nv] float32, tris[3*nt] int32)
//   void   ply_free(handle)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum PType { T_I8, T_U8, T_I16, T_U16, T_I32, T_U32, T_F32, T_F64, T_BAD };

int type_size(int t) {
  switch (t) {
    case T_I8: case T_U8: return 1;
    case T_I16: case T_U16: return 2;
    case T_I32: case T_U32: case T_F32: return 4;
    case T_F64: return 8;
  }
  return 0;
}

int parse_type(const std::string& s) {
  if (s == "char" || s == "int8") return T_I8;
  if (s == "uchar" || s == "uint8") return T_U8;
  if (s == "short" || s == "int16") return T_I16;
  if (s == "ushort" || s == "uint16") return T_U16;
  if (s == "int" || s == "int32") return T_I32;
  if (s == "uint" || s == "uint32") return T_U32;
  if (s == "float" || s == "float32") return T_F32;
  if (s == "double" || s == "float64") return T_F64;
  return T_BAD;
}

struct Prop {
  std::string name;
  int type = T_BAD;
  bool is_list = false;
  int count_type = T_BAD;
};

struct Element {
  std::string name;
  int64_t count = 0;
  std::vector<Prop> props;
};

struct Mesh {
  std::vector<float> verts;   // 3 * n_verts
  std::vector<int32_t> tris;  // 3 * n_tris
};

// ---- binary scalar decoding -------------------------------------------

uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

uint64_t load_be(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
  return v;
}

double decode_scalar(const uint8_t* p, int type, bool big_endian) {
  int n = type_size(type);
  uint64_t bits = big_endian ? load_be(p, n) : load_le(p, n);
  switch (type) {
    case T_I8:  return (double)(int8_t)bits;
    case T_U8:  return (double)(uint8_t)bits;
    case T_I16: return (double)(int16_t)bits;
    case T_U16: return (double)(uint16_t)bits;
    case T_I32: return (double)(int32_t)bits;
    case T_U32: return (double)(uint32_t)bits;
    case T_F32: { uint32_t b = (uint32_t)bits; float f; memcpy(&f, &b, 4); return f; }
    case T_F64: { uint64_t b = bits; double d; memcpy(&d, &b, 8); return d; }
  }
  return 0.0;
}

// ---- ascii cursor -------------------------------------------------------

struct AsciiCursor {
  const char* p;
  const char* end;
  bool ok = true;
  double next() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p >= end) { ok = false; return 0.0; }
    char* q = nullptr;
    double v = strtod(p, &q);
    if (q == p) { ok = false; return 0.0; }
    p = q;
    return v;
  }
};

bool is_index_name(const std::string& n) {
  return n == "vertex_indices" || n == "vertex_index";
}

void emit_fan(Mesh& m, const std::vector<int64_t>& poly, int64_t n_verts) {
  for (size_t k = 2; k < poly.size(); ++k) {
    int64_t a = poly[0], b = poly[k - 1], c = poly[k];
    if (a < 0 || b < 0 || c < 0 || a >= n_verts || b >= n_verts || c >= n_verts)
      continue;  // malformed face: drop, as rply-based loaders do
    m.tris.push_back((int32_t)a);
    m.tris.push_back((int32_t)b);
    m.tris.push_back((int32_t)c);
  }
}

Mesh* parse(const uint8_t* data, size_t size) {
  // --- header: text lines up to "end_header"
  const char* txt = (const char*)data;
  size_t pos = 0;
  auto getline = [&](std::string& out) -> bool {
    if (pos >= size) return false;
    size_t e = pos;
    while (e < size && txt[e] != '\n') ++e;
    out.assign(txt + pos, e - pos);
    if (!out.empty() && out.back() == '\r') out.pop_back();
    pos = (e < size) ? e + 1 : size;
    return true;
  };
  auto split = [](const std::string& line, std::vector<std::string>& w) {
    w.clear();
    size_t i = 0;
    while (i < line.size()) {
      while (i < line.size() && (line[i] == ' ' || line[i] == '\t')) ++i;
      size_t j = i;
      while (j < line.size() && line[j] != ' ' && line[j] != '\t') ++j;
      if (j > i) w.push_back(line.substr(i, j - i));
      i = j;
    }
  };

  std::string line;
  std::vector<std::string> w;
  if (!getline(line) || line != "ply") return nullptr;

  int fmt = -1;  // 0 ascii, 1 little, 2 big
  std::vector<Element> elems;
  while (getline(line)) {
    split(line, w);
    if (w.empty() || w[0] == "comment" || w[0] == "obj_info") continue;
    if (w[0] == "end_header") break;
    if (w[0] == "format" && w.size() >= 2) {
      if (w[1] == "ascii") fmt = 0;
      else if (w[1] == "binary_little_endian") fmt = 1;
      else if (w[1] == "binary_big_endian") fmt = 2;
      else return nullptr;
    } else if (w[0] == "element" && w.size() >= 3) {
      Element e;
      e.name = w[1];
      e.count = strtoll(w[2].c_str(), nullptr, 10);
      elems.push_back(e);
    } else if (w[0] == "property" && !elems.empty()) {
      Prop pr;
      if (w.size() >= 5 && w[1] == "list") {
        pr.is_list = true;
        pr.count_type = parse_type(w[2]);
        pr.type = parse_type(w[3]);
        pr.name = w[4];
      } else if (w.size() >= 3) {
        pr.type = parse_type(w[1]);
        pr.name = w[2];
      } else {
        return nullptr;
      }
      if (pr.type == T_BAD || (pr.is_list && pr.count_type == T_BAD))
        return nullptr;
      elems.back().props.push_back(pr);
    }
  }
  if (fmt < 0) return nullptr;

  Mesh* m = new Mesh();
  int64_t n_verts = 0;

  AsciiCursor ac{txt + pos, txt + size};
  const uint8_t* bp = data + pos;
  const uint8_t* bend = data + size;
  bool big = (fmt == 2);

  std::vector<int64_t> poly;
  for (const Element& e : elems) {
    bool is_vertex = (e.name == "vertex");
    bool is_face = (e.name == "face");
    int xi = -1, yi = -1, zi = -1, fi = -1;
    for (size_t i = 0; i < e.props.size(); ++i) {
      if (e.props[i].is_list) {
        if (is_face && is_index_name(e.props[i].name)) fi = (int)i;
        continue;
      }
      if (e.props[i].name == "x") xi = (int)i;
      else if (e.props[i].name == "y") yi = (int)i;
      else if (e.props[i].name == "z") zi = (int)i;
    }
    if (is_vertex) {
      if (xi < 0 || yi < 0 || zi < 0) { delete m; return nullptr; }
      n_verts = e.count;
      m->verts.reserve((size_t)(3 * e.count));
    }

    for (int64_t r = 0; r < e.count; ++r) {
      double x = 0, y = 0, z = 0;
      poly.clear();
      for (size_t i = 0; i < e.props.size(); ++i) {
        const Prop& pr = e.props[i];
        if (pr.is_list) {
          int64_t n;
          if (fmt == 0) {
            n = (int64_t)ac.next();
          } else {
            if (bp + type_size(pr.count_type) > bend) { delete m; return nullptr; }
            n = (int64_t)decode_scalar(bp, pr.count_type, big);
            bp += type_size(pr.count_type);
          }
          if (n < 0 || n > 1 << 20) { delete m; return nullptr; }
          bool want = ((int)i == fi);
          for (int64_t k = 0; k < n; ++k) {
            double v;
            if (fmt == 0) {
              v = ac.next();
            } else {
              if (bp + type_size(pr.type) > bend) { delete m; return nullptr; }
              v = decode_scalar(bp, pr.type, big);
              bp += type_size(pr.type);
            }
            if (want) poly.push_back((int64_t)v);
          }
        } else {
          double v;
          if (fmt == 0) {
            v = ac.next();
          } else {
            if (bp + type_size(pr.type) > bend) { delete m; return nullptr; }
            v = decode_scalar(bp, pr.type, big);
            bp += type_size(pr.type);
          }
          if ((int)i == xi) x = v;
          else if ((int)i == yi) y = v;
          else if ((int)i == zi) z = v;
        }
        if (fmt == 0 && !ac.ok) { delete m; return nullptr; }
      }
      if (is_vertex) {
        m->verts.push_back((float)x);
        m->verts.push_back((float)y);
        m->verts.push_back((float)z);
      } else if (is_face && !poly.empty()) {
        emit_fan(*m, poly, n_verts);
      }
    }
  }
  return m;
}

}  // namespace

extern "C" {

void* ply_load(const char* path, int64_t* n_verts, int64_t* n_tris) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) { fclose(f); return nullptr; }
  std::vector<uint8_t> buf((size_t)sz);
  size_t got = fread(buf.data(), 1, (size_t)sz, f);
  fclose(f);
  if (got != (size_t)sz) return nullptr;
  Mesh* m = parse(buf.data(), buf.size());
  if (!m) return nullptr;
  *n_verts = (int64_t)(m->verts.size() / 3);
  *n_tris = (int64_t)(m->tris.size() / 3);
  return m;
}

void ply_copy(void* handle, float* verts, int32_t* tris) {
  Mesh* m = (Mesh*)handle;
  if (!m) return;
  if (verts && !m->verts.empty())
    memcpy(verts, m->verts.data(), m->verts.size() * sizeof(float));
  if (tris && !m->tris.empty())
    memcpy(tris, m->tris.data(), m->tris.size() * sizeof(int32_t));
}

void ply_free(void* handle) { delete (Mesh*)handle; }

}  // extern "C"

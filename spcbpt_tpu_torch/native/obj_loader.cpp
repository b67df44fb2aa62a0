// Fast OBJ parser (native runtime piece): replaces vendored tiny_obj_loader
// (reference: src/OptiXPathTracer/tiny_obj_loader.h) for the subset the
// scenes use (v/vn/vt, polygonal f with v, v/vt, v//vn, v/vt/vn, negative
// indices). Output contract matches scene/obj.py::load_obj (the oracle):
// de-indexed per-triangle positions/normals/uvs.
//
// Two-pass ctypes API:
//   obj_count(path, &n_tris)           -> 0 ok
//   obj_load(path, pos, nrm, uv)       -> n_tris (arrays sized (T,3,3)/(T,3,2))

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> v, vn, vt;
  // per corner: vertex/uv/normal indices (resolved, -1 = absent)
  std::vector<int64_t> fv, ft, fn;
};

bool parse(const char *path, ObjData &o) {
  FILE *f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(sz, 0);
  if (fread(buf.data(), 1, sz, f) != (size_t)sz) { fclose(f); return false; }
  fclose(f);

  const char *p = buf.data();
  const char *end = p + sz;
  std::vector<int64_t> poly_v, poly_t, poly_n;
  while (p < end) {
    // line start
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p >= end) break;
    if (p[0] == 'v' && p + 1 < end && p[1] == ' ') {
      p += 2;
      for (int k = 0; k < 3; ++k) o.v.push_back(strtof(p, (char **)&p));
    } else if (p[0] == 'v' && p + 1 < end && p[1] == 'n') {
      p += 3;
      for (int k = 0; k < 3; ++k) o.vn.push_back(strtof(p, (char **)&p));
    } else if (p[0] == 'v' && p + 1 < end && p[1] == 't') {
      p += 3;
      for (int k = 0; k < 2; ++k) o.vt.push_back(strtof(p, (char **)&p));
    } else if (p[0] == 'f' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      poly_v.clear(); poly_t.clear(); poly_n.clear();
      int64_t nv = (int64_t)o.v.size() / 3;
      int64_t nt = (int64_t)o.vt.size() / 2;
      int64_t nn = (int64_t)o.vn.size() / 3;
      while (p < end && *p != '\n' && *p != '\r' && *p != '#') {
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        if (p >= end || *p == '\n' || *p == '\r' || *p == '#') break;
        long vi = strtol(p, (char **)&p, 10);
        long ti = 0, ni = 0;
        if (p < end && *p == '/') {
          ++p;
          if (p < end && *p != '/') ti = strtol(p, (char **)&p, 10);
          if (p < end && *p == '/') { ++p; ni = strtol(p, (char **)&p, 10); }
        }
        poly_v.push_back(vi > 0 ? vi - 1 : nv + vi);
        poly_t.push_back(ti > 0 ? ti - 1 : (ti < 0 ? nt + ti : -1));
        poly_n.push_back(ni > 0 ? ni - 1 : (ni < 0 ? nn + ni : -1));
      }
      for (size_t k = 1; k + 1 < poly_v.size(); ++k) {
        o.fv.push_back(poly_v[0]); o.fv.push_back(poly_v[k]); o.fv.push_back(poly_v[k + 1]);
        o.ft.push_back(poly_t[0]); o.ft.push_back(poly_t[k]); o.ft.push_back(poly_t[k + 1]);
        o.fn.push_back(poly_n[0]); o.fn.push_back(poly_n[k]); o.fn.push_back(poly_n[k + 1]);
      }
    }
    while (p < end && *p != '\n') ++p;
    ++p;
  }
  return true;
}

}  // namespace

extern "C" int64_t obj_count(const char *path) {
  ObjData o;
  if (!parse(path, o)) return -1;
  return (int64_t)(o.fv.size() / 3);
}

extern "C" int64_t obj_load(const char *path, float *pos, float *nrm, float *uv) {
  ObjData o;
  if (!parse(path, o)) return -1;
  int64_t t = (int64_t)(o.fv.size() / 3);
  int64_t nvert = (int64_t)o.v.size() / 3;
  int64_t nnorm = (int64_t)o.vn.size() / 3;
  int64_t nuv = (int64_t)o.vt.size() / 2;
  for (int64_t i = 0; i < t; ++i) {
    float px[3][3];
    for (int c = 0; c < 3; ++c) {
      int64_t vi = o.fv[3 * i + c];
      if (vi < 0 || vi >= nvert) vi = 0;
      for (int k = 0; k < 3; ++k) px[c][k] = o.v[3 * vi + k];
    }
    // geometric normal fallback
    float e1[3], e2[3], gn[3];
    for (int k = 0; k < 3; ++k) { e1[k] = px[1][k] - px[0][k]; e2[k] = px[2][k] - px[0][k]; }
    gn[0] = e1[1] * e2[2] - e1[2] * e2[1];
    gn[1] = e1[2] * e2[0] - e1[0] * e2[2];
    gn[2] = e1[0] * e2[1] - e1[1] * e2[0];
    float gl = std::sqrt(gn[0] * gn[0] + gn[1] * gn[1] + gn[2] * gn[2]);
    if (gl < 1e-30f) gl = 1e-30f;
    for (int k = 0; k < 3; ++k) gn[k] /= gl;

    for (int c = 0; c < 3; ++c) {
      for (int k = 0; k < 3; ++k) pos[9 * i + 3 * c + k] = px[c][k];
      int64_t ni = o.fn[3 * i + c];
      if (ni >= 0 && ni < nnorm) {
        for (int k = 0; k < 3; ++k) nrm[9 * i + 3 * c + k] = o.vn[3 * ni + k];
      } else {
        for (int k = 0; k < 3; ++k) nrm[9 * i + 3 * c + k] = gn[k];
      }
      int64_t ti = o.ft[3 * i + c];
      if (ti >= 0 && ti < nuv) {
        uv[6 * i + 2 * c] = o.vt[2 * ti];
        uv[6 * i + 2 * c + 1] = o.vt[2 * ti + 1];
      } else {
        uv[6 * i + 2 * c] = 0.f;
        uv[6 * i + 2 * c + 1] = 0.f;
      }
    }
  }
  return t;
}

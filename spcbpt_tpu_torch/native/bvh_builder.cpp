// Binned-SAH BVH builder with skip-link flattening (native runtime piece).
//
// Host-side replacement for the reference's OptiX GAS/IAS accel builds
// (reference: sutil/Scene.cpp buildMeshAccels:943) serving the TPU traversal
// kernels; same output contract as ops/bvh.py::build_bvh_numpy (that numpy
// implementation is the correctness oracle for this one).
//
// Exposed via ctypes (see loader.py): int bvh_build(...) returns node count.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
  V3 min(const V3 &o) const { return {std::min(x, o.x), std::min(y, o.y), std::min(z, o.z)}; }
  V3 max(const V3 &o) const { return {std::max(x, o.x), std::max(y, o.y), std::max(z, o.z)}; }
};

struct Node {
  V3 lo, hi;
  int32_t right = -1;      // right-child node index (-1 for leaf)
  int32_t leaf_start = -1; // first triangle slot in `order`
  int32_t leaf_count = 0;
  int32_t depth = 0;
};

constexpr int kBins = 16;

struct Builder {
  const float *p0, *e1, *e2;
  int leaf_size;
  std::vector<V3> bmin, bmax, cent;
  std::vector<Node> nodes;
  std::vector<int64_t> order;
  int max_depth = 0;

  static float area(const V3 &lo, const V3 &hi) {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }

  int build(std::vector<int64_t> &idx, int lo_i, int hi_i, int depth) {
    max_depth = std::max(max_depth, depth);
    int my = (int)nodes.size();
    nodes.emplace_back();
    V3 lo{FLT_MAX, FLT_MAX, FLT_MAX}, hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = lo_i; i < hi_i; ++i) {
      lo = lo.min(bmin[idx[i]]);
      hi = hi.max(bmax[idx[i]]);
    }
    nodes[my].lo = lo;
    nodes[my].hi = hi;
    nodes[my].depth = depth;
    int n = hi_i - lo_i;
    if (n <= leaf_size || depth > 60) {
      nodes[my].leaf_start = (int32_t)order.size();
      nodes[my].leaf_count = n;
      for (int i = lo_i; i < hi_i; ++i) order.push_back(idx[i]);
      return my;
    }

    // centroid bounds + split axis
    V3 clo{FLT_MAX, FLT_MAX, FLT_MAX}, chi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = lo_i; i < hi_i; ++i) {
      clo = clo.min(cent[idx[i]]);
      chi = chi.max(cent[idx[i]]);
    }
    float ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] < 1e-12f) {
      mid = lo_i + n / 2;
    } else {
      float origin = axis == 0 ? clo.x : (axis == 1 ? clo.y : clo.z);
      float inv = kBins / ext[axis];
      auto bin_of = [&](int64_t t) {
        float c = axis == 0 ? cent[t].x : (axis == 1 ? cent[t].y : cent[t].z);
        int b = (int)((c - origin) * inv);
        return std::min(std::max(b, 0), kBins - 1);
      };
      int counts[kBins] = {0};
      V3 blo[kBins], bhi[kBins];
      for (int b = 0; b < kBins; ++b) {
        blo[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        bhi[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      for (int i = lo_i; i < hi_i; ++i) {
        int b = bin_of(idx[i]);
        counts[b]++;
        blo[b] = blo[b].min(bmin[idx[i]]);
        bhi[b] = bhi[b].max(bmax[idx[i]]);
      }
      // sweep
      V3 pre_lo[kBins], pre_hi[kBins];
      int pre_n[kBins];
      V3 acc_lo{FLT_MAX, FLT_MAX, FLT_MAX}, acc_hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int acc_n = 0;
      for (int b = 0; b < kBins; ++b) {
        acc_lo = acc_lo.min(blo[b]);
        acc_hi = acc_hi.max(bhi[b]);
        acc_n += counts[b];
        pre_lo[b] = acc_lo; pre_hi[b] = acc_hi; pre_n[b] = acc_n;
      }
      V3 suf_lo[kBins], suf_hi[kBins];
      acc_lo = {FLT_MAX, FLT_MAX, FLT_MAX};
      acc_hi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      for (int b = kBins - 1; b >= 0; --b) {
        acc_lo = acc_lo.min(blo[b]);
        acc_hi = acc_hi.max(bhi[b]);
        suf_lo[b] = acc_lo; suf_hi[b] = acc_hi;
      }
      float best_cost = FLT_MAX;
      int best_b = -1;
      for (int b = 0; b < kBins - 1; ++b) {
        int nl = pre_n[b], nr = n - nl;
        if (nl == 0 || nr == 0) continue;
        float cost = nl * area(pre_lo[b], pre_hi[b]) + nr * area(suf_lo[b + 1], suf_hi[b + 1]);
        if (cost < best_cost) { best_cost = cost; best_b = b; }
      }
      if (best_b < 0) {
        std::nth_element(idx.begin() + lo_i, idx.begin() + lo_i + n / 2,
                         idx.begin() + hi_i, [&](int64_t a, int64_t b2) {
          float ca = axis == 0 ? cent[a].x : (axis == 1 ? cent[a].y : cent[a].z);
          float cb = axis == 0 ? cent[b2].x : (axis == 1 ? cent[b2].y : cent[b2].z);
          return ca < cb;
        });
        mid = lo_i + n / 2;
      } else {
        auto it = std::partition(idx.begin() + lo_i, idx.begin() + hi_i,
                                 [&](int64_t t) { return bin_of(t) <= best_b; });
        mid = (int)(it - idx.begin());
        if (mid == lo_i || mid == hi_i) mid = lo_i + n / 2;
      }
    }
    build(idx, lo_i, mid, depth + 1);
    int right = build(idx, mid, hi_i, depth + 1);
    nodes[my].right = right;
    return my;
  }
};

}  // namespace

extern "C" int32_t bvh_build(const float *p0, const float *e1, const float *e2,
                             int32_t n_tris, int32_t leaf_size,
                             float *out_min, float *out_max, int32_t *out_skip,
                             int32_t *out_leaf_start, int32_t *out_leaf_count,
                             int64_t *out_order, int32_t *out_depth) {
  if (n_tris <= 0) return -1;
  Builder b;
  b.p0 = p0; b.e1 = e1; b.e2 = e2;
  b.leaf_size = leaf_size;
  b.bmin.resize(n_tris);
  b.bmax.resize(n_tris);
  b.cent.resize(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    V3 a{p0[3 * i], p0[3 * i + 1], p0[3 * i + 2]};
    V3 v1{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
    V3 v2{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
    b.bmin[i] = a.min(v1).min(v2);
    b.bmax[i] = a.max(v1).max(v2);
    b.cent[i] = {(b.bmin[i].x + b.bmax[i].x) * .5f,
                 (b.bmin[i].y + b.bmax[i].y) * .5f,
                 (b.bmin[i].z + b.bmax[i].z) * .5f};
  }
  std::vector<int64_t> idx(n_tris);
  for (int i = 0; i < n_tris; ++i) idx[i] = i;
  b.nodes.reserve(2 * n_tris);
  b.order.reserve(n_tris);
  b.build(idx, 0, n_tris, 0);

  int n_nodes = (int)b.nodes.size();
  // skip link = subtree end in DFS order (right-to-left pass)
  std::vector<int32_t> subtree_end(n_nodes);
  for (int i = n_nodes - 1; i >= 0; --i) {
    if (b.nodes[i].right < 0)
      subtree_end[i] = i + 1;
    else
      subtree_end[i] = subtree_end[b.nodes[i].right];
  }
  for (int i = 0; i < n_nodes; ++i) {
    const Node &nd = b.nodes[i];
    out_min[3 * i] = nd.lo.x; out_min[3 * i + 1] = nd.lo.y; out_min[3 * i + 2] = nd.lo.z;
    out_max[3 * i] = nd.hi.x; out_max[3 * i + 1] = nd.hi.y; out_max[3 * i + 2] = nd.hi.z;
    out_skip[i] = subtree_end[i];
    out_leaf_start[i] = nd.leaf_start;
    out_leaf_count[i] = nd.leaf_count;
  }
  std::memcpy(out_order, b.order.data(), sizeof(int64_t) * n_tris);
  *out_depth = b.max_depth;
  return n_nodes;
}

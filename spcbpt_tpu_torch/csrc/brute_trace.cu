// Brute-force ray traversal for Hopper (sm_90a): closest hit and any hit
// against every triangle of a small scene.
//
// Replaces the two Pallas TPU kernels of spcbpt_tpu/ops/pallas_trace.py:
//   brute_closest  <- _closest_kernel (pallas_trace.py:28, via pallas_closest)
//   brute_any      <- _any_kernel     (pallas_trace.py:108, via pallas_any)
// and computes what they compute: for each ray, the smallest t in
// (tmin, tmax) over all T triangles with the smallest triangle id on ties
// (closest), or whether any triangle is hit in (tmin, tmax) (any). The
// Pallas kernels stream 512-ray blocks against the resident triangle set in
// chunks of up to 2048 triangles; that chunking is a VMEM tiling choice and
// is not carried over.
//
// Miss convention: t = 1e30, tri = -1, u = v = 0, as the port's trace API
// and intersect.brute_force_closest return it (the Pallas kernel leaves
// t = min(tmax, 1e30) and maps padded ids to -1 in its wrapper).
//
// What bounds it on the card. It serves the `brute` traversal mode, at most
// 512 triangles (the Cornell box has 32). Each (ray, triangle) pair costs
// about 45 f32 operations of Moller-Trumbore; each ray reads 32 bytes
// (origin, direction, tmin, tmax) and writes 16. At 32 triangles a 2^17-ray
// wavefront is ~190 MFLOP against ~6 MB of ray traffic, microseconds of
// either on an H100, so the kernel is bound by its launch and by the ray
// I/O, not by arithmetic. At 512 triangles arithmetic dominates.
//
// What the design does about it. One thread per ray, 128 threads per block.
// The block first copies all T <= 512 triangles (36 bytes each, at most
// 18 KB) from device memory into shared memory as [p0, e1, e2] rows; every
// thread of a warp then reads the same triangle at the same time, a
// broadcast with no bank conflict. Ray loads are coalesced per warp. A ray
// walks the ids in ascending order and takes a hit only on a strictly
// smaller t, which yields the smallest id among equal t, as the Pallas
// kernel's min-then-smallest-id pick and strict < across chunks do. The
// any-hit kernel stops at its first hit. A lane whose tmax is not above its
// tmin (a dead lane) skips the loop. The arithmetic follows the component
// order of the plain torch version (ops/intersect.tri_test over
// utils/vec.dot and vec.cross) and is built with --fmad=false and IEEE
// division, so t/u/v/tri equal the plain version's bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr int kBlock = 128;      // threads per block, one ray each
constexpr int kMaxTris = 512;    // the brute mode's limit on the card
constexpr int kTriFloats = 9;    // p0 | e1 | e2

// Copy the (T, 3) p0/e1/e2 tables into one (T, 9) shared table.
__device__ __forceinline__ void load_tris(float* s, const float* __restrict__ p0,
                                          const float* __restrict__ e1,
                                          const float* __restrict__ e2,
                                          int t_total) {
  for (int k = threadIdx.x; k < 3 * t_total; k += kBlock) {
    const int j = k / 3;
    const int c = k - 3 * j;
    s[kTriFloats * j + c] = __ldg(p0 + k);
    s[kTriFloats * j + 3 + c] = __ldg(e1 + k);
    s[kTriFloats * j + 6 + c] = __ldg(e2 + k);
  }
  __syncthreads();
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray r;
  r.ox = __ldg(o + 3 * i);
  r.oy = __ldg(o + 3 * i + 1);
  r.oz = __ldg(o + 3 * i + 2);
  r.dx = __ldg(d + 3 * i);
  r.dy = __ldg(d + 3 * i + 1);
  r.dz = __ldg(d + 3 * i + 2);
  return r;
}

// Moller-Trumbore in the operation order of intersect.tri_test:
// pvec = cross(d, e2), det = dot(e1, pvec), tvec = o - p0,
// u = dot(tvec, pvec) * inv, qvec = cross(tvec, e1),
// v = dot(d, qvec) * inv, t = dot(e2, qvec) * inv.
__device__ __forceinline__ bool mt_hit(const Ray& r, const float* s, bool cull,
                                       float tmn, float tmx, float& t,
                                       float& u, float& v) {
  const float p0x = s[0], p0y = s[1], p0z = s[2];
  const float e1x = s[3], e1y = s[4], e1z = s[5];
  const float e2x = s[6], e2y = s[7], e2z = s[8];
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = cull ? det > kEpsDet : fabsf(det) > kEpsDet;
  if (!det_ok) return false;
  const float inv = 1.0f / det;
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > tmn) & (t < tmx);
}

__global__ void __launch_bounds__(kBlock)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               const float* __restrict__ p0, const float* __restrict__ e1,
               const float* __restrict__ e2, int n, int t_total, int cull,
               float* __restrict__ out_t, int* __restrict__ out_tri,
               float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ float tris[kMaxTris * kTriFloats];
  load_tris(tris, p0, e1, e2, t_total);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (tmx > tmn) {
    const Ray r = load_ray(o, d, i);
    for (int j = 0; j < t_total; ++j) {
      float t, u, v;
      if (mt_hit(r, tris + kTriFloats * j, cull != 0, tmn, tmx, t, u, v) &&
          t < best_t) {
        best_t = t;
        best_id = j;
        best_u = u;
        best_v = v;
      }
    }
  }
  out_t[i] = best_t;
  out_tri[i] = best_id;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

__global__ void __launch_bounds__(kBlock)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tmin, const float* __restrict__ tmax,
           const float* __restrict__ p0, const float* __restrict__ e1,
           const float* __restrict__ e2, int n, int t_total,
           int* __restrict__ out_occ) {
  __shared__ float tris[kMaxTris * kTriFloats];
  load_tris(tris, p0, e1, e2, t_total);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  int occ = 0;
  if (tmx > tmn) {
    const Ray r = load_ray(o, d, i);
    for (int j = 0; j < t_total; ++j) {
      float t, u, v;
      if (mt_hit(r, tris + kTriFloats * j, false, tmn, tmx, t, u, v)) {
        occ = 1;
        break;
      }
    }
  }
  out_occ[i] = occ;
}

}  // namespace

// Plain C interface, loaded with ctypes. All pointers are device pointers:
// o/d (n, 3), tmin/tmax (n,), p0/e1/e2 (t_total, 3), all float32 and
// contiguous; 0 < t_total <= 512. The launch goes on `stream`. Returns the
// cudaGetLastError() after the launch (0 on success).
extern "C" int brute_closest(const float* o, const float* d, const float* tmin,
                             const float* tmax, const float* p0,
                             const float* e1, const float* e2, int n,
                             int t_total, int cull, float* out_t, int* out_tri,
                             float* out_u, float* out_v, void* stream) {
  closest_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, p0, e1, e2, n, t_total, cull, out_t, out_tri, out_u,
      out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brute_any(const float* o, const float* d, const float* tmin,
                         const float* tmax, const float* p0, const float* e1,
                         const float* e2, int n, int t_total, int* out_occ,
                         void* stream) {
  any_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(o, d, tmin, tmax, p0, e1,
                                                    e2, n, t_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}

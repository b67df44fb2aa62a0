// Row-walk ray traversal for Hopper (sm_90a): closest hit and any hit.
//
// Replaces the two Pallas TPU kernels of spcbpt_tpu/ops/ray_walk.py:
//   ray_walk_closest  <- _closest_kernel (ray_walk.py:144, via walk_closest)
//   ray_walk_any      <- _any_kernel     (ray_walk.py:197, via walk_any)
// and computes what they compute, lane for lane: the same cluster visit
// order, the same termination rule, the same Moller-Trumbore arithmetic
// (built with --fmad=false so t/u/v round like the plain torch version) and
// the same tie-breaks.
//
// What it computes. Rays come in rows of 8 consecutive lanes. row_e (R, C)
// holds, per row, the smallest exact slab entry of its 8 rays into each of
// the C cluster AABBs (1e30 where no ray of the row overlaps the cluster).
// A row repeatedly takes the (entry, id)-lexicographic next cluster after the
// last one it visited and tests its lanes against the cluster's 128 triangle
// slots. Closest hit keeps a hit only on a strictly smaller t, which gives
// the smallest slot within a cluster and the earlier-visited cluster across
// clusters, as the Pallas kernel's min-by-t with smallest-slot pick does. A
// row stops once its next entry exceeds the largest min(best_t, tmax) of its
// lanes (closest) or the largest tmax of its unoccluded lanes (any).
//
// What bounds it on the card. Each visited (ray, slot) pair costs about 45
// f32 operations of Moller-Trumbore and reads 48 bytes of the triangle table
// (three 16-byte loads). The table of the 32,576-triangle interior is
// 368 clusters x 128 slots x 48 B = 2.3 MB, resident in the 50 MB L2, so the
// kernel is bound by issue rate and by the lanes that idle in a warp while
// other rows still walk, not by device memory.
//
// What the design does about it. One thread per ray, 128 threads (16 rows)
// per block. Each warp runs its 4 rows in lock step, as a Pallas program ran
// its 16 rows: a per-row run flag, warp-wide __any_sync for the loop, and
// width-8 __shfl_xor_sync reductions for the next cluster and the row bound,
// so no shuffle ever runs under a divergent mask. The 8 lanes of a row read
// the same slot at the same time (one broadcast load), and the table is
// packed slot-major as [p0, 0, e1, 0, e2, 0] so a slot is three float4
// loads. A lane whose tmax is below its tmin (dead lane), or that is already
// occluded, skips the slot loop. The row_e table stays a separate pass in
// torch (fusing it into this kernel is the first speed item).
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr int kRow = 8;        // lanes per row
constexpr int kBlock = 128;    // threads per block = 16 rows
constexpr int kSlots = 128;    // triangle slots per cluster
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Lexicographic (entry, id) successor of (last_e, last_c) over the row's C
// entries: each lane scans a strided eighth, then the 8 lanes reduce.
__device__ __forceinline__ void next_cluster(const float* __restrict__ re,
                                             int c_total, int sub,
                                             float last_e, int last_c,
                                             bool active, float& e_out,
                                             int& c_out) {
  float be = kBig;
  int bc = c_total;
  if (active) {
    for (int c = sub; c < c_total; c += kRow) {
      const float e = __ldg(re + c);
      const bool cand = (e > last_e) || (e == last_e && c > last_c);
      if (cand && (e < be || (e == be && c < bc))) {
        be = e;
        bc = c;
      }
    }
  }
#pragma unroll
  for (int m = 1; m < kRow; m <<= 1) {
    const float oe = __shfl_xor_sync(kFull, be, m, kRow);
    const int oc = __shfl_xor_sync(kFull, bc, m, kRow);
    if (oe < be || (oe == be && oc < bc)) {
      be = oe;
      bc = oc;
    }
  }
  e_out = be;
  c_out = bc;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 1; m < kRow; m <<= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, m, kRow));
  return x;
}

// Moller-Trumbore in the operation order of ray_walk._mt_rows3.
__device__ __forceinline__ bool mt_hit(const Ray& r, const float4* __restrict__ s,
                                       bool cull, float tmn, float tmx,
                                       float& t, float& u, float& v) {
  const float4 p0 = __ldg(s);
  const float4 e1 = __ldg(s + 1);
  const float4 e2 = __ldg(s + 2);
  const float pvx = r.dy * e2.z - r.dz * e2.y;
  const float pvy = r.dz * e2.x - r.dx * e2.z;
  const float pvz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
  const bool det_ok = cull ? det > kEpsDet : fabsf(det) > kEpsDet;
  if (!det_ok) return false;
  const float inv = 1.0f / det;
  const float tvx = r.ox - p0.x;
  const float tvy = r.oy - p0.y;
  const float tvz = r.oz - p0.z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1.z - tvz * e1.y;
  const float qvy = tvz * e1.x - tvx * e1.z;
  const float qvz = tvx * e1.y - tvy * e1.x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  t = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * inv;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > tmn) & (t < tmx);
}

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

__global__ void __launch_bounds__(kBlock)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               const float* __restrict__ row_e,
               const int* __restrict__ tri_begin,
               const float4* __restrict__ tri_slots, int c_total, int cull,
               float* __restrict__ out_t, int* __restrict__ out_tri,
               float* __restrict__ out_u, float* __restrict__ out_v) {
  const int i = blockIdx.x * kBlock + threadIdx.x;  // n is a multiple of 128
  const int sub = threadIdx.x & (kRow - 1);
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  const float* re = row_e + static_cast<size_t>(i / kRow) * c_total;

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  float last_e = -kBig;
  int last_c = -1;
  bool active = true;
  while (true) {
    float e;
    int cid;
    next_cluster(re, c_total, sub, last_e, last_c, active, e, cid);
    const float tmax_eff = fminf(best_t, tmx);
    const float bound = row_max(tmax_eff);
    const bool run = active && e < kBig && e <= bound;
    if (!__any_sync(kFull, run)) break;
    if (!run) {
      active = false;  // a row that stops never restarts: its state is frozen
      continue;
    }
    if (tmax_eff > tmn) {
      const float4* blk = tri_slots + static_cast<size_t>(cid) * kSlots * 3;
      float cb = kBig, cu = 0.0f, cv = 0.0f;
      int cs = -1;
      for (int s = 0; s < kSlots; ++s) {
        float t, u, v;
        if (mt_hit(r, blk + 3 * s, cull != 0, tmn, tmax_eff, t, u, v) &&
            t < cb) {
          cb = t;
          cs = s;
          cu = u;
          cv = v;
        }
      }
      if (cb < best_t) {
        best_t = cb;
        best_id = __ldg(tri_begin + cid) + cs;
        best_u = cu;
        best_v = cv;
      }
    }
    last_e = e;
    last_c = cid;
  }
  out_t[i] = best_t;
  out_tri[i] = best_id;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

__global__ void __launch_bounds__(kBlock)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tmin, const float* __restrict__ tmax,
           const float* __restrict__ row_e,
           const float4* __restrict__ tri_slots, int c_total,
           int* __restrict__ out_occ) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int sub = threadIdx.x & (kRow - 1);
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  const float* re = row_e + static_cast<size_t>(i / kRow) * c_total;

  bool occ = false;
  float last_e = -kBig;
  int last_c = -1;
  bool active = true;
  while (true) {
    float e;
    int cid;
    next_cluster(re, c_total, sub, last_e, last_c, active, e, cid);
    const float bound = row_max(occ ? -kBig : tmx);
    const bool run = active && e < kBig && e <= bound;
    if (!__any_sync(kFull, run)) break;
    if (!run) {
      active = false;
      continue;
    }
    if (!occ && tmx > tmn) {
      const float4* blk = tri_slots + static_cast<size_t>(cid) * kSlots * 3;
      for (int s = 0; s < kSlots; ++s) {
        float t, u, v;
        if (mt_hit(r, blk + 3 * s, false, tmn, tmx, t, u, v)) {
          occ = true;
          break;
        }
      }
    }
    last_e = e;
    last_c = cid;
  }
  out_occ[i] = occ ? 1 : 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. n is a multiple of 128; all pointers
// are device pointers; the launch goes on `stream`. Returns the
// cudaGetLastError() after the launch (0 on success).
extern "C" int ray_walk_closest(const float* o, const float* d,
                                const float* tmin, const float* tmax,
                                const float* row_e, const int* tri_begin,
                                const float* tri_slots, int n, int c_total,
                                int cull, float* out_t, int* out_tri,
                                float* out_u, float* out_v, void* stream) {
  closest_kernel<<<n / kBlock, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, row_e, tri_begin,
      reinterpret_cast<const float4*>(tri_slots), c_total, cull, out_t,
      out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_walk_any(const float* o, const float* d, const float* tmin,
                            const float* tmax, const float* row_e,
                            const float* tri_slots, int n, int c_total,
                            int* out_occ, void* stream) {
  any_kernel<<<n / kBlock, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, row_e, reinterpret_cast<const float4*>(tri_slots),
      c_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}

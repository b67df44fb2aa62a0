// Row-walk ray traversal for Hopper (sm_90a): closest hit and any hit, with
// the row entry bounds computed inside the kernel.
//
// Replaces the two Pallas TPU kernels of spcbpt_tpu/ops/ray_walk.py and the
// wrapper pass that feeds them:
//   ray_walk_closest  <- _closest_kernel (ray_walk.py:144, via walk_closest)
//   ray_walk_any      <- _any_kernel     (ray_walk.py:197, via walk_any)
//   both              <- row_entries     (ray_walk.py:72), the (N/8, C) table
//   ray_walk_entries  <- row_entries alone, written out; a check of phase A,
//                        on no render path
// and computes what they compute, lane for lane: the same slab arithmetic,
// the same cluster visit order, the same stop rule, the same Moller-Trumbore
// arithmetic and the same tie-breaks, so the results equal the plain torch
// version of ops/ray_walk.py bit for bit. Built with --fmad=false and IEEE
// division for that reason.
//
// What it computes. Rays come in rows of 8 consecutive lanes. A row's entry
// into a cluster is the smallest exact slab entry of its 8 rays into the
// cluster's AABB (1e30 where no ray overlaps it; a lane with tmax < tmin
// still counts when its origin lies inside the box, as in the plain
// version). A row repeatedly takes the (entry, id)-lexicographic next
// cluster and tests its rays against the cluster's triangles. Closest hit
// keeps a hit only on a strictly smaller t: the smallest slot at the
// smallest t within a cluster, the earlier cluster across clusters. Every
// slot of a cluster is tested against min(best_t, tmax) as it stood when the
// cluster was taken. A row stops once its next entry is 1e30 or exceeds the
// largest min(best_t, tmax) of its lanes (closest) or the largest tmax of
// its unoccluded lanes (any).
//
// What bounds it on the card. f32 arithmetic outside the tensor cores, in
// two terms: the slab tests of the entry phase (every live ray against the
// group boxes and the clusters of the groups in its row's reach: 50 to 71 a
// ray on the 368 clusters of the 32,576-triangle interior, 25 operations
// each) and the Moller-Trumbore tests of the visited clusters
// (about 45 operations per ray and triangle, without multiply-add
// contraction and with an IEEE reciprocal). The boxes (8.8 KB) sit in shared
// memory and the triangle table (2.3 MB) in the L2, so device memory moves
// the rays and the hits only. No tensor cores: as a matrix product the test
// would round in TF32, and the results are held bit for bit to f32
// Moller-Trumbore.
//
// What the design does about it.
//   * One warp per row, from start to finish, so no row waits on another.
//     Lane = 8 q + r: ray r of the row, quarter q of the work. Eight rows
//     (256 threads) a block.
//   * Phase A, the entries. The block stages the C boxes into shared memory
//     once, and beside them the boxes of the groups of 8 consecutive
//     clusters (neighbours in the BVH's order). Lane (r, q) tests its ray
//     against groups q, q+4, ...; three xor shuffles give the row's minimum.
//     Only the clusters of the groups in the row's reach are tested, 32 a
//     step, and one ballot compacts those in reach into the row's candidate
//     list (entry, id) in shared memory. A row reaches 3 to 4 of the
//     interior's 368 clusters. The (N, C) temporaries and the (N/8, C) table
//     of the torch pass are never made.
//   * Phase B, the order. A row visits a few of its candidates, so nothing is
//     sorted: each round a warp-wide lexicographic (entry, id) minimum over
//     the list picks the successor of the last visit, O(list) and not O(C).
//   * Phase C, the tests. Lane (r, q) tests slots q, q+4, ... below the
//     cluster's triangle count (the other slots are zeros: det = 0, a miss).
//     The 8 lanes of one q read one address, a broadcast, and each slot is
//     read once per row, from the L2-resident table through the read-only
//     path. The test has no branch, so four unrolled slots interleave. Two
//     xor shuffles (8, 16) reduce the four quarters on the key (t, slot). A
//     lane that is dead or already occluded skips its slots.
//   Measured on the card and not kept (ray_walk_variants.py at the root of
//   the repository rebuilds each form from this source; PERF.md has the
//   times): staging a cluster's triangles into a per-warp shared buffer with
//   cp.async, one buffer or two with the next candidate prefetched (each
//   slot is read once per row; one buffer helps incoherent rows, but its
//   6 KB a warp cost more occupancy on coherent ones than it gained); every
//   row against all C boxes; a branch-free exact reciprocal in place of the
//   compiler's; 4 or 16 rows a block; the slot loop unrolled less.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr float kTiny = 1e-12f;   // |direction| floor of the slab test
constexpr int kRow = 8;           // rays per row
constexpr int kWarps = 8;         // rows per block, one warp each
constexpr int kGroup = 8;         // clusters per group box
constexpr int kBlock = 32 * kWarps;
constexpr int kSlots = 128;       // triangle slots per cluster
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmn, tmx;
  float ix, iy, iz;  // floored reciprocal directions of the slab test
};

__device__ __forceinline__ float slab_inv(float da) {
  return 1.0f / (fabsf(da) < kTiny ? (da < 0.0f ? -kTiny : kTiny) : da);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ tmin,
                                        const float* __restrict__ tmax,
                                        size_t i) {
  Ray r;
  r.ox = __ldg(o + 3 * i);
  r.oy = __ldg(o + 3 * i + 1);
  r.oz = __ldg(o + 3 * i + 2);
  r.dx = __ldg(d + 3 * i);
  r.dy = __ldg(d + 3 * i + 1);
  r.dz = __ldg(d + 3 * i + 2);
  r.tmn = __ldg(tmin + i);
  r.tmx = __ldg(tmax + i);
  r.ix = slab_inv(r.dx);
  r.iy = slab_inv(r.dy);
  r.iz = slab_inv(r.dz);
  return r;
}

// The dynamic shared memory of a block: the C cluster boxes, the boxes of
// the groups of 8 consecutive clusters, then per warp the row's candidate
// list and the groups in its reach.
struct Shared {
  float4* box;   // box[2c] = (cmin, 0), box[2c+1] = (cmax, 0)
  float4* gbox;  // the same for group g: the union of clusters 8g .. 8g+7
  float* le;     // the row's candidates: entry
  int* lc;       //                       cluster id
  int* act;      // the groups in reach of the row
};

__host__ __device__ inline int group_count(int c_total) {
  return (c_total + kGroup - 1) / kGroup;
}

__device__ __forceinline__ Shared carve(unsigned char* smem, int c_total,
                                        int warp) {
  const int groups = group_count(c_total);
  Shared s;
  s.box = reinterpret_cast<float4*>(smem);
  s.gbox = s.box + 2 * c_total;
  float* lists = reinterpret_cast<float*>(s.gbox + 2 * groups);
  s.le = lists + static_cast<size_t>(warp) * (2 * c_total + groups);
  s.lc = reinterpret_cast<int*>(s.le + c_total);
  s.act = s.lc + c_total;
  return s;
}

// The block's copy of the boxes, made once: the clusters', then the groups'.
__device__ __forceinline__ void stage_boxes(const Shared& sh,
                                            const float* __restrict__ cmin,
                                            const float* __restrict__ cmax,
                                            int c_total) {
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    sh.box[2 * c] = make_float4(__ldg(cmin + 3 * c), __ldg(cmin + 3 * c + 1),
                                __ldg(cmin + 3 * c + 2), 0.0f);
    sh.box[2 * c + 1] = make_float4(__ldg(cmax + 3 * c),
                                    __ldg(cmax + 3 * c + 1),
                                    __ldg(cmax + 3 * c + 2), 0.0f);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < group_count(c_total); g += blockDim.x) {
    float4 mn = sh.box[2 * kGroup * g], mx = sh.box[2 * kGroup * g + 1];
    for (int c = kGroup * g + 1; c < min(kGroup * (g + 1), c_total); ++c) {
      const float4 a = sh.box[2 * c], b = sh.box[2 * c + 1];
      mn = make_float4(fminf(mn.x, a.x), fminf(mn.y, a.y), fminf(mn.z, a.z),
                       0.0f);
      mx = make_float4(fmaxf(mx.x, b.x), fmaxf(mx.y, b.y), fmaxf(mx.z, b.z),
                       0.0f);
    }
    sh.gbox[2 * g] = mn;
    sh.gbox[2 * g + 1] = mx;
  }
  __syncthreads();
}

// One ray's exact slab entry into a box, 1e30 without overlap, in the
// operation order of ops/ray_walk.row_entries.
__device__ __forceinline__ float slab_entry(const Ray& r, const float4 mn,
                                            const float4 mx) {
  const float lx = (mn.x - r.ox) * r.ix, hx = (mx.x - r.ox) * r.ix;
  const float ly = (mn.y - r.oy) * r.iy, hy = (mx.y - r.oy) * r.iy;
  const float lz = (mn.z - r.oz) * r.iz, hz = (mx.z - r.oz) * r.iz;
  const float lo = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  const float hi = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
  const bool ov = (lo <= hi) & (hi >= r.tmn) & (lo <= r.tmx);
  return ov ? lo : kBig;
}

// The row's entry into cluster c (every lane of the warp calls it; the 8
// lanes of a quarter share c): the minimum of the 8 rays' entries.
__device__ __forceinline__ float row_entry(const Ray& r, const float4* box,
                                           int c, int c_total) {
  float e = c < c_total ? slab_entry(r, box[2 * c], box[2 * c + 1]) : kBig;
#pragma unroll
  for (int m = 1; m < kRow; m <<= 1)
    e = fminf(e, __shfl_xor_sync(kFull, e, m));
  return e;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 1; m < kRow; m <<= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

// Phase A: the row's candidate list, the clusters with an entry below 1e30,
// in no particular order. Returns the count.
//   Pass 1, the groups: lane (r, q) tests its ray against the boxes of
//   groups q, q+4, ...; a group some ray overlaps goes into `act`. Rounding
//   is monotonic, so a ray that overlaps a cluster's box overlaps its
//   group's: a group out of reach holds no candidate, and skipping it
//   changes no entry.
//   Pass 2, the clusters of 4 groups in reach a step: lane (r, q) keeps the
//   entry of cluster r of group q, one ballot compacts the 32.
__device__ __forceinline__ int build_list(const Ray& ray, const Shared& sh,
                                          int c_total, int lane) {
  const int r = lane & (kRow - 1), q = lane >> 3;
  const unsigned below = (1u << lane) - 1u;
  const int groups = group_count(c_total);
  int n_act = 0;
  for (int base = 0; base < groups; base += 4) {
    const bool reach = row_entry(ray, sh.gbox, base + q, groups) < kBig;
    const unsigned m = __ballot_sync(kFull, reach && r == 0);
    if (reach && r == 0) sh.act[n_act + __popc(m & below)] = base + q;
    n_act += __popc(m);
  }
  __syncwarp();
  int count = 0;
  for (int base = 0; base < n_act; base += 4) {
    // past the last group in reach: a cluster id past the last cluster
    const int first =
        kGroup * (base + q < n_act ? sh.act[base + q] : groups);
    float mine = kBig;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float e = row_entry(ray, sh.box, first + k, c_total);
      if (k == r) mine = e;
    }
    const bool keep = mine < kBig;
    const unsigned m = __ballot_sync(kFull, keep);
    if (keep) {
      const int pos = count + __popc(m & below);
      sh.le[pos] = mine;
      sh.lc[pos] = first + r;
    }
    count += __popc(m);
  }
  __syncwarp();
  return count;
}

// Phase B: the (entry, id)-lexicographic successor of (last_e, last_c) in
// the list; (1e30, c_total) when none is left. The same on every lane.
__device__ __forceinline__ void next_cluster(const float* le, const int* lc,
                                             int count, int c_total, int lane,
                                             float last_e, int last_c,
                                             float& e_out, int& c_out) {
  float be = kBig;
  int bc = c_total;
  for (int j = lane; j < count; j += 32) {
    const float e = le[j];
    const int c = lc[j];
    const bool cand = (e > last_e) || (e == last_e && c > last_c);
    if (cand && (e < be || (e == be && c < bc))) {
      be = e;
      bc = c;
    }
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    const float oe = __shfl_xor_sync(kFull, be, m);
    const int oc = __shfl_xor_sync(kFull, bc, m);
    if (oe < be || (oe == be && oc < bc)) {
      be = oe;
      bc = oc;
    }
  }
  e_out = be;
  c_out = bc;
}

// Moller-Trumbore of one slot (p0, e1, e2) in the operation order of
// ray_walk._mt_rows3.
__device__ __forceinline__ bool mt_hit(const Ray& r, const float4 p0,
                                       const float4 e1, const float4 e2,
                                       bool cull, float tmx, float& t,
                                       float& u, float& v) {
  const float pvx = r.dy * e2.z - r.dz * e2.y;
  const float pvy = r.dz * e2.x - r.dx * e2.z;
  const float pvz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
  const bool det_ok = cull ? det > kEpsDet : fabsf(det) > kEpsDet;
  // no branch on det_ok: the unrolled slots interleave
  const float inv = 1.0f / (det_ok ? det : 1.0f);
  const float tvx = r.ox - p0.x;
  const float tvy = r.oy - p0.y;
  const float tvz = r.oz - p0.z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1.z - tvz * e1.y;
  const float qvy = tvz * e1.x - tvx * e1.z;
  const float qvz = tvx * e1.y - tvy * e1.x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  t = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * inv;
  return det_ok & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > r.tmn) &
         (t < tmx);
}

__global__ void __launch_bounds__(kBlock)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               const float* __restrict__ cmin, const float* __restrict__ cmax,
               const int* __restrict__ tri_begin,
               const int* __restrict__ tri_count,
               const float4* __restrict__ tri_slots, int c_total, int cull,
               float* __restrict__ out_t, int* __restrict__ out_tri,
               float* __restrict__ out_u, float* __restrict__ out_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & (kRow - 1), q = lane >> 3;
  const Shared sh = carve(smem, c_total, warp);
  stage_boxes(sh, cmin, cmax, c_total);
  // n is a multiple of 8 rows, so every warp has a row
  const size_t i = (static_cast<size_t>(blockIdx.x) * kWarps + warp) * kRow + r;
  const Ray ray = load_ray(o, d, tmin, tmax, i);
  const int count = build_list(ray, sh, c_total, lane);

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  float last_e = -kBig;
  int last_c = -1;
  while (true) {  // uniform over the warp
    float e;
    int cid;
    next_cluster(sh.le, sh.lc, count, c_total, lane, last_e, last_c, e, cid);
    const float tmax_eff = fminf(best_t, ray.tmx);
    const float bound = row_max(tmax_eff);
    if (!(e < kBig && e <= bound)) break;
    float cb = kBig, cu = 0.0f, cv = 0.0f;
    int cs = kSlots;
    const float4* blk = tri_slots + static_cast<size_t>(cid) * kSlots * 3;
    const int cnt = __ldg(tri_count + cid);
    if (tmax_eff > ray.tmn) {
#pragma unroll 4
      for (int s = q; s < cnt; s += 4) {
        float t, u, v;
        const float4* tri = blk + 3 * s;
        if (mt_hit(ray, __ldg(tri), __ldg(tri + 1), __ldg(tri + 2), cull != 0,
                   tmax_eff, t, u, v) &&
            t < cb) {
          cb = t;
          cs = s;
          cu = u;
          cv = v;
        }
      }
    }
    // the four quarters of a ray: smallest t, then smallest slot
#pragma unroll
    for (int m = kRow; m < 32; m <<= 1) {
      const float ot = __shfl_xor_sync(kFull, cb, m);
      const int os = __shfl_xor_sync(kFull, cs, m);
      const float ou = __shfl_xor_sync(kFull, cu, m);
      const float ov = __shfl_xor_sync(kFull, cv, m);
      if (ot < cb || (ot == cb && os < cs)) {
        cb = ot;
        cs = os;
        cu = ou;
        cv = ov;
      }
    }
    if (cb < best_t) {
      best_t = cb;
      best_id = __ldg(tri_begin + cid) + cs;
      best_u = cu;
      best_v = cv;
    }
    last_e = e;
    last_c = cid;
  }
  if (q == 0) {
    out_t[i] = best_t;
    out_tri[i] = best_id;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

__global__ void __launch_bounds__(kBlock)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tmin, const float* __restrict__ tmax,
           const float* __restrict__ cmin, const float* __restrict__ cmax,
           const int* __restrict__ tri_count,
           const float4* __restrict__ tri_slots, int c_total,
           int* __restrict__ out_occ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & (kRow - 1), q = lane >> 3;
  const Shared sh = carve(smem, c_total, warp);
  stage_boxes(sh, cmin, cmax, c_total);
  const size_t i = (static_cast<size_t>(blockIdx.x) * kWarps + warp) * kRow + r;
  const Ray ray = load_ray(o, d, tmin, tmax, i);
  const int count = build_list(ray, sh, c_total, lane);

  bool occ = false;  // the same on the four lanes of a ray
  float last_e = -kBig;
  int last_c = -1;
  while (true) {  // uniform over the warp
    float e;
    int cid;
    next_cluster(sh.le, sh.lc, count, c_total, lane, last_e, last_c, e, cid);
    const float bound = row_max(occ ? -kBig : ray.tmx);
    if (!(e < kBig && e <= bound)) break;
    bool hit = false;
    if (!occ && ray.tmx > ray.tmn) {
      const float4* blk = tri_slots + static_cast<size_t>(cid) * kSlots * 3;
      const int cnt = __ldg(tri_count + cid);
      for (int s = q; s < cnt && !hit; s += 4) {
        float t, u, v;
        const float4* tri = blk + 3 * s;
        // a hit at t >= 1e30 is a miss in the plain version's t table
        hit = mt_hit(ray, __ldg(tri), __ldg(tri + 1), __ldg(tri + 2), false,
                     ray.tmx, t, u, v) &&
              t < kBig;
      }
    }
    const unsigned hits = __ballot_sync(kFull, hit);
    occ = occ || ((hits >> r) & 0x01010101u) != 0u;
    last_e = e;
    last_c = cid;
  }
  if (q == 0) out_occ[i] = occ ? 1 : 0;
}

// Phase A alone, written out as the (N/8, C) table of row_entries.
__global__ void __launch_bounds__(kBlock)
entries_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               const float* __restrict__ cmin, const float* __restrict__ cmax,
               int c_total, float* __restrict__ out_e) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Shared sh = carve(smem, c_total, warp);
  stage_boxes(sh, cmin, cmax, c_total);
  const size_t row = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  const Ray ray = load_ray(o, d, tmin, tmax, row * kRow + (lane & (kRow - 1)));
  const int count = build_list(ray, sh, c_total, lane);
  float* out = out_e + row * c_total;
  for (int c = lane; c < c_total; c += 32) out[c] = kBig;
  __syncwarp();
  for (int j = lane; j < count; j += 32) out[sh.lc[j]] = sh.le[j];
}

// Dynamic shared memory of a block: 32 bytes a cluster and a group box, and
// per warp a list of C (entry, id) pairs and the groups in reach.
size_t shared_bytes(int c_total) {
  const size_t c = c_total, g = group_count(c_total);
  return 32 * (c + g) + kWarps * (8 * c + 4 * g);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace

// Plain C interface, loaded with ctypes. n is a multiple of 64 (8 rows, one
// block); all pointers are device pointers; the launches go on `stream`.
// cmin, cmax (c, 3) float32; tri_begin, tri_count (c,) int32; tri_slots
// (c, 128, 12) float32. A block needs ray_walk_shared_bytes(c) of shared
// memory. Each launch function returns the first CUDA error of setting that
// size and launching (0 on success).

extern "C" int ray_walk_shared_bytes(int c_total) {
  return static_cast<int>(shared_bytes(c_total));
}

extern "C" int ray_walk_closest(const float* o, const float* d,
                                const float* tmin, const float* tmax,
                                const float* cmin, const float* cmax,
                                const int* tri_begin, const int* tri_count,
                                const float* tri_slots, int n, int c_total,
                                int cull, float* out_t, int* out_tri,
                                float* out_u, float* out_v, void* stream) {
  const size_t bytes = shared_bytes(c_total);
  const cudaError_t err = allow_shared(closest_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  closest_kernel<<<n / (kWarps * kRow), kBlock, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, tri_begin, tri_count,
      reinterpret_cast<const float4*>(tri_slots), c_total, cull, out_t,
      out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_walk_any(const float* o, const float* d, const float* tmin,
                            const float* tmax, const float* cmin,
                            const float* cmax, const int* tri_count,
                            const float* tri_slots, int n, int c_total,
                            int* out_occ, void* stream) {
  const size_t bytes = shared_bytes(c_total);
  const cudaError_t err = allow_shared(any_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  any_kernel<<<n / (kWarps * kRow), kBlock, bytes,
               static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, tri_count,
      reinterpret_cast<const float4*>(tri_slots), c_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ray_walk_entries(const float* o, const float* d,
                                const float* tmin, const float* tmax,
                                const float* cmin, const float* cmax, int n,
                                int c_total, float* out_e, void* stream) {
  const size_t bytes = shared_bytes(c_total);
  const cudaError_t err = allow_shared(entries_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  entries_kernel<<<n / (kWarps * kRow), kBlock, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, c_total, out_e);
  return static_cast<int>(cudaGetLastError());
}

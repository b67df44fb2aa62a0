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
// t = min(tmax, 1e30) and maps padded ids to -1 in its wrapper). A dead
// lane (tmax not above tmin) never hits.
//
// What bounds it on this card. The `brute` traversal mode takes at most 512
// triangles (the Cornell box has 32). A (ray, triangle) pair of
// Moller-Trumbore is about 45 f32 operations when it reaches t, 14 when it
// stops at det, 24 at u and 39 at v; each ray reads 32 bytes (origin,
// direction, tmin, tmax) and writes 16 (closest) or 1 (any).
//  * At T = 32 the launch and the ray I/O alone take about 3 us (the kernel
//    with its pair loop removed, on 2^17-2^18 rays). The live pairs of a
//    2^17-ray bounce wavefront stop at u (71%), v (21%) or t (9%), about
//    29 operations a pair, ~90 MFLOP: 1.4 us at the f32 rate, under the
//    1.6 us its bytes take. The kernel, at 15-23 us, is held by the pairs'
//    instructions: on incoherent rays (bounce, connection) a warp's lanes
//    seldom fail a stage together, so most warps issue every stage.
//  * At T = 512 arithmetic is all (2^18 camera rays against the 512
//    triangles they hit most: 134 M pairs, 98% stopping at u, ~3.3 GFLOP,
//    ~0.05 ms at the f32 rate).
//  * Built with --fmad=false (kernels/build.py), so that every product and
//    sum rounds on its own as the plain torch version rounds it: nothing
//    fuses into an FMA, each of the 45 operations is an instruction of its
//    own, and the f32 rate counts an FMA as two. So the instruction floor
//    of a pair sits at about twice the 45-FLOP bound, before the IEEE
//    division's refinement and the checks.
//
// What the design does about it (each element kept because the card showed
// it gains; the forms that lost are rebuilt by brute_trace_variants.py).
//  * One launch a call. tmin and tmax are read as they are given: a
//    pointer with a stride of 0 (a broadcast scalar) or 1 (one per lane),
//    or, with a null pointer, a value passed by value; the wrapper copies
//    nothing. The any-hit flags are written as bools (bytes of 0 or 1), so
//    no `occ > 0` follows.
//  * The triangle table in dynamic shared memory sized to T: nine rows of
//    floats (p0x, ..., e2z), T rounded up to 4 (36 bytes a triangle),
//    copied with no integer division. A warp reads four triangles' row at
//    once as a float4 (nine shared loads per four pairs instead of nine per
//    pair), every lane the same address: a broadcast.
//  * Live rays packed in each block: the block ballots its rays' liveness
//    and lists the live ones in shared memory, in ascending order; its
//    first threads take them, 32 live rays a warp, and warps with none
//    leave. A dead lane's outputs are written directly (the miss, or
//    false). Dead lanes scattered at random no longer hold a warp.
//  * A pair test that stops at its first failing stage: det -> reject;
//    inv = 1/det, u -> reject outside [0, 1]; qvec, v -> reject if v < 0 or
//    u + v > 1; t -> reject outside (tmin, min(tmax, best t)). Every value
//    computed is the expression of ops/intersect.tri_test, in its order,
//    so a pair that is not rejected yields the plain version's t, u and v
//    bit for bit, and only pairs that the plain version rejects are cut
//    short (u > 1 fails u + v <= 1 wherever v >= 0, since rounding is
//    monotone: fl(u + v) >= u).
//  * At most 64 registers a thread, so that four 256-thread blocks fit on
//    an SM and a 2^17-ray wavefront runs in one wave.
//  * Closest walks the ids in ascending order and takes a hit only on a
//    strictly smaller t: the smallest id among equal t, as the Pallas
//    kernel's min-then-smallest-id pick and strict < across chunks do. Any
//    hit leaves a ray at its first hit.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr int kBlock = 256;      // threads per block, one live ray each
constexpr int kWarps = kBlock / 32;
constexpr int kMinBlocks = 4;    // <= 64 registers: 4 blocks an SM
constexpr int kTriVec = 4;       // triangles per float4 row read
constexpr unsigned kFull = 0xffffffffu;

// tmin or tmax of every lane: p[i * stride] (stride 0 or 1), or `value`
// where p is null.
struct Bound {
  const float* p;
  int stride;
  float value;
};

__device__ __forceinline__ float bound_at(const Bound& b, int i) {
  return b.p ? __ldg(b.p + static_cast<size_t>(i) * b.stride) : b.value;
}

// The (T, 3) p0/e1/e2 tables into shared memory as nine rows of tp floats
// (p0x, p0y, p0z, e1x, ..., e2z; tp = T rounded up to kTriVec, the padding
// zero: a degenerate triangle, rejected at det).
__device__ __forceinline__ void load_table(float* s,
                                           const float* __restrict__ p0,
                                           const float* __restrict__ e1,
                                           const float* __restrict__ e2,
                                           int t_total, int tp) {
  for (int j = threadIdx.x; j < tp; j += kBlock) {
    const bool in = j < t_total;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[c * tp + j] = in ? __ldg(p0 + 3 * j + c) : 0.0f;
      s[(3 + c) * tp + j] = in ? __ldg(e1 + 3 * j + c) : 0.0f;
      s[(6 + c) * tp + j] = in ? __ldg(e2 + 3 * j + c) : 0.0f;
    }
  }
}

// Lists the block's live lanes (ascending) in `live` and returns their
// count; every thread of the block calls it. Its first barrier also
// publishes the triangle table.
__device__ __forceinline__ int pack_live(int i, bool alive, int* live,
                                         int* counts) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, alive);
  if (lane == 0) counts[warp] = __popc(m);
  __syncthreads();
  int offset = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = counts[w];
    offset += w < warp ? c : 0;
    total += c;
  }
  if (alive) live[offset + __popc(m & ((1u << lane) - 1u))] = i;
  __syncthreads();
  return total;
}

// The block's rays: dead lanes' outputs are written by `dead`, the live
// ones packed (pack_live); returns the live ray this thread takes, or -1.
template <typename Dead>
__device__ __forceinline__ int take_ray(int n, const Bound& tmin,
                                        const Bound& tmax, int* live,
                                        int* counts, Dead dead) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  bool alive = false;
  if (i < n) {
    alive = bound_at(tmax, i) > bound_at(tmin, i);
    if (!alive) dead(i);
  }
  const int count = pack_live(i, alive, live, counts);
  return static_cast<int>(threadIdx.x) < count ? live[threadIdx.x] : -1;
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

// One triangle's nine floats.
struct Tri {
  float p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ float pick(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// kTriVec consecutive triangles, each of the nine rows read as one float4;
// tri(c) is triangle c of them (c a constant after unrolling).
struct Quad {
  float4 f[9];
  __device__ __forceinline__ Tri tri(int c) const {
    return Tri{pick(f[0], c), pick(f[1], c), pick(f[2], c),
               pick(f[3], c), pick(f[4], c), pick(f[5], c),
               pick(f[6], c), pick(f[7], c), pick(f[8], c)};
  }
};

__device__ __forceinline__ Quad load_quad(const float4* s, int tq, int q) {
  Quad x;
#pragma unroll
  for (int row = 0; row < 9; ++row) x.f[row] = s[row * tq + q];
  return x;
}

// Moller-Trumbore of ray r against triangle tr, in the operation order of
// intersect.tri_test (pvec = cross(d, e2), det = dot(e1, pvec), tvec =
// o - p0, u = dot(tvec, pvec) * inv, qvec = cross(tvec, e1), v = dot(d,
// qvec) * inv, t = dot(e2, qvec) * inv), leaving at its first failing
// check. True for a hit with t in (tmn, hi).
template <bool kCull>
__device__ __forceinline__ bool pair_hit(const Ray& r, const Tri& tr,
                                         float tmn, float hi, float& t,
                                         float& u, float& v) {
  const float pvx = r.dy * tr.e2z - r.dz * tr.e2y;
  const float pvy = r.dz * tr.e2x - r.dx * tr.e2z;
  const float pvz = r.dx * tr.e2y - r.dy * tr.e2x;
  const float det = tr.e1x * pvx + tr.e1y * pvy + tr.e1z * pvz;
  if (kCull ? !(det > kEpsDet) : !(fabsf(det) > kEpsDet)) return false;
  const float inv = 1.0f / det;
  const float tvx = r.ox - tr.p0x;
  const float tvy = r.oy - tr.p0y;
  const float tvz = r.oz - tr.p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  const float qvx = tvy * tr.e1z - tvz * tr.e1y;
  const float qvy = tvz * tr.e1x - tvx * tr.e1z;
  const float qvz = tvx * tr.e1y - tvy * tr.e1x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  if (!(v >= 0.0f && u + v <= 1.0f)) return false;
  t = (tr.e2x * qvx + tr.e2y * qvy + tr.e2z * qvz) * inv;
  return t > tmn && t < hi;
}

template <bool kCull>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               Bound tmin, Bound tmax, const float* __restrict__ p0,
               const float* __restrict__ e1, const float* __restrict__ e2,
               int n, int t_total, float* __restrict__ out_t,
               int* __restrict__ out_tri, float* __restrict__ out_u,
               float* __restrict__ out_v) {
  extern __shared__ float4 table[];
  __shared__ int live[kBlock];
  __shared__ int counts[kWarps];
  const int tq = (t_total + kTriVec - 1) / kTriVec;
  load_table(reinterpret_cast<float*>(table), p0, e1, e2, t_total,
             tq * kTriVec);
  const int k = take_ray(n, tmin, tmax, live, counts, [&](int i) {
    out_t[i] = kBig;
    out_tri[i] = -1;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
  });
  if (k < 0) return;
  const float tmn = bound_at(tmin, k);
  const float tmx = bound_at(tmax, k);
  const Ray r = load_ray(o, d, k);
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  float hi = fminf(tmx, kBig);   // t < tmax and t < best_t
  for (int q = 0; q < tq; ++q) {
    const Quad x = load_quad(table, tq, q);
#pragma unroll
    for (int c = 0; c < kTriVec; ++c) {
      float t, u, v;
      if (pair_hit<kCull>(r, x.tri(c), tmn, hi, t, u, v)) {
        best_t = t;
        best_id = kTriVec * q + c;
        best_u = u;
        best_v = v;
        hi = t;
      }
    }
  }
  out_t[k] = best_t;
  out_tri[k] = best_id;
  out_u[k] = best_u;
  out_v[k] = best_v;
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           Bound tmin, Bound tmax, const float* __restrict__ p0,
           const float* __restrict__ e1, const float* __restrict__ e2,
           int n, int t_total, bool* __restrict__ out_occ) {
  extern __shared__ float4 table[];
  __shared__ int live[kBlock];
  __shared__ int counts[kWarps];
  const int tq = (t_total + kTriVec - 1) / kTriVec;
  load_table(reinterpret_cast<float*>(table), p0, e1, e2, t_total,
             tq * kTriVec);
  const int k = take_ray(n, tmin, tmax, live, counts,
                         [&](int i) { out_occ[i] = false; });
  if (k < 0) return;
  const float tmn = bound_at(tmin, k);
  const float tmx = bound_at(tmax, k);
  const Ray r = load_ray(o, d, k);
  bool occ = false;
  for (int q = 0; q < tq && !occ; ++q) {
    const Quad x = load_quad(table, tq, q);
#pragma unroll
    for (int c = 0; c < kTriVec && !occ; ++c) {
      float t, u, v;
      occ = pair_hit<false>(r, x.tri(c), tmn, tmx, t, u, v);
    }
  }
  out_occ[k] = occ;
}

size_t table_bytes(int t_total) {
  return sizeof(float) * 9 * ((t_total + kTriVec - 1) / kTriVec * kTriVec);
}

}  // namespace

// Plain C interface, loaded with ctypes. All pointers are device pointers:
// o/d (n, 3), p0/e1/e2 (t_total, 3) float32 and contiguous, 0 < t_total <=
// 512; tmin and tmax each a pointer read with a stride of 0 or 1, or null
// and then the value beside it for every lane; out_occ a bool (one byte)
// per lane. The launch goes on `stream`. Returns the cudaGetLastError()
// after the launch (0 on success).
extern "C" int brute_closest(const float* o, const float* d,
                             const float* tmin, int tmin_stride,
                             float tmin_value, const float* tmax,
                             int tmax_stride, float tmax_value,
                             const float* p0, const float* e1, const float* e2,
                             int n, int t_total, int cull, float* out_t,
                             int* out_tri, float* out_u, float* out_v,
                             void* stream) {
  const Bound lo{tmin, tmin_stride, tmin_value};
  const Bound hi{tmax, tmax_stride, tmax_value};
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t smem = table_bytes(t_total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cull) {
    closest_kernel<true><<<grid, kBlock, smem, s>>>(
        o, d, lo, hi, p0, e1, e2, n, t_total, out_t, out_tri, out_u, out_v);
  } else {
    closest_kernel<false><<<grid, kBlock, smem, s>>>(
        o, d, lo, hi, p0, e1, e2, n, t_total, out_t, out_tri, out_u, out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brute_any(const float* o, const float* d, const float* tmin,
                         int tmin_stride, float tmin_value, const float* tmax,
                         int tmax_stride, float tmax_value, const float* p0,
                         const float* e1, const float* e2, int n, int t_total,
                         bool* out_occ, void* stream) {
  const Bound lo{tmin, tmin_stride, tmin_value};
  const Bound hi{tmax, tmax_stride, tmax_value};
  any_kernel<<<(n + kBlock - 1) / kBlock, kBlock, table_bytes(t_total),
               static_cast<cudaStream_t>(stream)>>>(o, d, lo, hi, p0, e1, e2,
                                                    n, t_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}

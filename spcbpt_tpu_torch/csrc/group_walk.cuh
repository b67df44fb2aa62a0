// What the list walk (csrc/list_walk.cu) and the tile walk
// (csrc/tile_walk.cu) share, included by both: the ray, the slot test in
// the operation order of the plain versions' Moller-Trumbore, warp
// reductions, the staging of one cluster's slots by one warp with cp.async,
// and the closest-hit walk of one group of rays along a near-to-far cluster
// list, which K6 closest (both forms) and K5 closest run. Why that walk's
// result equals its tile's, bit for bit: csrc/list_walk.cu's comment on its
// closest forms.
//
// Triangles come as (C, 16, 128) float blocks: rows 0..8 hold p0, e1, e2
// (x, y, z) per slot, the rest zero; a zero slot has det = 0 and never hits.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr int kSlots = 128;       // slot columns of a (16, 128) block
constexpr int kBlockRows = 16;
constexpr int kTriRows = 9;       // p0 | e1 | e2, x y z each
constexpr int kStage = kTriRows * kSlots;  // floats of one staged cluster
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        size_t i) {
  Ray r;
  r.ox = __ldg(o + 3 * i);
  r.oy = __ldg(o + 3 * i + 1);
  r.oz = __ldg(o + 3 * i + 2);
  r.dx = __ldg(d + 3 * i);
  r.dy = __ldg(d + 3 * i + 1);
  r.dz = __ldg(d + 3 * i + 2);
  return r;
}

// Moller-Trumbore of slot k of a block (rows at stride 128, in global or
// shared memory) in the operation order of the plain versions (built with
// --fmad=false and IEEE division); leaves at a failing det.
__device__ __forceinline__ bool mt_slot(const Ray& r, const float* s, int k,
                                        bool cull, float tmn, float tmx,
                                        float& t, float& u, float& v) {
  const float p0x = s[0 * kSlots + k], p0y = s[1 * kSlots + k],
              p0z = s[2 * kSlots + k];
  const float e1x = s[3 * kSlots + k], e1y = s[4 * kSlots + k],
              e1z = s[5 * kSlots + k];
  const float e2x = s[6 * kSlots + k], e2y = s[7 * kSlots + k],
              e2z = s[8 * kSlots + k];
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

// The threads of a ray that split its slots, lanes `from` apart up to 32
// (xor steps from, 2 from, ...): the smallest t, then the smallest slot,
// with its u, v; every thread of the ray ends with the result.
template <int kFrom>
__device__ __forceinline__ void lex_min_threads(float& cb, int& cs, float& cu,
                                                float& cv) {
#pragma unroll
  for (int m = kFrom; m < 32; m <<= 1) {
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
}

// --- staging with cp.async ---------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one of this thread's commit groups is in flight.
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One warp's staging: the first `cnt` slots of rows 0..8 of cluster `cid`,
// rounded up to whole 16-byte copies (the columns past the count are zero
// and never tested), at the block's row stride; one commit group per stage.
__device__ __forceinline__ void stage_warp(float* buf,
                                           const float* __restrict__ blocks,
                                           int cid, int cnt, int lane) {
  const float* b = blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
  const int chunks = (cnt + 3) >> 2;  // per row
  for (int j = lane; j < kTriRows * chunks; j += 32) {
    const int row = j / chunks;
    const int at = row * kSlots + 4 * (j - row * chunks);
    cp_async16(buf + at, b + at);
  }
  commit();
}

// The slots of round r, at position `at` of the group's chunk (cluster c_id,
// c_cnt slots): in place (resident), or staged into the warp's buffer r & 1
// (streamed), the next position copied into the other while this one is
// tested, if the bound reaches it now (should the bound fall past it this
// round, the copy is drained unused). `open`, `cid`, `cnt`: the calling
// lane's position of the chunk; `staged`: the position copied ahead.
template <bool kStream>
__device__ __forceinline__ const float* round_block(
    const float* __restrict__ blocks, float* buf, int r, int at, int c_id,
    int c_cnt, bool open, int cid, int cnt, int lane, int& staged) {
  if (!kStream)
    return blocks + static_cast<size_t>(c_id) * kBlockRows * kSlots;
  if (staged != r)  // not copied ahead: the first round of a chunk
    stage_warp(buf + (r & 1) * kStage, blocks, c_id, c_cnt, lane);
  const int nx = at < 31 ? at + 1 : 31;
  if (__shfl_sync(kFull, open, nx) && at < 31) {
    stage_warp(buf + ((r + 1) & 1) * kStage, blocks,
               __shfl_sync(kFull, cid, nx), __shfl_sync(kFull, cnt, nx), lane);
    staged = r + 1;
    wait_all_but_newest();
  } else {
    staged = -1;
    wait_all();
  }
  __syncwarp();  // every lane's copies of this position are visible
  return buf + (r & 1) * kStage;
}

// --- the closest-hit walk of one group -----------------------------------

// One ray's closest hit (t 1e30, id -1, u = v = 0 on a miss) and its
// group's walk: the positions it walked and the slots its rays tested,
// summed over the rays.
struct GroupHit {
  float t, u, v;
  int id;
  int rounds, slots;
};

// The closest-hit walk of one group of kGroupRays rays, one warp: lane =
// kGroupRays * q + ray, thread q of its ray tests slots q, q + kSplit, ...
// below the cluster's tri_count (each test leaving at a failing det); the
// threads' (t, slot)-smallest hits meet in lex_min_threads, and the ray's
// best improves on strict <. The list holds n clusters sorted near to far;
// decode(pos, te, cid, base) gives position pos < n: the tile's entry bound
// into the cluster, its id and the id of its slot 0. The group takes the
// list 32 positions at a time (lane j decodes position p0 + j) and each
// round shuffles its position out of the lane that holds it; it stops at
// the list's end or (prune) at an entry past its bound, the warp max of
// min(best_t, tmax) over its rays, tested before round 0 and after every
// round. The slots are read in place (resident) or staged into the warp's
// double buffer `buf` of 2 x kStage floats (kStream, round_block).
template <int kGroupRays, bool kStream, typename Decode>
__device__ __forceinline__ GroupHit closest_group_walk(
    const Ray& ray, float tmn, float tmx, int n, int cull, int prune,
    const float* __restrict__ blocks, const int* __restrict__ tri_count,
    float* buf, int lane, Decode decode) {
  constexpr int kSplit = 32 / kGroupRays;  // threads per ray
  const int q = lane / kGroupRays;
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  float bound = warp_max(fminf(best_t, tmx));
  int r = 0, slots = 0;
  int staged = -1;  // streamed: the position copied ahead
  bool walking = n > 0;
  for (int p0 = 0; walking; p0 += 32) {
    const int pos = p0 + lane;
    const bool valid = pos < n;
    int cid = 0, cnt = 0, base = 0;
    float te = kBig;
    if (valid) {
      decode(pos, te, cid, base);
      cnt = __ldg(tri_count + cid);
    }
    for (; r - p0 < 32; ++r) {
      const int at = r - p0;
      // the stop: the list's end, or (prune) an entry past the bound
      const bool open = valid && !(prune && te > bound);
      if (!__shfl_sync(kFull, open, at)) {
        walking = false;
        break;
      }
      const int c_id = __shfl_sync(kFull, cid, at);
      const int c_cnt = __shfl_sync(kFull, cnt, at);
      const int c_base = __shfl_sync(kFull, base, at);
      const float* s = round_block<kStream>(blocks, buf, r, at, c_id, c_cnt,
                                            open, cid, cnt, lane, staged);
      slots += c_cnt;
      const float tmax_eff = fminf(best_t, tmx);
      float cb = kBig, cu = 0.0f, cv = 0.0f;
      int cs = kSlots;
      if (tmax_eff > tmn) {
#pragma unroll 4
        for (int k = q; k < c_cnt; k += kSplit) {
          float t, u, v;
          if (mt_slot(ray, s, k, cull != 0, tmn, tmax_eff, t, u, v) &&
              t < cb) {
            cb = t;
            cu = u;
            cv = v;
            cs = k;
          }
        }
      }
      lex_min_threads<kGroupRays>(cb, cs, cu, cv);
      if (cb < best_t) {
        best_t = cb;
        best_id = c_base + cs;
        best_u = cu;
        best_v = cv;
      }
      bound = warp_max(fminf(best_t, tmx));
      // every lane is done with this stage before it is refilled
      if (kStream) __syncwarp();
    }
  }
  if (kStream) wait_all();  // drain a copy ahead of a walk that stopped
  return GroupHit{best_t, best_u, best_v, best_id, r, kGroupRays * slots};
}

}  // namespace

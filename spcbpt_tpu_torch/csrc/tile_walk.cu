// Tile-walk ray traversal for Hopper (sm_90a): the round walk of the tile
// mode's closest hit, its single round, and the fused walk in its closest-hit
// and any-hit forms.
//
// Replaces the Pallas TPU kernels of spcbpt_tpu/ops/pallas_tile.py:
//   tile_round_walk    <- _round_kernel   (pallas_tile.py:416, via mt_round)
//                         together with the host loop that calls it once a
//                         round (spcbpt_tpu/ops/tile_trace.py:241-277,
//                         `_round_walk` of ops/tile_trace.py here)
//   tile_round         <- _round_kernel alone: one round; a check, on no
//                         render path
//   tile_walk_closest  <- _closest_kernel (pallas_tile.py:163, via
//                                          pallas_closest)
//   tile_walk_any      <- _any_kernel     (pallas_tile.py:236, via pallas_any)
// and computes what they compute, lane for lane: the Moller-Trumbore
// arithmetic of `_mt_vpu` in its operation order (built with --fmad=false,
// IEEE division, so t/u/v round like the plain torch versions of
// ops/pallas_tile.py), the minimum t with the smallest slot on ties, the
// closest termination e <= max(min(best_t, tmax)) with strict < on
// improvement, the interval-slab entry bounds of `_block_entries` and the
// (entry, id)-lexicographic visit order of `_next_cluster`, and the any-hit
// stop once every lane is occluded or dead.
//
// Triangles come as the JAX package's (C, 16, 128) float blocks: rows 0..8
// hold p0, e1, e2 (x, y, z) per slot, tri_k slots in use, the rest zero.
// A zero slot has det = 0 and never hits, so the slot loops stop at the
// cluster's triangle count (tri_count, at most tri_k).
//
// What bounds them on the card. At the interior's 1,370 clusters of at most
// 32 triangles (23.8 on average) a visit costs each ray up to 32 tests of
// ~45 f32 operations against 1.15 KB of triangles, so the arithmetic is
// small and the bytes smaller; the walks are bound by their chains of
// rounds: a tile (or a group of its rays) walks its clusters in series
// until its farthest lane's hit (closest) or until every lane is occluded
// (any), and a tile of secondary rays overlaps many clusters. The single
// round is one wave of blocks: its time is the launch, its I/O and one
// ray's chain of slot tests.
//
// What the designs do about it.
//   tile_round_walk: the whole walk of a 256-ray tile in one block, one
//     thread per ray, tiles independent (the host loop's lock step over
//     tiles changes no tile's result), so a walk is one launch with no host
//     sync. The tile's column of the visit order (entries, ids and the
//     clusters' triangle counts, sorted near to far by
//     ops/tile_trace._prepare) is read 256 rounds at a time into shared
//     memory. Each round: the exact block max of min(best_t, tmax) (warp
//     shuffles, one shared step, one barrier) decides the stop; the
//     cluster is staged and tested as in tile_round (stage_slots,
//     closest_in_stage), the next round's cluster in flight with cp.async
//     while this one is tested (its id is known: the order is fixed); a
//     second barrier makes the stage visible. The hit (t, tri, u, v) is
//     written once, and the tile's round count beside it. Measured on the
//     card and not kept (tile_walk_variants.py): one buffer filled after
//     the round's bound is known, and no staging (the slots read from L2).
//   tile_round: one block per tile, one thread per ray. A tile that runs
//     stages the first tri_count slots of its cluster's rows 0..8 with
//     16-byte cp.async copies (stage_slots: at K = 32, 1.15 KB instead of
//     the block's 4.6 KB), and each ray tests the slots below tri_count
//     (closest_in_stage, the slot loop the walk runs); a tile that does not
//     run writes misses and stages nothing. The first form (every tile
//     copying all 9 x 128 floats with scalar loads, every ray testing tri_k
//     slots) and a ray's slots split over 2 or 4 threads (one wave of
//     blocks either way: no shorter) are rebuilt by tile_walk_variants.py.
//   tile_walk_closest, tile_walk_any: see the comment above their prologue.
#include <cuda_runtime.h>

#include "group_walk.cuh"

namespace {

constexpr float kTiny = 1e-12f;   // |direction| floor of the slab test
constexpr int kTile = 128;        // rays per tile of the fused walk
constexpr int kMaxRoundLanes = 256;  // rays per tile of the round walk
constexpr int kClosestRays = 8;   // rays per group (a warp) of K5 closest
constexpr int kClosestSplit = 32 / kClosestRays;  // threads per ray
constexpr int kClosestThreads = kTile * kClosestSplit;  // a tile's block
constexpr int kClosestWarps = kClosestThreads / 32;     // groups a tile

// Slots [0, 4 chunks) of rows 0..8 of cluster `cid` into s[row * 4 kq +
// slot], 16 bytes a copy, issued by every thread of the block; slots past
// a cluster's tri_count are zero and never hit, so `chunks` =
// ceil(tri_count / 4) copies a row suffice, up to the row stride kq. The
// loop's stride is blockDim.x, not a constant (tile_walk_variants.py's
// any_const_stride times K5 any with kTile). Completion: wait_all (or
// wait_all_but_newest), then a barrier.
__device__ __forceinline__ void stage_slots(float* s,
                                            const float* __restrict__ blocks,
                                            int cid, int chunks, int kq) {
  const float4* b = reinterpret_cast<const float4*>(
      blocks + static_cast<size_t>(cid) * kBlockRows * kSlots);
  float4* s4 = reinterpret_cast<float4*>(s);
  for (int j = threadIdx.x; j < kTriRows * chunks; j += blockDim.x) {
    const int row = j / chunks;
    const int col = j - row * chunks;
    cp_async16(s4 + row * kq + col, b + row * (kSlots / 4) + col);
  }
}

// Moller-Trumbore without a branch (an unrolled slot loop interleaves), for
// slot k of a staged buffer whose rows hold `ks` slots, or of a block in
// global memory (ks = 128); equal to mt_slot wherever it reports a hit.
template <bool kGlobal>
__device__ __forceinline__ bool mt_test(const Ray& r, const float* s, int ks,
                                        int k, bool cull, float tmn,
                                        float tmx, float& t, float& u,
                                        float& v) {
  auto ld = [&](int row) {
    return kGlobal ? __ldg(s + row * ks + k) : s[row * ks + k];
  };
  const float p0x = ld(0), p0y = ld(1), p0z = ld(2);
  const float e1x = ld(3), e1y = ld(4), e1z = ld(5);
  const float e2x = ld(6), e2y = ld(7), e2z = ld(8);
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = cull ? det > kEpsDet : fabsf(det) > kEpsDet;
  const float inv = 1.0f / (det_ok ? det : 1.0f);
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  return det_ok & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > tmn) &
         (t < tmx);
}

// K4's slot loop: one ray against slots [0, cnt) of a staged cluster whose
// rows hold `ks` slots, keeping the hit of smallest t under tmx (strict <
// over ascending slots: the smallest slot on equal t) in (cb, cu, cv, cs),
// which the caller starts at (1e30, 0, 0, 128).
__device__ __forceinline__ void closest_in_stage(const Ray& r, const float* s,
                                                 int ks, int cnt, bool cull,
                                                 float tmn, float tmx,
                                                 float& cb, float& cu,
                                                 float& cv, int& cs) {
#pragma unroll 4
  for (int k = 0; k < cnt; ++k) {
    float t, u, v;
    if (mt_test<false>(r, s, ks, k, cull, tmn, tmx, t, u, v) && t < cb) {
      cb = t;
      cu = u;
      cv = v;
      cs = k;
    }
  }
}

// Whether one ray hits any of slots [0, cnt) of a staged buffer
// (kGlobal: a block in global memory).
template <bool kGlobal>
__device__ __forceinline__ bool any_in_slots(const Ray& r, const float* s,
                                             int ks, int cnt, float tmn,
                                             float tmx) {
  bool hit = false;
#pragma unroll 4
  for (int k = 0; k < cnt; ++k) {
    float t, u, v;
    hit |= mt_test<kGlobal>(r, s, ks, k, false, tmn, tmx, t, u, v);
  }
  return hit;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

// ---------------------------------------------------------------------------
// K4: the round walk, one block per tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxRoundLanes)
round_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ tmin,
                  const float* __restrict__ tmax,
                  const float* __restrict__ entries,
                  const int* __restrict__ ids,
                  const float* __restrict__ blocks,
                  const int* __restrict__ tri_begin,
                  const int* __restrict__ tri_count, int n_cols, int tri_k,
                  int cull, float* __restrict__ out_t,
                  int* __restrict__ out_tri, float* __restrict__ out_u,
                  float* __restrict__ out_v, int* __restrict__ out_rounds) {
  extern __shared__ __align__(16) float stage[];  // 2 x 9 x ks floats
  __shared__ float se[kMaxRoundLanes];  // 256 rounds of the visit order
  __shared__ int sc[kMaxRoundLanes];
  __shared__ int sk[kMaxRoundLanes];    // their clusters' triangle counts
  __shared__ float red[kMaxRoundLanes / 32];
  const int lanes = blockDim.x, tid = threadIdx.x, nw = lanes >> 5;
  const int kq = (tri_k + 3) >> 2, ks = 4 * kq;
  const size_t tile = blockIdx.x;
  const size_t i = tile * lanes + tid;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i), tmx = __ldg(tmax + i);
  const float* erow = entries + tile * n_cols;
  const int* irow = ids + tile * n_cols;

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  const int first = __ldg(irow);
  stage_slots(stage, blocks, first, (__ldg(tri_count + first) + 3) >> 2, kq);
  commit();
  int rnd = 0;
  for (; rnd < n_cols; ++rnd) {
    const int j = rnd % lanes;
    if (j == 0) {  // the next 256 rounds' clusters; the last ones were read
      const int c = rnd + tid;  // before the previous round's second barrier
      se[tid] = c < n_cols ? __ldg(erow + c) : kBig;
      const int id = c < n_cols ? __ldg(irow + c) : 0;
      sc[tid] = id;
      sk[tid] = c < n_cols ? __ldg(tri_count + id) : 0;
    }
    const float m = warp_max(fminf(best_t, tmx));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    float bound = red[0];
    for (int w = 1; w < nw; ++w) bound = fmaxf(bound, red[w]);
    const float e = se[j];
    const int cid = sc[j];
    const int cnt = sk[j];
    if (!(e < kBig && e <= bound)) break;  // uniform: a tile never restarts
    // every thread is past its reads of the other buffer (the barrier
    // above): the next round's cluster goes there while this one is tested
    float* cur = stage + (rnd & 1) * kTriRows * ks;
    if (rnd + 1 < n_cols) {
      int nxt, ncnt;
      if (j + 1 < lanes) {
        nxt = sc[j + 1];
        ncnt = sk[j + 1];
      } else {
        nxt = __ldg(irow + rnd + 1);
        ncnt = __ldg(tri_count + nxt);
      }
      stage_slots(stage + ((rnd + 1) & 1) * kTriRows * ks, blocks, nxt,
                  (ncnt + 3) >> 2, kq);
    }
    commit();
    wait_all_but_newest();  // this round's copies have landed
    __syncthreads();     // ... everyone's
    const float tmax_eff = fminf(best_t, tmx);
    if (tmax_eff > tmn) {
      float cb = kBig, cu = 0.0f, cv = 0.0f;
      int cs = kSlots;
      closest_in_stage(r, cur, ks, cnt, cull != 0, tmn, tmax_eff, cb, cu, cv,
                       cs);
      if (cb < best_t) {
        best_t = cb;
        best_id = __ldg(tri_begin + cid) + cs;
        best_u = cu;
        best_v = cv;
      }
    }
  }
  wait_all();  // a copy still in flight after the stop
  out_t[i] = best_t;
  out_tri[i] = best_id;
  out_u[i] = best_u;
  out_v[i] = best_v;
  if (tid == 0) out_rounds[tile] = rnd;
}

// ---------------------------------------------------------------------------
// K4 alone: one round
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxRoundLanes)
round_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ tmin,
             const float* __restrict__ tmax_eff,
             const int* __restrict__ cid,
             const unsigned char* __restrict__ run,
             const float* __restrict__ blocks,
             const int* __restrict__ tri_count, int tri_k, int cull,
             float* __restrict__ out_t, float* __restrict__ out_u,
             float* __restrict__ out_v, float* __restrict__ out_dn,
             int* __restrict__ out_slot) {
  extern __shared__ __align__(16) float stage[];  // 9 x ks floats
  const int tile = blockIdx.x;
  const size_t i = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int bs = kSlots;
  if (run[tile]) {  // uniform over the block
    const int kq = (tri_k + 3) >> 2;
    const int c = cid[tile];
    const int cnt = __ldg(tri_count + c);
    stage_slots(stage, blocks, c, (cnt + 3) >> 2, kq);
    commit();
    const float tmn = __ldg(tmin + i);
    const float tmx = __ldg(tmax_eff + i);
    const Ray r = load_ray(o, d, i);
    wait_all();
    __syncthreads();
    if (tmx > tmn)
      closest_in_stage(r, stage, 4 * kq, cnt, cull != 0, tmn, tmx, bt, bu, bv,
                       bs);
  }
  out_t[i] = bt;
  out_u[i] = bu;
  out_v[i] = bv;
  out_dn[i] = 1.0f;
  out_slot[i] = bs;
}

// ---------------------------------------------------------------------------
// K5: the fused walk, closest and any hit
// ---------------------------------------------------------------------------
//
// Both kernels take one 128-ray tile a block and begin with one prologue
// (tile_order): the block reduces the tile's bounds (tile_trace.
// tile_entries' hull), tests all C boxes a block-width at a step and
// compacts those in reach into one candidate list (ballot, then a prefix
// over the warps' counts), and sorts it near to far once by (entry, id) (a
// bitonic sort of 64-bit keys in shared memory). Then each walks the list.
//
// Closest hit. What bounded its first form (rebuilt by tile_walk_variants.py
// as old_closest): every round scanned all C entries for the lexicographic
// successor (11 strided reads a thread at 1,370 clusters, shuffles and 2
// barriers), took the tile's block max of min(best_t, tmax) (2 barriers),
// copied the whole 9 x 128-float block with scalar loads (23.8 triangles a
// cluster on the interior), tested tri_k slots a ray and ended in one more
// barrier; and the tile walked in lock step until its farthest lane's hit,
// so a tile holding one ray that escapes the scene walked its whole list.
// The design, after the prologue (no block barrier past it):
//   * Groups of kClosestRays rays, a warp each, walk the tile's sorted list
//     with K6 closest's walk (closest_group_walk of csrc/group_walk.cuh):
//     each stops on its own bound, the warp max of min(best_t, tmax) over
//     its rays (shuffles), tested before round 0 and after every round; a
//     group continues on entry <= bound, as the plain walk does. A ray's
//     slots lie on kClosestSplit threads (lane = kClosestRays * q + ray,
//     slot k on thread k % kClosestSplit), below the cluster's tri_count
//     only, each slot test leaving at a failing det (mt_slot); the threads'
//     (t, slot)-smallest hits meet in lex_min_threads; best improves on
//     strict <. The list is taken 32 positions a step (lane j decodes
//     position p0 + j from its key: entry, id, and tri_begin), and round r
//     shuffles its position out of lane r - p0, so that no round waits on a
//     load of the list.
//   * The slots are read in place: the whole table (1,370 x 8 KB at the
//     interior) sits in the 50 MB L2. Measured and not kept
//     (tile_walk_variants.py): 32-ray groups of one thread a ray and 16-ray
//     groups (both slower: a larger group stops later), and the walk's
//     streamed form, a per-warp cp.async double buffer with the next
//     position in flight while one is tested (its 147 KB of buffers a
//     block leave one block an SM).
//   * Optionally, each group writes the positions it walked and the slots
//     its rays tested, summed over the rays (out_rounds): the work the
//     kernel's bound is taken from.
//   * Why a group's result equals its tile's, bit for bit (the argument of
//     csrc/list_walk.cu's closest forms). Along the shared order a group's
//     bound is never above its tile's bound at the same round, so it stops
//     at a round no later than the tile. For every round from the group's
//     stop to the tile's, the entry is at or above the stopping one and so
//     above min(best_t, tmax) of each lane of the group (the list is
//     sorted), and each entry is the tile's lower bound on the hit t of
//     every lane of the tile in that cluster (the property the plain walk's
//     own stop rests on): no hit in those rounds passes t < tmax_eff. Ties
//     between clusters at equal t go to the earlier cluster of the shared
//     order in both walks. Only the tile's entries are used, never a
//     group's or a ray's own: computed hits lie up to 13,736 ulps below a
//     ray's own box entry.
//   * The list holds at most 16,384 clusters: 128 KB of keys in shared
//     memory, the limit the tile mode has through K5 any.
//
// Any hit. Occlusion is per lane and does not depend on the visit order: a
// lane is occluded where a cluster its tile's entry bounds keep holds a hit
// in its interval, and a tile stops only once each of its lanes is occluded
// or dead. So the walk returns pallas_any_plain's flags bit for bit, and
// visits what the plain walk visits. One thread per ray: each round stages
// the cluster's tri_k slots, the next candidate's copy in flight with
// cp.async, and one barrier both publishes the stage and decides the stop
// (every lane occluded or dead). The rays that are neither occluded nor
// dead test the cluster's slots up to its triangle count; a warp whose rays
// are all done skips them. Measured on the card and not kept
// (tile_walk_variants.py rebuilds each form from this source): the form
// before (a block-wide next-cluster reduction over all C entries every
// round, all 128 slots staged), and one warp per 32 rays with its own
// entry bounds and candidate list and no block barrier (fewer visits, but
// its 11 KB list a warp at 1,370 clusters halves the resident warps, and it
// reads the slots from L2).

// Block-wide reductions over a block of kThreads threads. Each ends with a
// barrier, so the scratch (kThreads / 32 floats) is free for the next one.
template <int kThreads>
__device__ __forceinline__ float block_min(float x, float* red) {
  x = warp_min(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) x = fminf(x, red[w]);
  __syncthreads();
  return x;
}

template <int kThreads>
__device__ __forceinline__ float block_max(float x, float* red) {
  return -block_min<kThreads>(-x, red);
}

// The interval bounds of a group of rays (tile_trace.tile_entries' olo, ohi,
// il, ih, straddle, tmin_lb, tmax_ub), from which one group's entry bound
// into any cluster follows.
struct Hull {
  float olo[3], ohi[3], il[3], ih[3];
  bool straddle[3];
  float tmin_lb, tmax_ub;
};

// The hull from the group's direction bounds (dlo, dhi per axis), in
// tile_entries' operation order.
__device__ __forceinline__ void hull_axis(Hull& h, int a, float dlo,
                                          float dhi) {
  h.straddle[a] = (dlo <= 0.0f) & (dhi >= 0.0f);
  const float safe_lo = fabsf(dlo) < kTiny ? (dlo < 0.0f ? -kTiny : kTiny)
                                           : dlo;
  const float safe_hi = fabsf(dhi) < kTiny ? (dhi < 0.0f ? -kTiny : kTiny)
                                           : dhi;
  h.il[a] = fminf(1.0f / safe_lo, 1.0f / safe_hi);
  h.ih[a] = fmaxf(1.0f / safe_lo, 1.0f / safe_hi);
}

// The hull of the block's rays (block-wide reductions; a ray held by
// several threads counts once, as min and max ignore repeats).
template <int kThreads>
__device__ __forceinline__ Hull block_hull(const Ray& r, float tmn, float tmx,
                                           float* red) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float dv[3] = {r.dx, r.dy, r.dz};
  Hull h;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    h.olo[a] = block_min<kThreads>(o[a], red);
    h.ohi[a] = block_max<kThreads>(o[a], red);
    hull_axis(h, a, block_min<kThreads>(dv[a], red),
              block_max<kThreads>(dv[a], red));
  }
  h.tmin_lb = block_min<kThreads>(tmn, red);
  h.tmax_ub = block_max<kThreads>(tmx, red);
  return h;
}

// The group's conservative entry bound into cluster c (tile_entries for one
// tile, in its operation order); 1e30 where no ray of the group can reach
// the cluster's box within its t-interval.
__device__ __forceinline__ float hull_entry(const Hull& h,
                                            const float* __restrict__ cmin,
                                            const float* __restrict__ cmax,
                                            int c) {
  float entry = 0.0f, exit_ = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float bmin = __ldg(cmin + 3 * c + a);
    const float bmax = __ldg(cmax + 3 * c + a);
    const float lo_ab = fminf(bmin - h.ohi[a], bmax - h.ohi[a]);
    const float hi_ab = fmaxf(bmin - h.olo[a], bmax - h.olo[a]);
    const float p1 = lo_ab * h.il[a];
    const float p2 = lo_ab * h.ih[a];
    const float p3 = hi_ab * h.il[a];
    const float p4 = hi_ab * h.ih[a];
    float ax_lo = fminf(fminf(p1, p2), fminf(p3, p4));
    float ax_hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
    if (h.straddle[a]) {
      ax_lo = -kBig;
      ax_hi = kBig;
    }
    entry = a == 0 ? ax_lo : fmaxf(entry, ax_lo);
    exit_ = a == 0 ? ax_hi : fminf(exit_, ax_hi);
  }
  const bool overlap = (entry <= exit_) & (exit_ >= h.tmin_lb) &
                       (entry <= h.tmax_ub);
  return overlap ? entry : kBig;
}

// (entry, id) as one key that sorts like the lexicographic pair (entries
// below 1e30; -0 sorts with +0, as they compare), and back.
__device__ __forceinline__ unsigned long long order_key(float e, int c) {
  unsigned u = __float_as_uint(e == 0.0f ? 0.0f : e);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(c);
}

__device__ __forceinline__ float key_entry(unsigned long long key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ int key_id(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffu);
}

// The power of two at or above n (1 for n <= 1): a sorted list's length.
__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The prologue of both K5 kernels, called by every thread of a block of
// kThreads that holds one tile: the tile's clusters in reach of its hull h,
// sorted near to far, as keys[0, count) ascending; returns count. keys holds
// pow2_at_least(C) entries; wcount kThreads / 32 ints. Ends with a barrier.
template <int kThreads>
__device__ __forceinline__ int tile_order(const Hull& h,
                                          const float* __restrict__ cmin,
                                          const float* __restrict__ cmax,
                                          int c_total,
                                          unsigned long long* keys,
                                          int* wcount) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int base = 0; base < c_total; base += kThreads) {
    const int c = base + tid;
    const float e = c < c_total ? hull_entry(h, cmin, cmax, c) : kBig;
    const bool keep = e < kBig;
    const unsigned m = __ballot_sync(kFull, keep);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int pos = count, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (keep) keys[pos + __popc(m & below)] = order_key(e, c);
    count += total;
    __syncthreads();
  }
  const int p = pow2_at_least(count);
  for (int j = count + tid; j < p; j += kThreads) keys[j] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int a = tid; a < p; a += kThreads) {
        const int b = a ^ j;
        if (b > a) {
          const unsigned long long x = keys[a], y = keys[b];
          if ((x > y) == ((a & k) == 0)) {
            keys[a] = y;
            keys[b] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  return count;
}

// K5 closest: the block holds one tile, kClosestRays of it a warp (group g
// = blockIdx.x * kClosestWarps + warp), which walks the tile's sorted list.
__global__ void __launch_bounds__(kClosestThreads)
closest_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax,
                    const float* __restrict__ cmin,
                    const float* __restrict__ cmax,
                    const int* __restrict__ tri_begin,
                    const float* __restrict__ blocks,
                    const int* __restrict__ tri_count, int c_total, int cull,
                    float* __restrict__ out_t, int* __restrict__ out_tri,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int* __restrict__ out_rounds) {
  extern __shared__ __align__(16) unsigned long long keys[];
  __shared__ float red[kClosestWarps];
  __shared__ int wcount[kClosestWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kClosestWarps + warp;
  const size_t i = static_cast<size_t>(g) * kClosestRays + lane % kClosestRays;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i), tmx = __ldg(tmax + i);
  const int count =
      tile_order<kClosestThreads>(block_hull<kClosestThreads>(r, tmn, tmx,
                                                              red),
                                  cmin, cmax, c_total, keys, wcount);
  float* buf = nullptr;  // the slots are read in place
  const GroupHit h = closest_group_walk<kClosestRays, false>(
      r, tmn, tmx, count, cull, 1, blocks, tri_count, buf, lane,
      [&](int pos, float& te, int& cid, int& base) {
        const unsigned long long key = keys[pos];
        te = key_entry(key);
        cid = key_id(key);
        base = __ldg(tri_begin + cid);
      });
  if (lane < kClosestRays) {
    out_t[i] = h.t;
    out_tri[i] = h.id;
    out_u[i] = h.u;
    out_v[i] = h.v;
  }
  if (out_rounds != nullptr && lane == 0) {
    out_rounds[2 * g] = h.rounds;
    out_rounds[2 * g + 1] = h.slots;
  }
}

__global__ void __launch_bounds__(kTile)
any_tile_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin, const float* __restrict__ tmax,
                const float* __restrict__ cmin, const float* __restrict__ cmax,
                const float* __restrict__ blocks,
                const int* __restrict__ tri_count, int c_total, int tri_k,
                int* __restrict__ out_occ) {
  extern __shared__ __align__(16) float smem_a[];
  const int kq = (tri_k + 3) >> 2, ks = 4 * kq;
  float* stage = smem_a;  // 2 x 9 x ks floats, then the keys
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(stage + 2 * kTriRows * ks);
  __shared__ float red[kTile / 32];
  __shared__ int wcount[kTile / 32];
  const int tid = threadIdx.x;
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + tid;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i), tmx = __ldg(tmax + i);
  const int count = tile_order<kTile>(block_hull<kTile>(r, tmn, tmx, red),
                                      cmin, cmax, c_total, keys, wcount);

  bool occ = false;
  const bool dead = tmx < tmn;
  if (count > 0)
    stage_slots(stage, blocks, key_id(keys[0]), kq, kq);
  commit();
  for (int rnd = 0;; ++rnd) {
    wait_all();  // this round's copies have landed; the barrier
    // publishes them, and every thread is past its reads of the other buffer
    if (__syncthreads_and(occ || dead) || rnd >= count) break;
    if (rnd + 1 < count)
      stage_slots(stage + ((rnd + 1) & 1) * kTriRows * ks, blocks,
                  key_id(keys[rnd + 1]), kq, kq);
    commit();
    const int cnt = __ldg(tri_count + key_id(keys[rnd]));
    if (!occ && tmx > tmn)
      occ = any_in_slots<false>(r, stage + (rnd & 1) * kTriRows * ks, ks, cnt,
                                tmn, tmx);
  }
  out_occ[i] = occ ? 1 : 0;
}

// Opt a kernel into `bytes` of dynamic shared memory where that exceeds the
// default 48 KB; returns the CUDA error (0 on success).
template <typename Kernel>
int allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

// Plain C interface, loaded with ctypes. All pointers are device pointers to
// contiguous arrays; each launch goes on `stream` and the function returns
// the cudaGetLastError() after it (0 on success).

// K4, the whole walk. o/d (nt, r, 3), tmin/tmax (nt, r) float32; entries
// (nt, n_cols) float32 and ids (nt, n_cols) int32, each tile's visit order
// (ascending entries, 1e30 past its reach); blocks (C, 16, 128) float32;
// tri_begin and tri_count (C,) int32; r a multiple of 32 up to 256,
// n_cols >= 1, tri_count <= tri_k <= 128. Outputs (nt, r): t, u, v float32
// and tri int32 (t 1e30, tri -1, u = v = 0 on a miss); rounds (nt,) int32,
// each tile's visits.
extern "C" int tile_round_walk(const float* o, const float* d,
                               const float* tmin, const float* tmax,
                               const float* entries, const int* ids,
                               const float* blocks, const int* tri_begin,
                               const int* tri_count, int nt, int r,
                               int n_cols, int tri_k, int cull,
                               float* out_t, int* out_tri, float* out_u,
                               float* out_v, int* out_rounds, void* stream) {
  const size_t smem = sizeof(float) * 2 * kTriRows * 4 * ((tri_k + 3) / 4);
  round_walk_kernel<<<nt, r, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, entries, ids, blocks, tri_begin, tri_count, n_cols,
      tri_k, cull, out_t, out_tri, out_u, out_v, out_rounds);
  return static_cast<int>(cudaGetLastError());
}

// K4 alone. o/d (nt, r, 3), tmin/tmax_eff (nt, r) float32; cid (nt,) int32;
// run (nt,) bool; blocks (C, 16, 128) float32; tri_count (C,) int32 as for
// the walk; 1 <= r <= 256, tri_count <= tri_k <= 128. Outputs (nt, r): t,
// u, v, dn float32 and slot int32 (t 1e30, u = v = 0, dn 1, slot 128 on a
// miss).
extern "C" int tile_round(const float* o, const float* d, const float* tmin,
                          const float* tmax_eff, const int* cid,
                          const unsigned char* run, const float* blocks,
                          const int* tri_count, int nt, int r, int tri_k,
                          int cull, float* out_t, float* out_u, float* out_v,
                          float* out_dn, int* out_slot, void* stream) {
  const size_t smem = sizeof(float) * kTriRows * 4 * ((tri_k + 3) / 4);
  round_kernel<<<nt, r, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax_eff, cid, run, blocks, tri_count, tri_k, cull, out_t,
      out_u, out_v, out_dn, out_slot);
  return static_cast<int>(cudaGetLastError());
}

// K5. o/d (n, 3), tmin/tmax (n,) float32 with n a multiple of 128; cmin/cmax
// (C, 3) float32; tri_begin and tri_count (C,) int32 as for K4; blocks
// (C, 16, 128) float32; C at most 16,384. Outputs (n,): t, tri, u, v;
// out_rounds int32 or null: per group ((n / tile_walk_group_rays(), 2)) the
// positions it walked and the slots its rays tested, summed over the rays.
extern "C" int tile_walk_group_rays() { return kClosestRays; }

extern "C" int tile_walk_closest(const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const float* cmin, const float* cmax,
                                 const int* tri_begin, const float* blocks,
                                 const int* tri_count, int n, int c_total,
                                 int cull, float* out_t, int* out_tri,
                                 float* out_u, float* out_v, int* out_rounds,
                                 void* stream) {
  const size_t smem = sizeof(unsigned long long) * pow2_at_least(c_total);
  const int err = allow_shared(closest_walk_kernel, smem);
  if (err) return err;
  closest_walk_kernel<<<n / kTile, kClosestThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, tri_begin, blocks, tri_count, c_total,
      cull, out_t, out_tri, out_u, out_v, out_rounds);
  return static_cast<int>(cudaGetLastError());
}

// K5 any: the same rays and boxes; tri_count as for K4; tri_count <= tri_k
// <= 128. Output (n,): occ int32.
extern "C" int tile_walk_any(const float* o, const float* d,
                             const float* tmin, const float* tmax,
                             const float* cmin, const float* cmax,
                             const float* blocks, const int* tri_count, int n,
                             int c_total, int tri_k, int* out_occ,
                             void* stream) {
  const size_t smem = sizeof(float) * 2 * kTriRows * 4 * ((tri_k + 3) / 4) +
                      sizeof(unsigned long long) * pow2_at_least(c_total);
  const int err = allow_shared(any_tile_kernel, smem);
  if (err) return err;
  any_tile_kernel<<<n / kTile, kTile, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, blocks, tri_count, c_total, tri_k,
      out_occ);
  return static_cast<int>(cudaGetLastError());
}

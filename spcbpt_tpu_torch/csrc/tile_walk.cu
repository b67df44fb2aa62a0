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
//   tile_round_walk: the whole walk of a tile in one block (or a cluster
//     of blocks, below), one thread per ray, tiles independent (the host
//     loop's lock step over tiles changes no tile's result), so a walk is
//     one launch with no host sync. The
//     tile's column of the visit order (entries, ids and the clusters'
//     triangle counts, sorted near to far by ops/tile_trace._prepare) is
//     read a block-width of rounds at a time into shared memory. Each
//     round: the exact block max of min(best_t, tmax) (warp shuffles, one
//     shared step, one barrier) decides the stop; the
//     cluster is staged and tested as in tile_round (stage_slots,
//     closest_in_stage), the next round's cluster in flight with cp.async
//     while this one is tested (its id is known: the order is fixed); a
//     second barrier makes the stage visible. The hit (t, tri, u, v) is
//     written once, and the tile's round count beside it. Measured on the
//     card and not kept (tile_walk_variants.py): one buffer filled after
//     the round's bound is known, and no staging (the slots read from L2).
//   Tiles of up to 1,024 rays (JAX's tile_closest takes any tile; its
//     bench runs 1,024). A tile is one block on one SM, one thread a ray,
//     up to 256 rays; a tile of 512 or 1,024 rays is a thread block
//     cluster of kCtas = 2 or 4 CTAs of up to 256 threads, each on its own
//     SM with its share of the rays (tile_round_walk_ctas): at 1,024 rays
//     the tiles are fewer than the SMs, and one SM walking a whole tile
//     (its longest walk 1,370 rounds of 1,024 rays on bounce rays) set the
//     time. The CTAs walk the same visit order; each round the tile's
//     bound is the largest of the CTAs' block maxima, read through
//     distributed shared memory after one cluster barrier, so every CTA
//     takes the same stop and every ray's hit is the plain walk's. The
//     kCtas = 1 instance, which every tile-mode trace runs, is the kernel
//     as it was. Measured on the card and not kept (tile_walk_variants.py):
//     the first form of tiles above 256 (one thread a ray in blocks of 512
//     and 1,024: the 1,024 instance capped at 64 registers, spilling, one
//     block an SM; wide_blocks), and 1 block of 256 threads with 2 or 4
//     rays a thread (2 blocks an SM at 114 registers, no spill, but a tile
//     still on one SM, and slower; rays, with and without a ray skipping
//     clusters past its own bound). The block reductions need whole warps:
//     ops/tile_trace pads a tile to a multiple of 32 kCtas rays with lanes
//     whose tmax is -inf. The single round stays a template on its block
//     (256, 512, 1,024).
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "group_walk.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kTiny = 1e-12f;   // |direction| floor of the slab test
constexpr int kTile = 128;        // rays per tile of the fused walk
constexpr int kRoundLanes = 256;      // rays per tile of the tile mode
constexpr int kMaxRoundLanes = 1024;  // rays per tile of K4: a block's limit
constexpr int kAnyStages = 4;     // clusters staged ahead + 1, K5 any
constexpr int kAnyPartClusters = 256;  // clusters a part of K5 any
constexpr int kAnyMaxParts = 64;       // parts a tile of K5 any, at most
constexpr int kAnyCompactRounds = 8;   // K5 any packs its rays this often
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

// Waits until at most n of this thread's cp.async commit groups are in
// flight.
template <int n>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

// ---------------------------------------------------------------------------
// K4: the round walk, one block per tile
// ---------------------------------------------------------------------------

template <int kCtas>
__global__ void __launch_bounds__(kRoundLanes)
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
  __shared__ float se[kRoundLanes];  // a block-width of rounds of the order
  __shared__ int sc[kRoundLanes];
  __shared__ int sk[kRoundLanes];    // their clusters' triangle counts
  __shared__ float red[kRoundLanes / 32];
  __shared__ float cbound[2];        // this CTA's bound, by round parity
  const int lanes = blockDim.x, tid = threadIdx.x, nw = lanes >> 5;
  const int kq = (tri_k + 3) >> 2, ks = 4 * kq;
  // CTA `part` of the tile's kCtas (a thread block cluster) takes its rays
  // part * lanes ... part * lanes + lanes - 1
  const size_t tile = blockIdx.x / kCtas;
  const int part = blockIdx.x % kCtas;
  const size_t i = (tile * kCtas + part) * lanes + tid;
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
    if (j == 0) {  // the next `lanes` rounds' clusters; the last ones read
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
    if constexpr (kCtas > 1) {
      // the tile's bound: the largest of its CTAs', read through
      // distributed shared memory after one cluster barrier; a parity's
      // slot is written again two rounds on, past the next barrier, when
      // every CTA has read it
      cg::cluster_group cluster = cg::this_cluster();
      if (tid == 0) cbound[rnd & 1] = bound;
      cluster.sync();
#pragma unroll
      for (int p = 0; p < kCtas; ++p)
        bound = fmaxf(bound, *cluster.map_shared_rank(&cbound[rnd & 1], p));
    }
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
  if constexpr (kCtas > 1)
    cg::this_cluster().sync();  // no CTA leaves while another may read it
  out_t[i] = best_t;
  out_tri[i] = best_id;
  out_u[i] = best_u;
  out_v[i] = best_v;
  if (tid == 0 && part == 0) out_rounds[tile] = rnd;
}

// ---------------------------------------------------------------------------
// K4 alone: one round
// ---------------------------------------------------------------------------

template <int kLanes>
__global__ void __launch_bounds__(kLanes)
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
// K5 closest takes one 128-ray tile a block, K5 any one a tile and part of
// the set; both begin with the tile's hull (block_hull:
// tile_trace.tile_entries' bounds). K5 closest then runs
// one prologue (tile_order): it tests all C boxes a block-width at a step,
// compacts those in reach into one candidate list (ballot, then a prefix
// over the warps' counts), and sorts it near to far once by (entry, id) (a
// bitonic sort of 64-bit keys in shared memory), and walks the list. K5
// any streams the set instead (below).
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
//     kernel's bound is taken from; and each ray the tile's entry into the
//     cluster of its hit (out_entry), by which ops/pallas_tile breaks equal
//     t between parts as the whole set's walk does: the earlier cluster of
//     the (entry, id) order.
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
//     memory. A larger set is walked in parts of at most that many
//     clusters, one launch a part (ops/pallas_tile).
//
// Any hit. Occlusion is per lane and does not depend on the visit order: a
// lane is occluded where a cluster its tile's entry bounds keep holds a hit
// in its interval, and a tile stops only once each of its lanes is occluded
// or dead. So any order of the clusters in reach, split in any way, returns
// pallas_any_plain's flags bit for bit. The walk keeps no list: a block
// takes the set in id (BVH) order a block-width of clusters at a time,
// tests their boxes against the tile's hull, compacts those it keeps into
// a shared queue of ids and entries (next_chunk), and walks them, one
// thread a ray. Its shared memory is a ring of kAnyStages staged
// clusters, the queue and the packed rays (10.3 KB at tri_k 32) whatever C
// is, so the set has no ceiling. What sets the time is the longest walk:
// on the scale-14 interior's connection rays the tiles whose directions
// straddle an axis reach every one of the 17,197 clusters, one round after
// another (~3 us a round). So:
//   * The tile entry e of a cluster bounds below the t of every hit of
//     the tile's lanes in it (the premise of the closest walks' stop): a
//     lane tests a cluster only where e lies below its own tmax, and a
//     chunk keeps only clusters whose e lies below the largest tmax of the
//     lanes still looking (chunk_bound). Neither drops a hit.
//   * A set above kAnyPartClusters is split over up to kAnyMaxParts blocks
//     a tile (any_parts), part p streaming the chunks p, p + P, ...: a
//     lane's hit is stored in the zeroed output at once, and each packing
//     reads the flags back, so a lane one part occludes is no longer
//     tested by the others; the flags are the OR of the parts' exact tests.
//   * The rays still looking are packed into the block's first threads at
//     each chunk scan and every kAnyCompactRounds rounds (compact), so
//     that the warps of rays that are done fall idle instead of waiting
//     on one lane; a ray's tests do not depend on its thread.
//   * The kept clusters' slots below tri_count are staged with cp.async
//     kAnyStages - 1 rounds ahead into the ring, and each round's one
//     barrier both publishes its stage and decides the stop (every ray
//     occluded, dead or packed out).
// Optionally (out_rounds) each tile's parts add the clusters they visited
// and the slots their rays tested: the work the kernel's bound is taken
// from. Measured on the card and not kept (tile_walk_variants.py rebuilds
// each form from this source): the first form (a block-wide next-cluster
// reduction over all C entries every round, all 128 slots staged); the
// sorted form of PRs 7-17 (tile_order's near-to-far list of (entry, id)
// keys, 8 bytes a cluster padded to a power of two, in shared memory: 16
// KB a block at 1,370 clusters, 128 KB at 8,599, and a ceiling of 16,384
// clusters); the stream without the cuts by e, in one part, with one
// cluster staged ahead, with no packing or packing at chunk scans only
// (any_unpruned, any_one_part, any_stages2, any_no_compact,
// any_compact_chunks); and one warp per 32 rays with its own hull,
// streaming the set 32 clusters a ballot, the slots read from L2, with no
// block barrier (any_warp).

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
// = blockIdx.x * kClosestWarps + warp), which walks the tile's sorted list;
// with kEntry it also writes each ray's entry into its hit's cluster.
template <bool kEntry>
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
                    int* __restrict__ out_rounds,
                    float* __restrict__ out_entry) {
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
  const GroupHit h = closest_group_walk<kClosestRays, false, kEntry>(
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
    if (kEntry) out_entry[i] = h.e;
  }
  if (out_rounds != nullptr && lane == 0) {
    out_rounds[2 * g] = h.rounds;
    out_rounds[2 * g + 1] = h.slots;
  }
}

// The next chunk of K5 any's stream, called by every thread of a block of
// kThreads: the clusters [base, base + kThreads), then the chunks `stride`
// clusters on while none of a chunk is kept, until one is or the set ends.
// A cluster is kept where its entry from the hull h lies below `bound` (so
// in reach); its id and entry go to queue / qe[0, count) in id order (a
// ballot, then a prefix over the warps' counts); base moves past the
// chunks scanned. Returns count (0 at the set's end). wcount: kThreads / 32
// ints. Ends with a barrier, so the queue is visible to the block.
template <int kThreads>
__device__ __forceinline__ int next_chunk(const Hull& h,
                                          const float* __restrict__ cmin,
                                          const float* __restrict__ cmax,
                                          int c_total, int stride, float bound,
                                          int& base, int* queue, float* qe,
                                          int* wcount) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int total = 0;
  while (total == 0 && base < c_total) {
    const int c = base + tid;
    const float e = c < c_total ? hull_entry(h, cmin, cmax, c) : kBig;
    const bool keep = e < bound;
    const unsigned m = __ballot_sync(kFull, keep);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int pos = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (keep) {
      pos += __popc(m & ((1u << lane) - 1u));
      queue[pos] = c;
      qe[pos] = e;
    }
    base += stride;
    __syncthreads();  // the queue is written; wcount is free again
  }
  return total;
}

// The bound of K5 any's chunks: the largest tmax of the block's lanes that
// still look for a hit; -1e30 once none does.
__device__ __forceinline__ float chunk_bound(bool looking, float tmx,
                                             float* red) {
  return block_max<kTile>(looking ? tmx : -kBig, red);
}

// The parts of K5 any's walk over a set of c_total clusters: one up to
// kAnyPartClusters, then one more a kAnyPartClusters, at most kAnyMaxParts.
__host__ __device__ __forceinline__ int any_parts(int c_total) {
  const int p = (c_total + kAnyPartClusters - 1) / kAnyPartClusters;
  return p < 1 ? 1 : p > kAnyMaxParts ? kAnyMaxParts : p;
}

// K5 any: a block per 128-ray tile and part of the set, one thread a ray
// (the rays still looking packed into the first threads: compact). Part p
// of P streams the chunks p, p + P, p + 2P, ... of the set (a block-width
// of clusters each, in id order: next_chunk); the kept clusters are staged
// kAnyStages - 1 rounds ahead into a ring of kAnyStages buffers (their ids
// and entries beside them), and each round's one barrier both publishes
// its stage and decides the stop. A ray's hit is stored at once in out_occ
// (zero before the launch), and each packing first reads the flags there,
// so that the occlusion one part finds stops the others testing the ray.
__global__ void __launch_bounds__(kTile)
any_tile_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin, const float* __restrict__ tmax,
                const float* __restrict__ cmin, const float* __restrict__ cmax,
                const float* __restrict__ blocks,
                const int* __restrict__ tri_count, int c_total, int tri_k,
                int* __restrict__ out_occ, int* __restrict__ out_rounds) {
  extern __shared__ __align__(16) float stage[];  // kAnyStages x 9 x ks
  __shared__ int queue[kTile];
  __shared__ float qe[kTile];
  __shared__ int ring_id[kAnyStages];
  __shared__ float ring_e[kAnyStages];
  __shared__ float red[kTile / 32];
  __shared__ int wcount[kTile / 32];
  __shared__ float pk[8][kTile];  // the rays still looking, packed
  __shared__ int pidx[kTile];
  const int kq = (tri_k + 3) >> 2, ks = 4 * kq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int parts = any_parts(c_total);
  const int tile = blockIdx.x / parts, part = blockIdx.x % parts;
  int idx = tile * kTile + tid;  // the ray this thread holds
  Ray r = load_ray(o, d, idx);
  float tmn = __ldg(tmin + idx), tmx = __ldg(tmax + idx);
  const Hull h = block_hull<kTile>(r, tmn, tmx, red);

  bool holds = true, occ = false;
  int base = part * kTile, count = 0, at = 0, staged = 0, slots = 0, rnd = 0;
  // takes in the other parts' finds, then moves the rays still looking
  // (held, not occluded, tmax above tmin) to the block's first threads, in
  // order, so that the warps of rays that are done fall idle; the threads
  // past them hold no ray. A ray's tests do not depend on its thread.
  auto compact = [&]() {
    occ = occ || (holds && *(volatile int*)(out_occ + idx) != 0);
    const bool looking = holds && !occ && tmx > tmn;
    const unsigned m = __ballot_sync(kFull, looking);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int pos = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) {
      pos += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (looking) {
      pos += __popc(m & ((1u << lane) - 1u));
      pk[0][pos] = r.ox;
      pk[1][pos] = r.oy;
      pk[2][pos] = r.oz;
      pk[3][pos] = r.dx;
      pk[4][pos] = r.dy;
      pk[5][pos] = r.dz;
      pk[6][pos] = tmn;
      pk[7][pos] = tmx;
      pidx[pos] = idx;
    }
    __syncthreads();
    holds = tid < total;
    occ = false;
    if (holds) {
      r = Ray{pk[0][tid], pk[1][tid], pk[2][tid],
              pk[3][tid], pk[4][tid], pk[5][tid]};
      tmn = pk[6][tid];
      tmx = pk[7][tid];
      idx = pidx[tid];
    }
  };
  // stages the next kept cluster into ring slot staged % kAnyStages (its
  // copies one commit group, empty at the set's end); called by every
  // thread, so a chunk scan (barriers) is uniform. The queue is read only
  // here, and next_chunk rewrites it after a barrier.
  auto fetch = [&]() {
    if (at == count && base < c_total) {
      compact();
      count = next_chunk<kTile>(
          h, cmin, cmax, c_total, parts * kTile,
          chunk_bound(holds && !occ && tmx > tmn, tmx, red), base, queue,
          qe, wcount);
      at = 0;
    }
    if (at < count) {
      const int c = queue[at];
      const int slot = staged % kAnyStages;
      if (tid == 0) {
        ring_id[slot] = c;
        ring_e[slot] = qe[at];
      }
      stage_slots(stage + slot * kTriRows * ks, blocks, c,
                  (__ldg(tri_count + c) + 3) >> 2, kq);
      ++at;
      ++staged;
    }
    commit();
  };
#pragma unroll
  for (int k = 0; k < kAnyStages - 1; ++k) fetch();
  for (;; ++rnd) {
    // round rnd's copies (commit group rnd) have landed; the barrier
    // publishes them, and every thread is past its reads of the slot the
    // fetch below refills (round rnd - 1's)
    wait_groups<kAnyStages - 2>();
    if (__syncthreads_and(!holds || occ || tmx < tmn) || rnd == staged)
      break;
    if (rnd % kAnyCompactRounds == kAnyCompactRounds - 1) compact();
    fetch();
    const int slot = rnd % kAnyStages;
    const float e = ring_e[slot];
    // a lane tests the cluster only where its tile entry e lies below the
    // lane's tmax: e bounds below the t of every hit of the tile's lanes in
    // it (the premise of the closest walks' stop), so no hit past it
    // passes t < tmax
    if (holds && !occ && tmx > tmn && e < tmx) {
      const int cnt = __ldg(tri_count + ring_id[slot]);
      occ = any_in_slots<false>(r, stage + slot * kTriRows * ks, ks, cnt,
                                tmn, tmx);
      if (occ) out_occ[idx] = 1;
      slots += cnt;
    }
  }
  wait_all();  // copies still in flight after the stop
  if (out_rounds != nullptr) {  // uniform over the block
    slots = __reduce_add_sync(kFull, slots);
    if ((tid & 31) == 0) wcount[tid >> 5] = slots;
    __syncthreads();
    if (tid == 0) {
      int sum = 0;
      for (int w = 0; w < kTile / 32; ++w) sum += wcount[w];
      atomicAdd(out_rounds + 2 * tile, rnd);
      atomicAdd(out_rounds + 2 * tile + 1, sum);
    }
  }
}

// Launches the instance of K4's single round (a template on its block size)
// that takes a tile of r rays: the least of 256, 512 and 1,024 at or above
// r.
template <typename Launch>
void by_round_lanes(int r, Launch launch) {
  if (r <= kRoundLanes)
    launch(std::integral_constant<int, kRoundLanes>());
  else if (r <= 2 * kRoundLanes)
    launch(std::integral_constant<int, 2 * kRoundLanes>());
  else
    launch(std::integral_constant<int, kMaxRoundLanes>());
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

// The CTAs (a thread block cluster) of K4's walk for a tile of r rays: 1 up
// to 256, 2 up to 512, 4 above.
extern "C" int tile_round_walk_ctas(int r) {
  return r <= kRoundLanes ? 1 : r <= 2 * kRoundLanes ? 2 : 4;
}

// K4, the whole walk. o/d (nt, r, 3), tmin/tmax (nt, r) float32; entries
// (nt, n_cols) float32 and ids (nt, n_cols) int32, each tile's visit order
// (ascending entries, 1e30 past its reach); blocks (C, 16, 128) float32;
// tri_begin and tri_count (C,) int32; r up to 1,024 and a multiple of 32
// CTAs (tile_round_walk_ctas(r)), n_cols >= 1, tri_count <= tri_k <= 128.
// Outputs (nt, r): t, u, v float32 and tri int32 (t 1e30, tri -1, u = v =
// 0 on a miss); rounds (nt,) int32, each tile's visits.
extern "C" int tile_round_walk(const float* o, const float* d,
                               const float* tmin, const float* tmax,
                               const float* entries, const int* ids,
                               const float* blocks, const int* tri_begin,
                               const int* tri_count, int nt, int r,
                               int n_cols, int tri_k, int cull,
                               float* out_t, int* out_tri, float* out_u,
                               float* out_v, int* out_rounds, void* stream) {
  const size_t smem = sizeof(float) * 2 * kTriRows * 4 * ((tri_k + 3) / 4);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ctas = tile_round_walk_ctas(r);
  if (ctas == 1) {  // the kernel as it was: a block a tile, no cluster
    round_walk_kernel<1><<<nt, r, smem, st>>>(
        o, d, tmin, tmax, entries, ids, blocks, tri_begin, tri_count, n_cols,
        tri_k, cull, out_t, out_tri, out_u, out_v, out_rounds);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt * ctas);
  cfg.blockDim = dim3(r / ctas);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      ctas == 2
          ? cudaLaunchKernelEx(&cfg, round_walk_kernel<2>, o, d, tmin, tmax,
                               entries, ids, blocks, tri_begin, tri_count,
                               n_cols, tri_k, cull, out_t, out_tri, out_u,
                               out_v, out_rounds)
          : cudaLaunchKernelEx(&cfg, round_walk_kernel<4>, o, d, tmin, tmax,
                               entries, ids, blocks, tri_begin, tri_count,
                               n_cols, tri_k, cull, out_t, out_tri, out_u,
                               out_v, out_rounds);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K4 alone. o/d (nt, r, 3), tmin/tmax_eff (nt, r) float32; cid (nt,) int32;
// run (nt,) bool; blocks (C, 16, 128) float32; tri_count (C,) int32 as for
// the walk; 1 <= r <= 1,024, tri_count <= tri_k <= 128. Outputs (nt, r): t,
// u, v, dn float32 and slot int32 (t 1e30, u = v = 0, dn 1, slot 128 on a
// miss).
extern "C" int tile_round(const float* o, const float* d, const float* tmin,
                          const float* tmax_eff, const int* cid,
                          const unsigned char* run, const float* blocks,
                          const int* tri_count, int nt, int r, int tri_k,
                          int cull, float* out_t, float* out_u, float* out_v,
                          float* out_dn, int* out_slot, void* stream) {
  const size_t smem = sizeof(float) * kTriRows * 4 * ((tri_k + 3) / 4);
  by_round_lanes(r, [&](auto lanes) {
    round_kernel<decltype(lanes)::value>
        <<<nt, r, smem, static_cast<cudaStream_t>(stream)>>>(
            o, d, tmin, tmax_eff, cid, run, blocks, tri_count, tri_k, cull,
            out_t, out_u, out_v, out_dn, out_slot);
  });
  return static_cast<int>(cudaGetLastError());
}

// K5. o/d (n, 3), tmin/tmax (n,) float32 with n a multiple of 128; cmin/cmax
// (C, 3) float32; tri_begin and tri_count (C,) int32 as for K4; blocks
// (C, 16, 128) float32; for K5 closest C at most 16,384 (a larger set goes
// in parts, one launch each). Outputs (n,): t, tri, u, v;
// out_rounds int32 or null: per group ((n / tile_walk_group_rays(), 2)) the
// positions it walked and the slots its rays tested, summed over the rays;
// out_entry float32 or null: (n,) the tile's entry bound into the cluster
// that holds each ray's hit (1e30 on a miss).
extern "C" int tile_walk_group_rays() { return kClosestRays; }

extern "C" int tile_walk_closest(const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const float* cmin, const float* cmax,
                                 const int* tri_begin, const float* blocks,
                                 const int* tri_count, int n, int c_total,
                                 int cull, float* out_t, int* out_tri,
                                 float* out_u, float* out_v, int* out_rounds,
                                 float* out_entry, void* stream) {
  const size_t smem = sizeof(unsigned long long) * pow2_at_least(c_total);
  auto launch = [&](auto kernel) {
    const int err = allow_shared(kernel, smem);
    if (err) return err;
    kernel<<<n / kTile, kClosestThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        o, d, tmin, tmax, cmin, cmax, tri_begin, blocks, tri_count, c_total,
        cull, out_t, out_tri, out_u, out_v, out_rounds, out_entry);
    return static_cast<int>(cudaGetLastError());
  };
  return out_entry != nullptr ? launch(closest_walk_kernel<true>)
                              : launch(closest_walk_kernel<false>);
}

// K5 any: the same rays and boxes, any C; tri_count as for K4; tri_count
// <= tri_k <= 128. Output (n,): occ int32, zero before the call;
// out_rounds int32 or null, zero before the call: per tile ((n / 128, 2))
// the clusters its parts visited and the slots its rays tested, summed.
extern "C" int tile_walk_any_parts(int c_total) { return any_parts(c_total); }

extern "C" int tile_walk_any(const float* o, const float* d,
                             const float* tmin, const float* tmax,
                             const float* cmin, const float* cmax,
                             const float* blocks, const int* tri_count, int n,
                             int c_total, int tri_k, int* out_occ,
                             int* out_rounds, void* stream) {
  const size_t smem =
      sizeof(float) * kAnyStages * kTriRows * 4 * ((tri_k + 3) / 4);
  any_tile_kernel<<<n / kTile * any_parts(c_total), kTile, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, blocks, tri_count, c_total, tri_k,
      out_occ, out_rounds);
  return static_cast<int>(cudaGetLastError());
}

// List-walk ray traversal for Hopper (sm_90a): ray tiles over their
// presorted near-to-far cluster lists, closest hit and any hit, each in a
// resident and a streamed form.
//
// Replaces the Pallas TPU kernels of spcbpt_tpu/ops/pallas_walk.py:
//   list_walk_closest         <- _closest_kernel_vmem (pallas_walk.py:156)
//   list_walk_closest_stream  <- _closest_kernel      (pallas_walk.py:97)
//   list_walk_any             <- _any_kernel_vmem     (pallas_walk.py:207)
//   list_walk_any_stream      <- _any_kernel          (pallas_walk.py:235)
// and computes what they compute, lane for lane: Moller-Trumbore of every
// lane against the triangles of the cluster's block in the operation order
// of `_mt_rows` (built with --fmad=false and IEEE division, so t/u/v round
// like the plain torch versions of ops/pallas_walk.py), the minimum t with
// the smallest slot on ties and improvement on strict <, and the stop rules:
// closest stops when the next entry exceeds the largest min(best_t, tmax) of
// the lanes that walk together (unless prune is off), any hit when it
// exceeds the largest tmax of their unoccluded lanes (-1e30 for an occluded
// lane).
//
// The walk list (count, ids, bases, entries) is built outside the kernel
// (ops/pallas_walk._prepare) and read uniformly by the lanes that walk it.
// Triangles come as the JAX package's (C, 16, 128) float blocks: rows 0..8
// hold p0, e1, e2 (x, y, z) per slot, the rest zero; a zero slot has
// det = 0 and never hits.
//
// The closest forms. What bounded them in their first form (one block per
// tile walking in lock step): the chain of rounds. A tile ended every round
// in a block-wide max and barriers, so each warp walked as many rounds as
// the tile's farthest lane needed, and a lane that escapes the scene kept
// the tile's bound at its tmax: the tile then walked its whole list. Each
// thread tested all 128 slots of each cluster in series (the K=32 set has
// 23.8 triangles a cluster), with 256 threads a tile and 512 tiles for 2^17
// rays: few warps, long chains. What bounds them now: the ray-triangle tests
// themselves (the groups make most of the plain walk's), and the chain of
// the group that walks longest (a group holding a ray that escapes the
// scene still walks its whole list). The design:
//   * Groups of kRays rays that walk and stop on their own, one warp each.
//     A group walks its tile's own list in the tile's order, tests every
//     cluster of it up to its stop, and stops when the next entry exceeds
//     the warp max of min(best_t, tmax) over its rays (shuffles; no barrier
//     of any kind in the loop, blocks of kGroupWarps independent warps). A
//     ray's slots are spread over kSplit = 32 / kRays threads, slot k on
//     thread k % kSplit, so that neighbouring threads read neighbouring
//     slots of a (16, 128) row. Eight rays and four threads a ray, measured
//     against 1, 2, 4, 16 and 32 rays (list_walk_variants.py at the root of
//     the repository rebuilds each; PERF.md has the times): smaller groups
//     stop sooner and test fewer pairs, but read every slot for fewer rays,
//     and shorter chains do not make up for it.
//   * Each thread keeps the (t, slot)-smallest hit of its slots under the
//     round's min(best_t, tmax) (a slot whose det fails leaves its test at
//     once; a branch-free test was slower); xor shuffles over the kSplit
//     threads keep the smallest t, the smallest slot on ties, and its u, v:
//     the serial loop's "strict <, smallest slot first"; then best improves
//     on strict <.
//   * The slot loop stops at the cluster's triangle count (tri_count); the
//     slots past it are zero and never hit, so no bit changes.
//   * Why a group's result equals its tile's, bit for bit. Along the shared
//     order a group's bound is never above its tile's bound at the same
//     round, so it stops at a round R_g no later than the tile's R_tile.
//     For any round r in [R_g, R_tile) and any lane of the group, entries[r]
//     >= entries[R_g] > min(best_t, tmax) of that lane (the list is sorted),
//     and the entry is a lower bound on the hit t of every lane of the tile
//     in that cluster (tile_trace.tile_entries, the property the pruned
//     plain walk rests on), so no hit in those rounds passes t < tmax_eff.
//     Ties between clusters at equal t go to the earlier cluster of the same
//     list in both walks. The same argument lets a group test its bound
//     before round 0, where the tile walk does not: a group of dead lanes
//     walks nothing. Before its stop a group skips no cluster: an entry of
//     the group's own is a lower bound on its hits only up to rounding (a
//     one-ray group that skipped the clusters its own entry did not reach
//     parted from the plain walk on a hit 2 ulps below that entry), and
//     Moller-Trumbore's t has no forward error bound that would give a
//     proven margin, since it grows without limit as det falls to its
//     floor.
//   * Chunks, so that a round waits on no load of its list: the group loads
//     its list 32 positions at a time, lane j position p0 + j (id, count,
//     base, entry), and round r takes its position from lane r - p0 by
//     shuffles.
//   * The resident form reads a cluster's slots in place (the whole table,
//     1,370 or 368 x 8 KB at the interior, sits in the 50 MB L2); the
//     streamed form stages the cluster's first tri_count slots of rows 0..8
//     into a per-warp double buffer with cp.async, the next position in
//     flight while one is tested, published with __syncwarp.
//   * Optionally, each group writes the rounds it walked and the slots its
//     rays tested, summed over the rays: kRays times the slots of the
//     clusters it walked (out_rounds).
//   The walk itself is closest_group_walk of csrc/group_walk.cuh, which
//   K5 closest (csrc/tile_walk.cu) runs on its own sorted list.
//
// The any forms. What bounded them in their first form (one block per
// tile, one thread a lane, kept in list_walk_variants.py): the tile
// walked in lock step, every round ending in a block-wide max, until its
// next entry exceeded the largest tmax of its unoccluded lanes, so one open
// lane (a ray that escapes the room with tmax 3) kept all 256 walking while
// the occluded ones idled; and each thread tested all 128 slots of every
// cluster in series (88.5 triangles a cluster at K=128, 23.8 at K=32), in
// 512 blocks of 8 warps for 2^17 rays: an any hit cost 2.5x a closest hit
// on the same wavefront. What bounds them now: the tests the rays make
// before their first occluder, and the chain of the group that walks
// longest (a group holding a ray that escapes the room walks while the
// entries stay below its tmax). The design is the closest forms' with what
// an any-hit query changes:
//   * Groups of rays that walk and stop on their own, one warp each, in
//     blocks of kGroupWarps independent warps: kAnyRays rays a group in the
//     resident form, kAnyStreamRays in the streamed one (constants of their
//     own, measured against 1, 2, 4, 8, 16 and 32 rays; list_walk_variants.py
//     rebuilds each and PERF.md has the times: a one-ray group reads a
//     cluster's slots once per ray, from L2 in the resident form, but the
//     streamed form would stage them once per ray). A group walks its
//     tile's list in the tile's order, 32 positions a load (round r
//     shuffles its cluster and count out of lane r - p0), tests every
//     cluster up to its stop, and stops when the next entry exceeds its
//     bound or the list ends: the warp max over its rays of (occluded ?
//     -1e30 : tmax), tested before round 0 and after every round; it
//     continues on entry <= bound, as the plain walk does. Nothing in the
//     walk loop is block-wide: no barrier, no shared reduction.
//   * A ray's slots lie on kAnySplit = 32 / kAnyGroup threads, slot k on
//     thread k % kAnySplit, below the cluster's tri_count only (all 128
//     slots measured slower). A thread leaves its slot loop at its first
//     hit; one ballot a round tells the ray's threads whether one of them
//     hit (a ballot at every step of the slot loop, stopping the ray's
//     threads together, measured slower). An occluded ray, or one whose
//     interval is empty (tmax <= tmin), tests no further slots. The slot
//     test is mt_slot with the t < 1e30 of the plain version's t table.
//   * The streamed form stages a cluster's first tri_count slots of rows
//     0..8 into a per-warp double buffer (round_block), as the streamed
//     closest form does; the last copy is drained when a group stops early.
//   * Optionally, each group writes the positions it walked and the slots
//     its rays tested, summed over the rays (out_rounds).
//   * Why a group's flags equal the plain walk's, bit for bit. A lane's flag
//     is the OR, over the clusters walked, of "some slot hits in (tmin,
//     tmax)"; the order of the walk does not change an OR. A lane's bound
//     term is tmax, or -1e30 once it is occluded; along the shared order a
//     group's lanes are occluded at a round exactly when they are in the
//     tile walk, so the group's bound is never above the tile's at the same
//     round and the group stops at a round no later than the tile does. For
//     every round from the group's stop to the tile's, the entry is at or
//     above the stopping one and so above the tmax of each open lane of the
//     group (the list is sorted), and each tile entry bounds from below the
//     hit t of every lane of the tile in its cluster (tile_trace.
//     tile_entries; the pruned plain walk's own stop rests on the same
//     property): no hit in those rounds passes t < tmax. The same argument
//     lets the group test its bound before round 0. Slots past tri_count
//     are zero (det = 0) and never hit. A ray that stops testing after its
//     first hit changes no OR. No cluster is skipped on a ray's own entry:
//     hits round below it (see the closest forms above).
#include <cuda_runtime.h>

#include "group_walk.cuh"

namespace {

constexpr int kRays = 8;          // rays per closest group, one warp each
constexpr int kAnyRays = 1;       // rays per group of the resident any form
constexpr int kAnyStreamRays = 4;  // rays per group of the streamed any form
constexpr int kGroupWarps = 8;    // groups (warps) per block

// Rays per group of the resident or streamed any form.
__host__ __device__ constexpr int any_rays(bool stream) {
  return stream ? kAnyStreamRays : kAnyRays;
}

// The lanes of ray 0 of a group of `rays`: bits 0, rays, 2 * rays, ...
__host__ __device__ constexpr unsigned ray_lanes(int rays) {
  unsigned m = 0;
  for (int b = 0; b < 32; b += rays) m |= 1u << b;
  return m;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// Closest hit: group g (one warp) holds rays g * kRays ... of its tile and
// walks the tile's list with closest_group_walk (csrc/group_walk.cuh, the
// walk K5 closest runs too).
template <bool kStream>
__global__ void __launch_bounds__(32 * kGroupWarps)
closest_kernel(const int* __restrict__ counts, const int* __restrict__ ids,
               const int* __restrict__ bases,
               const float* __restrict__ entries, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ tmin,
               const float* __restrict__ tmax,
               const float* __restrict__ blocks,
               const int* __restrict__ tri_count, int groups, int tile,
               int c_total, int cull, int prune, float* __restrict__ out_t,
               int* __restrict__ out_tri, float* __restrict__ out_u,
               float* __restrict__ out_v, int* __restrict__ out_rounds) {
  extern __shared__ __align__(16) float stages[];  // streamed: 2 a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kGroupWarps + warp;
  if (g >= groups) return;  // the whole warp
  const int q = lane / kRays;
  const size_t first = static_cast<size_t>(g) * kRays;
  const size_t i = first + lane % kRays;
  const size_t row = first / tile * c_total;
  const int n = __ldg(counts + first / tile);
  const Ray ray = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  float* buf = stages + warp * 2 * kStage;
  const GroupHit h = closest_group_walk<kRays, kStream>(
      ray, tmn, tmx, n, cull, prune, blocks, tri_count, buf, lane,
      [&](int pos, float& te, int& cid, int& base) {
        cid = __ldg(ids + row + pos);
        base = __ldg(bases + row + pos);
        te = __ldg(entries + row + pos);
      });
  if (q == 0) {
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

// Any hit: group g (one warp) holds rays g * kAnyGroup ... of its tile;
// lane = kAnyGroup * q + ray, thread q of its ray tests slots q,
// q + kAnySplit, ... up to its first hit. The list is taken as in
// closest_kernel.
template <bool kStream>
__global__ void __launch_bounds__(32 * kGroupWarps)
any_kernel(const int* __restrict__ counts, const int* __restrict__ ids,
           const float* __restrict__ entries, const float* __restrict__ o,
           const float* __restrict__ d, const float* __restrict__ tmin,
           const float* __restrict__ tmax, const float* __restrict__ blocks,
           const int* __restrict__ tri_count, int groups, int tile,
           int c_total, int* __restrict__ out_occ,
           int* __restrict__ out_rounds) {
  constexpr int kAnyGroup = any_rays(kStream);
  constexpr int kAnySplit = 32 / kAnyGroup;  // threads per ray
  constexpr unsigned kAnyRayLanes = ray_lanes(kAnyGroup);
  extern __shared__ __align__(16) float stages[];  // streamed: 2 a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kGroupWarps + warp;
  if (g >= groups) return;  // the whole warp
  const int q = lane / kAnyGroup;
  const int ray_at = lane % kAnyGroup;
  const size_t first = static_cast<size_t>(g) * kAnyGroup;
  const size_t i = first + ray_at;
  const size_t row = first / tile * c_total;
  const int n = __ldg(counts + first / tile);
  const Ray ray = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  float* buf = stages + warp * 2 * kStage;
  bool occ = false;
  float bound = warp_max(tmx);
  int r = 0, tests = 0;
  int staged = -1;  // streamed: the position copied ahead
  bool walking = n > 0;
  for (int p0 = 0; walking; p0 += 32) {
    const int pos = p0 + lane;
    const bool valid = pos < n;
    int cid = 0, cnt = 0;
    float te = kBig;
    if (valid) {
      cid = __ldg(ids + row + pos);
      cnt = __ldg(tri_count + cid);
      te = __ldg(entries + row + pos);
    }
    for (; r - p0 < 32; ++r) {
      const int at = r - p0;
      // the stop: the list's end, or an entry past the bound
      const bool open = valid && te <= bound;
      if (!__shfl_sync(kFull, open, at)) {
        walking = false;
        break;
      }
      const int c_id = __shfl_sync(kFull, cid, at);
      const int c_cnt = __shfl_sync(kFull, cnt, at);
      const float* s = round_block<kStream>(blocks, buf, r, at, c_id, c_cnt,
                                            open, cid, cnt, lane, staged);
      bool hit = false;
      if (!occ && tmx > tmn) {
#pragma unroll 4
        for (int k = q; k < c_cnt; k += kAnySplit) {
          float t, u, v;
          ++tests;
          // a hit at t >= 1e30 is a miss in the plain version's t table
          if (mt_slot(ray, s, k, false, tmn, tmx, t, u, v) && t < kBig) {
            hit = true;
            break;
          }
        }
      }
      // the kAnySplit threads of a ray: occluded once one of them hit
      const unsigned hits = __ballot_sync(kFull, hit);
      occ = occ || ((hits >> ray_at) & kAnyRayLanes) != 0;
      bound = warp_max(occ ? -kBig : tmx);
      // every lane is done with this stage before it is refilled
      if (kStream) __syncwarp();
    }
  }
  if (kStream) wait_all();  // drain a copy ahead of a walk that stopped
  if (q == 0) out_occ[i] = occ ? 1 : 0;
  if (out_rounds != nullptr) {
    tests = warp_sum(tests);
    if (lane == 0) {
      out_rounds[2 * g] = r;
      out_rounds[2 * g + 1] = tests;
    }
  }
}

// The streamed forms' per-warp stages: their bytes a block, set as the
// kernel's dynamic shared memory size (above the 48 KB default).
template <bool kStream, typename Kernel>
int stage_bytes(Kernel kernel, size_t* bytes) {
  *bytes = kStream ? sizeof(float) * 2 * kStage * kGroupWarps : 0;
  if (!kStream) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*bytes)));
}

template <bool kStream>
int launch_closest(const int* counts, const int* ids, const int* bases,
                   const float* entries, const float* o, const float* d,
                   const float* tmin, const float* tmax, const float* blocks,
                   const int* tri_count, int nt, int tile, int c_total,
                   int cull, int prune, float* out_t, int* out_tri,
                   float* out_u, float* out_v, int* out_rounds, void* stream) {
  const int groups = nt * (tile / kRays);
  const int grid = (groups + kGroupWarps - 1) / kGroupWarps;
  size_t bytes;
  const int err = stage_bytes<kStream>(closest_kernel<kStream>, &bytes);
  if (err) return err;
  closest_kernel<kStream><<<grid, 32 * kGroupWarps, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      counts, ids, bases, entries, o, d, tmin, tmax, blocks, tri_count, groups,
      tile, c_total, cull, prune, out_t, out_tri, out_u, out_v, out_rounds);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStream>
int launch_any(const int* counts, const int* ids, const float* entries,
               const float* o, const float* d, const float* tmin,
               const float* tmax, const float* blocks, const int* tri_count,
               int nt, int tile, int c_total, int* out_occ, int* out_rounds,
               void* stream) {
  const int groups = nt * (tile / any_rays(kStream));
  const int grid = (groups + kGroupWarps - 1) / kGroupWarps;
  size_t bytes;
  const int err = stage_bytes<kStream>(any_kernel<kStream>, &bytes);
  if (err) return err;
  any_kernel<kStream><<<grid, 32 * kGroupWarps, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      counts, ids, entries, o, d, tmin, tmax, blocks, tri_count, groups, tile,
      c_total, out_occ, out_rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. All pointers are device pointers to
// contiguous arrays; each launch goes on `stream` and the function returns
// the first CUDA error of setting its shared memory size and launching (0 on
// success).
//
// counts (nt,) int32; ids, bases (nt, c) int32; entries (nt, c) float32,
// each row sorted near to far; o/d (nt * tile, 3), tmin/tmax (nt * tile,)
// float32; blocks (c, 16, 128) float32; tri_count (c,) int32, every slot at
// or past it zero; tile a multiple of 32 up to 256.
// Outputs (nt * tile,): t, tri, u, v (closest) or occ int32 (any); out_rounds
// int32 or null: per group ((nt * tile / list_walk_group_rays(), 2) closest,
// (nt * tile / list_walk_any_group_rays(stream), 2) any) the rounds it
// walked and the slots its rays tested, summed over the rays.

extern "C" int list_walk_group_rays() { return kRays; }

extern "C" int list_walk_any_group_rays(int stream) {
  return any_rays(stream != 0);
}

extern "C" int list_walk_closest(const int* counts, const int* ids,
                                 const int* bases, const float* entries,
                                 const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const float* blocks, const int* tri_count,
                                 int nt, int tile, int c_total, int cull,
                                 int prune, float* out_t, int* out_tri,
                                 float* out_u, float* out_v, int* out_rounds,
                                 void* stream) {
  return launch_closest<false>(counts, ids, bases, entries, o, d, tmin, tmax,
                               blocks, tri_count, nt, tile, c_total, cull,
                               prune, out_t, out_tri, out_u, out_v, out_rounds,
                               stream);
}

extern "C" int list_walk_closest_stream(
    const int* counts, const int* ids, const int* bases, const float* entries,
    const float* o, const float* d, const float* tmin, const float* tmax,
    const float* blocks, const int* tri_count, int nt, int tile, int c_total,
    int cull, float* out_t, int* out_tri, float* out_u, float* out_v,
    int* out_rounds, void* stream) {
  return launch_closest<true>(counts, ids, bases, entries, o, d, tmin, tmax,
                              blocks, tri_count, nt, tile, c_total, cull, 1,
                              out_t, out_tri, out_u, out_v, out_rounds,
                              stream);
}

extern "C" int list_walk_any(const int* counts, const int* ids,
                             const float* entries, const float* o,
                             const float* d, const float* tmin,
                             const float* tmax, const float* blocks,
                             const int* tri_count, int nt, int tile,
                             int c_total, int* out_occ, int* out_rounds,
                             void* stream) {
  return launch_any<false>(counts, ids, entries, o, d, tmin, tmax, blocks,
                           tri_count, nt, tile, c_total, out_occ, out_rounds,
                           stream);
}

extern "C" int list_walk_any_stream(const int* counts, const int* ids,
                                    const float* entries, const float* o,
                                    const float* d, const float* tmin,
                                    const float* tmax, const float* blocks,
                                    const int* tri_count, int nt, int tile,
                                    int c_total, int* out_occ,
                                    int* out_rounds, void* stream) {
  return launch_any<true>(counts, ids, entries, o, d, tmin, tmax, blocks,
                          tri_count, nt, tile, c_total, out_occ, out_rounds,
                          stream);
}

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
// A zero slot has det = 0 and never hits, so the slot loops stop at tri_k.
//
// What bounds them on the card. At the interior's 1,370 clusters of at most
// 32 triangles a visit costs each ray up to 32 tests of ~45 f32 operations
// against 1.15 KB of triangles, so the arithmetic is small and the bytes
// smaller; the walks are bound by their chains of rounds: a tile walks its
// clusters in series until its farthest lane's hit (closest) or until every
// lane is occluded (any), and a tile of secondary rays overlaps many
// clusters.
//
// What the designs do about it.
//   tile_round_walk: the whole walk of a 256-ray tile in one block, one
//     thread per ray, tiles independent (the host loop's lock step over
//     tiles changes no tile's result), so a walk is one launch with no host
//     sync. The tile's column of the visit order (entries and ids, sorted
//     near to far by ops/tile_trace._prepare) is read 256 rounds at a time
//     into shared memory. Each round: the exact block max of min(best_t,
//     tmax) (warp shuffles, one shared step, one barrier) decides the stop;
//     the cluster's tri_k slots of the 9 rows (1.15 KB at K = 32, not the
//     block's 128) are staged in shared memory, the next round's cluster in
//     flight with cp.async while this one is tested (its id is known: the
//     order is fixed); a second barrier makes the stage visible. A ray tests
//     the slots up to the cluster's triangle count (tri_count: the slots
//     past it are zero and never hit). The hit (t, tri, u, v) is written
//     once, and the tile's round count beside it. Measured on the card and
//     not kept (tile_walk_variants.py): one buffer filled after the round's
//     bound is known, and no staging (the slots read from L2).
//   tile_round: one block per tile, one thread per ray; the block reads its
//     cluster's 9 x 128 floats in place into shared memory.
//   tile_walk_closest: one block per 128-ray tile, one thread per ray. The
//     block reduces its rays' origin, direction and t-interval bounds,
//     writes the tile's C entry bounds to shared memory (4 bytes per
//     cluster), and each round takes the next cluster by a block-wide
//     lexicographic reduction, stages the cluster's block and tests it.
//   tile_walk_any: see the comment above its kernel.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr float kTiny = 1e-12f;   // |direction| floor of the slab test
constexpr int kSlots = 128;       // slot columns of a (16, 128) block
constexpr int kBlockRows = 16;
constexpr int kTriRows = 9;       // p0 | e1 | e2, x y z each
constexpr int kTile = 128;        // rays per tile of the fused walk
constexpr int kWarps = kTile / 32;
constexpr int kMaxRoundLanes = 256;  // rays per tile of the round walk
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

// Rows 0..8 of cluster `cid`'s block into shared memory, s[row * 128 + slot].
// The caller synchronises before any thread reads it.
__device__ __forceinline__ void stage_block(float* s,
                                            const float* __restrict__ blocks,
                                            int cid) {
  const float* b = blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
  for (int j = threadIdx.x; j < kTriRows * kSlots; j += blockDim.x)
    s[j] = __ldg(b + j);
}

// --- staging tri_k slots with cp.async -------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `n` of this thread's commit groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Slots [0, 4 kq) of rows 0..8 of cluster `cid` into s[row * 4 kq + slot],
// 16 bytes a copy, issued by every thread of the block (kq = ceil(tri_k/4):
// slots past tri_k are zero and never hit). Completion: cp_async_wait, then
// a barrier.
__device__ __forceinline__ void stage_slots(float* s,
                                            const float* __restrict__ blocks,
                                            int cid, int kq) {
  const float4* b = reinterpret_cast<const float4*>(
      blocks + static_cast<size_t>(cid) * kBlockRows * kSlots);
  float4* s4 = reinterpret_cast<float4*>(s);
  for (int j = threadIdx.x; j < kTriRows * kq; j += blockDim.x) {
    const int row = j / kq;
    cp_async16(s4 + j, b + row * (kSlots / 4) + (j - row * kq));
  }
}

// Moller-Trumbore of slot k in the operation order of pallas_tile._mt_vpu.
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

// The same test without a branch (an unrolled slot loop interleaves), for
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

// The closest hit of one ray among slots [0, tri_k) of a staged block:
// strict < over ascending slots gives the smallest slot on equal t.
__device__ __forceinline__ void closest_in_block(const Ray& r, const float* s,
                                                 int tri_k, bool cull,
                                                 float tmn, float tmx,
                                                 float& bt, float& bu,
                                                 float& bv, int& bs) {
  for (int k = 0; k < tri_k; ++k) {
    float t, u, v;
    if (mt_slot(r, s, k, cull, tmn, tmx, t, u, v) && t < bt) {
      bt = t;
      bu = u;
      bv = v;
      bs = k;
    }
  }
}

// Whether one ray hits any of slots [0, tri_k) of a staged buffer
// (kGlobal: a block in global memory).
template <bool kGlobal>
__device__ __forceinline__ bool any_in_slots(const Ray& r, const float* s,
                                             int ks, int tri_k, float tmn,
                                             float tmx) {
  bool hit = false;
#pragma unroll 4
  for (int k = 0; k < tri_k; ++k) {
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, m));
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
  stage_slots(stage, blocks, __ldg(irow), kq);
  cp_async_commit();
  int rnd = 0;
  for (; rnd < n_cols; ++rnd) {
    const int j = rnd % lanes;
    if (j == 0) {  // the next 256 rounds' clusters; the last ones were read
      const int c = rnd + tid;  // before the previous round's second barrier
      se[tid] = c < n_cols ? __ldg(erow + c) : kBig;
      sc[tid] = c < n_cols ? __ldg(irow + c) : 0;
    }
    const float m = warp_max(fminf(best_t, tmx));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    float bound = red[0];
    for (int w = 1; w < nw; ++w) bound = fmaxf(bound, red[w]);
    const float e = se[j];
    const int cid = sc[j];
    if (!(e < kBig && e <= bound)) break;  // uniform: a tile never restarts
    // every thread is past its reads of the other buffer (the barrier
    // above): the next round's cluster goes there while this one is tested
    float* cur = stage + (rnd & 1) * kTriRows * ks;
    if (rnd + 1 < n_cols) {
      const int nxt = j + 1 < lanes ? sc[j + 1] : __ldg(irow + rnd + 1);
      stage_slots(stage + ((rnd + 1) & 1) * kTriRows * ks, blocks, nxt, kq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this round's copies have landed
    __syncthreads();     // ... everyone's
    const float tmax_eff = fminf(best_t, tmx);
    const int cnt = __ldg(tri_count + cid);
    if (tmax_eff > tmn) {
      float cb = kBig, cu = 0.0f, cv = 0.0f;
      int cs = 0;
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        float t, u, v;
        if (mt_test<false>(r, cur, ks, k, cull != 0, tmn, tmax_eff, t, u, v) &&
            t < cb) {
          cb = t;
          cu = u;
          cv = v;
          cs = k;
        }
      }
      if (cb < best_t) {
        best_t = cb;
        best_id = __ldg(tri_begin + cid) + cs;
        best_u = cu;
        best_v = cv;
      }
    }
  }
  cp_async_wait<0>();  // a copy still in flight after the stop
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
             const float* __restrict__ blocks, int tri_k, int cull,
             float* __restrict__ out_t, float* __restrict__ out_u,
             float* __restrict__ out_v, float* __restrict__ out_dn,
             int* __restrict__ out_slot) {
  __shared__ float s[kTriRows * kSlots];
  const int tile = blockIdx.x;
  const size_t i = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int bs = kSlots;
  if (run[tile]) {  // uniform over the block
    stage_block(s, blocks, cid[tile]);
    __syncthreads();
    const float tmn = __ldg(tmin + i);
    const float tmx = __ldg(tmax_eff + i);
    if (tmx > tmn)
      closest_in_block(load_ray(o, d, i), s, tri_k, cull != 0, tmn, tmx, bt,
                       bu, bv, bs);
  }
  out_t[i] = bt;
  out_u[i] = bu;
  out_v[i] = bv;
  out_dn[i] = 1.0f;
  out_slot[i] = bs;
}

// ---------------------------------------------------------------------------
// K5: the fused walk, one block per 128-ray tile
// ---------------------------------------------------------------------------

// Block-wide reductions over the tile's 4 warps. Each ends with a barrier,
// so the scratch is free for the next one.
__device__ __forceinline__ float block_min(float x, float* red) {
  x = warp_min(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = fminf(x, red[w]);
  __syncthreads();
  return x;
}

__device__ __forceinline__ float block_max(float x, float* red) {
  return -block_min(-x, red);
}

__device__ __forceinline__ void lex_min(float& e, int& c, float oe, int oc) {
  if (oe < e || (oe == e && oc < c)) {
    e = oe;
    c = oc;
  }
}

// The (entry, id)-lexicographic successor of (last_e, last_c) over the
// tile's entries: each thread scans a strided 128th, then the block reduces.
// (kBig, C) when no cluster follows.
__device__ __forceinline__ void next_cluster(const float* entries, int c_total,
                                             float last_e, int last_c,
                                             float* red_e, int* red_c,
                                             float& e_out, int& c_out) {
  float be = kBig;
  int bc = c_total;
  for (int c = threadIdx.x; c < c_total; c += kTile) {
    const float e = entries[c];
    if (e > last_e || (e == last_e && c > last_c)) lex_min(be, bc, e, c);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    lex_min(be, bc, __shfl_xor_sync(kFull, be, m),
            __shfl_xor_sync(kFull, bc, m));
  if ((threadIdx.x & 31) == 0) {
    red_e[threadIdx.x >> 5] = be;
    red_c[threadIdx.x >> 5] = bc;
  }
  __syncthreads();
  be = red_e[0];
  bc = red_c[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) lex_min(be, bc, red_e[w], red_c[w]);
  __syncthreads();
  e_out = be;
  c_out = bc;
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

// The hull of the block's rays (block-wide reductions).
__device__ __forceinline__ Hull block_hull(const Ray& r, float tmn, float tmx,
                                           float* red) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float dv[3] = {r.dx, r.dy, r.dz};
  Hull h;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    h.olo[a] = block_min(o[a], red);
    h.ohi[a] = block_max(o[a], red);
    hull_axis(h, a, block_min(dv[a], red), block_max(dv[a], red));
  }
  h.tmin_lb = block_min(tmn, red);
  h.tmax_ub = block_max(tmx, red);
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

__global__ void __launch_bounds__(kTile)
closest_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax,
                    const float* __restrict__ cmin,
                    const float* __restrict__ cmax,
                    const int* __restrict__ tri_begin,
                    const float* __restrict__ blocks, int c_total, int tri_k,
                    int cull, float* __restrict__ out_t,
                    int* __restrict__ out_tri, float* __restrict__ out_u,
                    float* __restrict__ out_v) {
  extern __shared__ float smem[];
  float* blk = smem;                        // 9 x 128 floats
  float* entries = smem + kTriRows * kSlots;  // c_total floats
  __shared__ float red_e[kWarps];
  __shared__ int red_c[kWarps];

  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  const Hull h = block_hull(r, tmn, tmx, red_e);
  for (int c = threadIdx.x; c < c_total; c += kTile)
    entries[c] = hull_entry(h, cmin, cmax, c);
  __syncthreads();

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  float last_e = -kBig;
  int last_c = -1;
  while (true) {
    float e;
    int cid;
    next_cluster(entries, c_total, last_e, last_c, red_e, red_c, e, cid);
    const float bound = block_max(fminf(best_t, tmx), red_e);
    if (!(e < kBig && e <= bound)) break;  // uniform: a tile never restarts
    stage_block(blk, blocks, cid);
    __syncthreads();
    const float tmax_eff = fminf(best_t, tmx);
    if (tmax_eff > tmn) {
      float cb = kBig, cu = 0.0f, cv = 0.0f;
      int cs = kSlots;
      closest_in_block(r, blk, tri_k, cull != 0, tmn, tmax_eff, cb, cu, cv,
                       cs);
      if (cb < best_t) {
        best_t = cb;
        best_id = __ldg(tri_begin + cid) + cs;
        best_u = cu;
        best_v = cv;
      }
    }
    __syncthreads();  // every thread is done with blk before the next stage
    last_e = e;
    last_c = cid;
  }
  out_t[i] = best_t;
  out_tri[i] = best_id;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

// ---------------------------------------------------------------------------
// K5 any hit
// ---------------------------------------------------------------------------
//
// Occlusion is per lane and does not depend on the visit order: a lane is
// occluded where a cluster its tile's entry bounds keep (a conservative
// bound, tile_trace.tile_entries) holds a hit in its interval, and a tile
// stops only once each of its lanes is occluded or dead. So the walk below
// returns pallas_any_plain's flags bit for bit, and visits what the plain
// walk visits.
//   One block per 128-ray tile, one thread per ray. The block reduces the
//   tile's bounds, tests all C boxes 128 a step and compacts those in reach
//   into one candidate list (ballot, then a prefix over the warps' counts),
//   sorts it near to far once by (entry, id) (a bitonic sort of 64-bit keys
//   in shared memory), and walks it: each round stages the cluster's tri_k
//   slots, the next candidate's copy in flight with cp.async, and one
//   barrier both publishes the stage and decides the stop (every lane
//   occluded or dead). The rays that are neither occluded nor dead test the
//   cluster's slots up to its triangle count; a warp whose rays are all
//   done skips them.
//   Measured on the card and not kept (tile_walk_variants.py at the root of
//   the repository rebuilds each form from this source): the form before
//   (a block-wide next-cluster reduction over all C entries every round,
//   all 128 slots staged), and one warp per 32 rays with its own entry
//   bounds and candidate list and no block barrier (fewer visits, but its
//   11 KB list a warp at 1,370 clusters halves the resident warps, and it
//   reads the slots from L2).

// (entry, id) as one key that sorts like the lexicographic pair (entries
// below 1e30; -0 sorts with +0, as they compare).
__device__ __forceinline__ unsigned long long order_key(float e, int c) {
  unsigned u = __float_as_uint(e == 0.0f ? 0.0f : e);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(c);
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
  __shared__ float red[kWarps];
  __shared__ int wcount[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + tid;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i), tmx = __ldg(tmax + i);
  const Hull h = block_hull(r, tmn, tmx, red);
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int base = 0; base < c_total; base += kTile) {
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
  int p = 1;
  while (p < count) p <<= 1;
  for (int j = count + tid; j < p; j += kTile) keys[j] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int a = tid; a < p; a += kTile) {
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

  bool occ = false;
  const bool dead = tmx < tmn;
  if (count > 0)
    stage_slots(stage, blocks, static_cast<int>(keys[0] & 0xffffffffu), kq);
  cp_async_commit();
  for (int rnd = 0;; ++rnd) {
    cp_async_wait<0>();  // this round's copies have landed; the barrier
    // publishes them, and every thread is past its reads of the other buffer
    if (__syncthreads_and(occ || dead) || rnd >= count) break;
    if (rnd + 1 < count)
      stage_slots(stage + ((rnd + 1) & 1) * kTriRows * ks, blocks,
                  static_cast<int>(keys[rnd + 1] & 0xffffffffu), kq);
    cp_async_commit();
    const int cnt =
        __ldg(tri_count + static_cast<int>(keys[rnd] & 0xffffffffu));
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
// run (nt,) bool; blocks (C, 16, 128) float32; 1 <= r <= 256, tri_k <= 128.
// Outputs (nt, r): t, u, v, dn float32 and slot int32.
extern "C" int tile_round(const float* o, const float* d, const float* tmin,
                          const float* tmax_eff, const int* cid,
                          const unsigned char* run, const float* blocks,
                          int nt, int r, int tri_k, int cull, float* out_t,
                          float* out_u, float* out_v, float* out_dn,
                          int* out_slot, void* stream) {
  round_kernel<<<nt, r, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax_eff, cid, run, blocks, tri_k, cull, out_t, out_u,
      out_v, out_dn, out_slot);
  return static_cast<int>(cudaGetLastError());
}

// K5. o/d (n, 3), tmin/tmax (n,) float32 with n a multiple of 128; cmin/cmax
// (C, 3) float32; tri_begin (C,) int32; blocks (C, 16, 128) float32.
// Outputs (n,): t, tri, u, v.
extern "C" int tile_walk_closest(const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const float* cmin, const float* cmax,
                                 const int* tri_begin, const float* blocks,
                                 int n, int c_total, int tri_k, int cull,
                                 float* out_t, int* out_tri, float* out_u,
                                 float* out_v, void* stream) {
  const size_t smem = sizeof(float) * (kTriRows * kSlots + c_total);
  const int err = allow_shared(closest_walk_kernel, smem);
  if (err) return err;
  closest_walk_kernel<<<n / kTile, kTile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, tri_begin, blocks, c_total, tri_k, cull,
      out_t, out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

// K5 any: the same rays and boxes; tri_count (C,) int32 as for K4; C at
// most 16,384. Output (n,): occ int32.
extern "C" int tile_walk_any(const float* o, const float* d,
                             const float* tmin, const float* tmax,
                             const float* cmin, const float* cmax,
                             const float* blocks, const int* tri_count, int n,
                             int c_total, int tri_k, int* out_occ,
                             void* stream) {
  int p = 1;
  while (p < c_total) p <<= 1;
  const size_t smem = sizeof(float) * 2 * kTriRows * 4 * ((tri_k + 3) / 4) +
                      sizeof(unsigned long long) * p;
  const int err = allow_shared(any_tile_kernel, smem);
  if (err) return err;
  any_tile_kernel<<<n / kTile, kTile, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, blocks, tri_count, c_total, tri_k,
      out_occ);
  return static_cast<int>(cudaGetLastError());
}

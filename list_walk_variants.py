#!/usr/bin/env python3
"""Times design variants of the list-walk kernels K6 (closest and any hit,
each resident and streamed) on one NVIDIA GPU.

    python3 list_walk_variants.py [variant ...]   (default: all of them)

The package ships one design of each query in csrc/list_walk.cu (groups of
rays, one warp each, that walk their tile's list, test every cluster of it
up to their stop and stop on their own bound; the slot loop bounded by the
cluster's tri_count; the list taken 32 positions a step; an any-hit ray
leaving at its first occluder) and no switch. This script makes the other
forms that were tried from that source in memory (every patch must match
the source exactly once; other forms are appended whole), builds each with
nvcc beside the shipped form, and runs both entry points of each (the
resident form reads the slots in place, the streamed one stages them with
cp.async) on chip_smoke.py's interior wavefronts (camera 512x512; 2^17
bounce rays, a quarter of the lanes dead; 3 x 2^16 connection segments, a
third masked; sorted but the camera's), on both cluster sets (K=128 of the
walk mode, K=32 of the tile mode), tiles of 256, and prints the least of
ROUNDS x ITERS-launch mean times.

Closest hit (every wavefront): the shipped forms are checked against the
plain walk on the bounce wavefront and every variant against the shipped
form (`torch.equal` on t, tri, u, v), with back-face culling on and off;
times with culling on, with the rounds the groups walked, the ray-triangle
tests they made, and the time of the tile that holds the shipped form's
longest group launched alone (its chain of rounds without the other
tiles). A variant whose hits differ from the shipped form's is reported,
not timed less: the lanes where it parts from the plain walk, and for each
the gap in ulps between the ray's own entry into the box of the plain
walk's hit cluster and that hit's t. The variants:
  lockstep   the form before: one block per tile, one thread a ray,
             every round ending in a block-wide max and barriers, all 128
             slots tested;
  own        groups of one ray that test a cluster only when the ray's own
             entry into its box (tile_entries' arithmetic over the one ray)
             is within the ray's bound plus 2^-16 of it: a margin fitted to
             the card's data, not proven;
  own_exact  the same with no margin: it parts from the plain walk (a hit
             below the ray's own entry);
  all_slots  all 128 slots tested and staged (no tri_count);
  rays1, rays2, rays4, rays8, rays16, rays32   groups of 1, 2, 4, 8, 16 or
             32 rays (32, 16, 8, 4, 2 or 1 threads a ray), the one of the
             shipped size left out;
  unroll2, unroll8   the slot loop unrolled 2 or 8 times (4 shipped);
  prefetch   the resident form prefetching the next position's slots into
             L1 while a round tests;
  branch_free   the slot test without the branch on det (all of a slot's
             operations on every slot; the shipped test leaves a slot whose
             det fails at once).

Any hit (the bounce wavefront with segments up to 3, as the traversal
profiler walks it, and the connection wavefront's own segments): every
form's flags are checked against the plain walk (`torch.equal`; a variant
that parts is reported with its lanes, the shipped form must not part), and
timed with the rounds its groups walked and the slots its rays tested. The
variants:
  any_lockstep   the form before: one block per tile, one thread a
             ray, every round ending in a block-wide max, all 128 slots
             tested in series;
  any_all_slots  all 128 slots tested and staged (no tri_count);
  any_vote_loop  a ray's threads vote at every step of the slot loop (a
             ballot a step of 32 / group slots) and stop together, in place
             of leaving at their own first hit and voting once a round;
  any_rays1, any_rays2, any_rays4, any_rays8, any_rays16, any_rays32
             groups of 1, 2, 4, 8, 16 or 32 rays in both forms (the shipped
             forms take 1 ray resident and 4 streamed).

The last line is one JSON object with the card, its power limit and every
time. Needs a card, nvcc, and chip_smoke.py beside it. Nothing holds the
shipped source to these patches: once it changes so that one no longer
matches, the script stops and names the patch.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke

ROUNDS, ITERS = 3, 10
TILE = 256

# the lock-step forms' helpers: a block-wide max and the staging of a whole
# block of slots by the tile's threads
_LOCKSTEP_HELPERS = r"""
constexpr int kMaxTile = 256;     // rays per tile = threads per block

// Block-wide max over the tile's warps; ends with a barrier, so the scratch
// is free for the next call.
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) x = fmaxf(x, red[w]);
  __syncthreads();
  return x;
}

// Rows 0..8 of cluster `cid` (4,608 bytes) into a shared buffer with 16-byte
// cp.async copies by the block's threads, one commit group per stage.
__device__ __forceinline__ void stage_async(float* buf,
                                            const float* __restrict__ blocks,
                                            int cid) {
  const float* b = blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
  for (int j = threadIdx.x; j < kStage / 4; j += blockDim.x)
    cp_async16(buf + 4 * j, b + 4 * j);
  commit();
}

// The block of round r: in place (resident) or staged (streamed; round r+1
// is issued before round r is waited for).
template <bool kStream>
__device__ __forceinline__ const float* lockstep_block(
    const float* __restrict__ blocks, const int* __restrict__ ids, int r,
    int n, float (*buf)[kStage]) {
  if (!kStream)
    return blocks + static_cast<size_t>(__ldg(ids + r)) * kBlockRows * kSlots;
  if (r + 1 < n) {
    stage_async(buf[(r + 1) & 1], blocks, __ldg(ids + r + 1));
    wait_all_but_newest();
  } else {
    wait_all();
  }
  __syncthreads();  // every thread's copies of round r are visible
  return buf[r & 1];
}
"""

_LOCKSTEP = r"""
namespace {
""" + _LOCKSTEP_HELPERS + r"""
template <bool kStream>
__global__ void __launch_bounds__(kMaxTile)
closest_tile_kernel(const int* __restrict__ counts,
                    const int* __restrict__ ids,
               const int* __restrict__ bases,
               const float* __restrict__ entries, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ tmin,
               const float* __restrict__ tmax,
               const float* __restrict__ blocks, int c_total, int cull,
               int prune, float* __restrict__ out_t, int* __restrict__ out_tri,
               float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ __align__(16) float buf[kStream ? 2 : 1][kStage];
  __shared__ float red[kMaxTile / 32];
  const int tile = blockIdx.x;
  const size_t i = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  const size_t row = static_cast<size_t>(tile) * c_total;
  const int n = __ldg(counts + tile);
  const Ray ray = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (kStream && n > 0) stage_async(buf[0], blocks, __ldg(ids + row));
  bool go = n > 0;
  int r = 0;
  while (go) {  // uniform over the block
    const float* s = lockstep_block<kStream>(blocks, ids + row, r, n, buf);
    const float tmax_eff = fminf(best_t, tmx);
    if (tmax_eff > tmn) {
      float cb = kBig, cu = 0.0f, cv = 0.0f;
      int cs = kSlots;
      for (int k = 0; k < kSlots; ++k) {
        float t, u, v;
        if (mt_slot(ray, s, k, cull != 0, tmn, tmax_eff, t, u, v) && t < cb) {
          cb = t;
          cu = u;
          cv = v;
          cs = k;
        }
      }
      if (cb < best_t) {
        best_t = cb;
        best_id = __ldg(bases + row + r) + cs;
        best_u = cu;
        best_v = cv;
      }
    }
    ++r;
    if (kStream || prune) {
      const float bound = block_max(fminf(best_t, tmx), red);
      go = r < n && __ldg(entries + row + r) <= bound;
    } else {
      go = r < n;
    }
    // every thread is done with this round's buffer before it is refilled
    if (kStream) __syncthreads();
  }
  if (kStream) wait_all();  // drain the prefetch of a walk that stopped early
  out_t[i] = best_t;
  out_tri[i] = best_id;
  out_u[i] = best_u;
  out_v[i] = best_v;
}
}  // namespace

extern "C" int list_walk_closest_lockstep(const int* counts, const int* ids,
                                     const int* bases, const float* entries,
                                     const float* o, const float* d,
                                     const float* tmin, const float* tmax,
                                     const float* blocks,
                                     const int* tri_count, int nt, int tile,
                                     int c_total, int cull, int prune,
                                     float* out_t, int* out_tri, float* out_u,
                                     float* out_v, int* out_rounds,
                                     void* stream) {
  closest_tile_kernel<false><<<nt, tile, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      counts, ids, bases, entries, o, d, tmin, tmax, blocks, c_total, cull,
      prune, out_t, out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int list_walk_closest_lockstep_stream(
    const int* counts, const int* ids, const int* bases, const float* entries,
    const float* o, const float* d, const float* tmin, const float* tmax,
    const float* blocks, const int* tri_count, int nt, int tile, int c_total,
    int cull, float* out_t, int* out_tri, float* out_u, float* out_v,
    int* out_rounds, void* stream) {
  closest_tile_kernel<true><<<nt, tile, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      counts, ids, bases, entries, o, d, tmin, tmax, blocks, c_total, cull, 1,
      out_t, out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}
"""

# the any forms before: one block per tile, one thread a lane, the tile's
# bound a block-wide max each round, all 128 slots tested in series
_ANY_LOCKSTEP = r"""
namespace {
""" + _LOCKSTEP_HELPERS + r"""
template <bool kStream>
__global__ void __launch_bounds__(kMaxTile)
any_tile_kernel(const int* __restrict__ counts, const int* __restrict__ ids,
                const float* __restrict__ entries, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ tmin,
                const float* __restrict__ tmax,
                const float* __restrict__ blocks, int c_total,
                int* __restrict__ out_occ) {
  __shared__ __align__(16) float buf[kStream ? 2 : 1][kStage];
  __shared__ float red[kMaxTile / 32];
  const int tile = blockIdx.x;
  const size_t i = static_cast<size_t>(tile) * blockDim.x + threadIdx.x;
  const size_t row = static_cast<size_t>(tile) * c_total;
  const int n = __ldg(counts + tile);
  const Ray ray = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  bool occ = false;
  if (kStream && n > 0) stage_async(buf[0], blocks, __ldg(ids + row));
  bool go = n > 0;
  int r = 0;
  while (go) {  // uniform over the block
    const float* s = lockstep_block<kStream>(blocks, ids + row, r, n, buf);
    if (!occ && tmx > tmn) {
      for (int k = 0; k < kSlots && !occ; ++k) {
        float t, u, v;
        // a hit at t >= 1e30 is a miss in the plain version's t table
        occ = mt_slot(ray, s, k, false, tmn, tmx, t, u, v) && t < kBig;
      }
    }
    ++r;
    const float open_max = block_max(occ ? -kBig : tmx, red);
    go = r < n && __ldg(entries + row + r) <= open_max;
    if (kStream) __syncthreads();
  }
  if (kStream) wait_all();
  out_occ[i] = occ ? 1 : 0;
}
}  // namespace

extern "C" int list_walk_any_lockstep(
    const int* counts, const int* ids, const float* entries, const float* o,
    const float* d, const float* tmin, const float* tmax, const float* blocks,
    const int* tri_count, int nt, int tile, int c_total, int* out_occ,
    int* out_rounds, void* stream) {
  any_tile_kernel<false><<<nt, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, ids, entries, o, d, tmin, tmax, blocks, c_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int list_walk_any_lockstep_stream(
    const int* counts, const int* ids, const float* entries, const float* o,
    const float* d, const float* tmin, const float* tmax, const float* blocks,
    const int* tri_count, int nt, int tile, int c_total, int* out_occ,
    int* out_rounds, void* stream) {
  any_tile_kernel<true><<<nt, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, ids, entries, o, d, tmin, tmax, blocks, c_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}
"""

# the slot test without the branch on det (the reciprocal of 1 stands in)
_MT_TEST_FN = r"""
// mt_slot without the branch on det (the reciprocal of 1 stands in); a
// hit's t, u, v are the same bits.
__device__ __forceinline__ bool mt_test(const Ray& r, const float* s, int k,
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
"""

# the own-entry form, in a namespace of its own
_OWN = r"""
namespace {
namespace own {
""" + _MT_TEST_FN + r"""
constexpr float kTiny = 1e-12f;   // |direction| floor of the entry bounds
// a cluster is tested when the group's own entry is within its bound
// plus this share of the bound
constexpr float kEntrySlack = 1.0f / 65536.0f;
constexpr int kRays = 1;
constexpr int kSplit = 32;

// The hull of a group's rays (each held by its kSplit threads), in
// tile_entries' operation order: origin and direction bounds per axis, the
// floored reciprocal direction interval, the t-interval's bounds.
struct Hull {
  float olo[3], ohi[3], il[3], ih[3];
  bool straddle[3];
  float tmin_lb, tmax_ub;
};

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

__device__ __forceinline__ Hull group_hull(const Ray& r, float tmn,
                                           float tmx) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float dv[3] = {r.dx, r.dy, r.dz};
  Hull h;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    h.olo[a] = warp_min(o[a]);
    h.ohi[a] = warp_max(o[a]);
    const float dlo = warp_min(dv[a]), dhi = warp_max(dv[a]);
    h.straddle[a] = (dlo <= 0.0f) & (dhi >= 0.0f);
    const float safe_lo = fabsf(dlo) < kTiny ? (dlo < 0.0f ? -kTiny : kTiny)
                                             : dlo;
    const float safe_hi = fabsf(dhi) < kTiny ? (dhi < 0.0f ? -kTiny : kTiny)
                                             : dhi;
    h.il[a] = fminf(1.0f / safe_lo, 1.0f / safe_hi);
    h.ih[a] = fmaxf(1.0f / safe_lo, 1.0f / safe_hi);
  }
  h.tmin_lb = warp_min(tmn);
  h.tmax_ub = warp_max(tmx);
  return h;
}

// A list entry as the walk looks ahead at it: the cluster, its slot count
// and its box.
struct Cluster {
  int id, cnt;
  float lo[3], hi[3];
};

__device__ __forceinline__ Cluster load_cluster(
    int id, const int* __restrict__ tri_count, const float* __restrict__ cmin,
    const float* __restrict__ cmax) {
  Cluster c;
  c.id = id;
  c.cnt = __ldg(tri_count + id);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c.lo[a] = __ldg(cmin + 3 * id + a);
    c.hi[a] = __ldg(cmax + 3 * id + a);
  }
  return c;
}

// The group's conservative entry into a cluster's box (tile_entries for one
// group, in its operation order); 1e30 where no ray of the group can reach
// the box within its t-interval.
__device__ __forceinline__ float group_entry(const Hull& h, const Cluster& c) {
  float entry = 0.0f, exit_ = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo_ab = fminf(c.lo[a] - h.ohi[a], c.hi[a] - h.ohi[a]);
    const float hi_ab = fmaxf(c.lo[a] - h.olo[a], c.hi[a] - h.olo[a]);
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

// Closest hit: group g (one warp) holds rays g * kRays ... of its tile; lane
// = kRays * q + ray, thread q of its ray tests slots q, q + kSplit, ... The
// group takes its list 32 positions at a time: lane j loads position
// p0 + j (cluster id, count, box, base, tile entry) and computes the group's
// entry into that cluster, then two ballots against the current bound give
// the next position to test and the position where the walk stops.
template <bool kStream>
__global__ void __launch_bounds__(32 * kGroupWarps)
closest_kernel(const int* __restrict__ counts, const int* __restrict__ ids,
               const int* __restrict__ bases,
               const float* __restrict__ entries, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ tmin,
               const float* __restrict__ tmax,
               const float* __restrict__ blocks,
               const int* __restrict__ tri_count,
               const float* __restrict__ cmin, const float* __restrict__ cmax,
               int groups, int tile, int c_total, int cull, int prune,
               float* __restrict__ out_t, int* __restrict__ out_tri,
               float* __restrict__ out_u, float* __restrict__ out_v,
               int* __restrict__ out_rounds) {
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
  const Hull hull = group_hull(ray, tmn, tmx);
  float* buf = stages + warp * 2 * kStage;
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  float bound = warp_max(fminf(best_t, tmx));
  int r = 0, slots = 0;
  int staged = -1, sbuf = 0;  // streamed: the position copied ahead, its
                              // buffer
  bool walking = n > 0;
  for (int p0 = 0; walking; p0 += 32) {
    const int pos = p0 + lane;
    const bool valid = pos < n;
    Cluster c;
    float te = kBig, ge = kBig;
    int base = 0;
    c.id = c.cnt = 0;
    if (valid) {
      c = load_cluster(__ldg(ids + row + pos), tri_count, cmin, cmax);
      te = __ldg(entries + row + pos);
      base = __ldg(bases + row + pos);
      ge = group_entry(hull, c);
    }
    while (r - p0 < 32) {
      // the stop: the list's end, or (prune) an entry past the bound; the
      // next test: a cluster the group reaches. The bound only falls, so a
      // position refused once stays refused.
      const unsigned ahead = ~0u << (r - p0);
      const unsigned stop =
          __ballot_sync(kFull, !valid || (prune && te > bound)) & ahead;
      const float reach = bound + fabsf(bound) * kEntrySlack;
      const unsigned take = __ballot_sync(kFull, valid && ge <= reach) & ahead;
      const int stop_at = stop ? __ffs(stop) - 1 : 32;
      const int take_at = take ? __ffs(take) - 1 : 32;
      if (take_at >= stop_at) {
        r = p0 + stop_at;
        walking = stop_at == 32;
        break;
      }
      const int cid = __shfl_sync(kFull, c.id, take_at);
      const int cnt = __shfl_sync(kFull, c.cnt, take_at);
      const int cbase = __shfl_sync(kFull, base, take_at);
      const float* s;
      if (kStream) {
        const int here = p0 + take_at;
        if (staged != here) {
          wait_all();  // a copy of a position that was refused since
          sbuf ^= 1;
          stage_warp(buf + sbuf * kStage, blocks, cid, cnt, lane);
        }
        s = buf + sbuf * kStage;
        // the next position the group reaches, copied while this one tests
        const unsigned later = take_at < 31 ? take & (~0u << (take_at + 1))
                                            : 0u;
        if (later) {
          const int at = __ffs(later) - 1;
          sbuf ^= 1;
          stage_warp(buf + sbuf * kStage, blocks,
                     __shfl_sync(kFull, c.id, at),
                     __shfl_sync(kFull, c.cnt, at), lane);
          staged = p0 + at;
          wait_all_but_newest();
        } else {
          staged = -1;
          wait_all();
        }
        __syncwarp();  // every lane's copies of this position are visible
      } else {
        s = blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
      }
      slots += cnt;
      const float tmax_eff = fminf(best_t, tmx);
      float cb = kBig, cu = 0.0f, cv = 0.0f;
      int cs = kSlots;
      if (tmax_eff > tmn) {
#pragma unroll 4
        for (int k = q; k < cnt; k += kSplit) {
          float t, u, v;
          if (mt_test(ray, s, k, cull != 0, tmn, tmax_eff, t, u, v) &&
              t < cb) {
            cb = t;
            cu = u;
            cv = v;
            cs = k;
          }
        }
      }
      // the kSplit threads of a ray: smallest t, then smallest slot
#pragma unroll
      for (int m = kRays; m < 32; m <<= 1) {
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
        best_id = cbase + cs;
        best_u = cu;
        best_v = cv;
      }
      bound = warp_max(fminf(best_t, tmx));
      r = p0 + take_at + 1;
      // every lane is done with this stage before it is refilled
      if (kStream) __syncwarp();
    }
  }
  if (kStream) wait_all();  // drain a copy ahead of a walk that stopped
  if (q == 0) {
    out_t[i] = best_t;
    out_tri[i] = best_id;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
  if (out_rounds != nullptr && lane == 0) {
    out_rounds[2 * g] = r;
    out_rounds[2 * g + 1] = kRays * slots;
  }
}

template <bool kStream>
int launch_closest(const int* counts, const int* ids, const int* bases,
                   const float* entries, const float* o, const float* d,
                   const float* tmin, const float* tmax, const float* blocks,
                   const int* tri_count, const float* cmin, const float* cmax,
                   int nt, int tile, int c_total, int cull, int prune,
                   float* out_t, int* out_tri, float* out_u, float* out_v,
                   int* out_rounds, void* stream) {
  const int groups = nt * (tile / kRays);
  const int grid = (groups + kGroupWarps - 1) / kGroupWarps;
  const size_t bytes = kStream ? sizeof(float) * 2 * kStage * kGroupWarps : 0;
  if (kStream) {
    const cudaError_t err = cudaFuncSetAttribute(
        closest_kernel<kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  closest_kernel<kStream><<<grid, 32 * kGroupWarps, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      counts, ids, bases, entries, o, d, tmin, tmax, blocks, tri_count, cmin,
      cmax, groups, tile, c_total, cull, prune, out_t, out_tri, out_u, out_v,
      out_rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace own
}  // namespace

extern "C" int list_walk_closest_own(
    const int* counts, const int* ids, const int* bases, const float* entries,
    const float* o, const float* d, const float* tmin, const float* tmax,
    const float* blocks, const int* tri_count, const float* cmin,
    const float* cmax, int nt, int tile, int c_total, int cull, int prune,
    float* out_t, int* out_tri, float* out_u, float* out_v, int* out_rounds,
    void* stream) {
  return own::launch_closest<false>(counts, ids, bases, entries, o, d, tmin,
                                    tmax, blocks, tri_count, cmin, cmax, nt,
                                    tile, c_total, cull, prune, out_t, out_tri,
                                    out_u, out_v, out_rounds, stream);
}

extern "C" int list_walk_closest_own_stream(
    const int* counts, const int* ids, const int* bases, const float* entries,
    const float* o, const float* d, const float* tmin, const float* tmax,
    const float* blocks, const int* tri_count, const float* cmin,
    const float* cmax, int nt, int tile, int c_total, int cull, float* out_t,
    int* out_tri, float* out_u, float* out_v, int* out_rounds, void* stream) {
  return own::launch_closest<true>(counts, ids, bases, entries, o, d, tmin,
                                   tmax, blocks, tri_count, cmin, cmax, nt,
                                   tile, c_total, cull, 1, out_t, out_tri,
                                   out_u, out_v, out_rounds, stream);
}
"""

_SLOT_LOOP = "        for (int k = q; k < c_cnt; k += kSplit) {"
_STAGE_CHUNKS = "  const int chunks = (cnt + 3) >> 2;  // per row"
_GROUP_RAYS = re.compile(r"constexpr int kRays = \d+;")


def _once(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, f"patch matches {src.count(old)} times:\n{old}"
    return src.replace(old, new)


def _all_slots(src: str) -> str:
    """Every slot tested, and so every slot staged."""
    src = _once(src, _SLOT_LOOP, _SLOT_LOOP.replace("c_cnt", "kSlots"))
    return _once(src, _STAGE_CHUNKS, "  const int chunks = kSlots / 4;")


_UNROLL = "#pragma unroll 4\n" + _SLOT_LOOP
_MT_SLOT = ("          if (mt_slot(ray, s, k, cull != 0, tmn, tmax_eff, t, u, "
            "v) &&")
# where mt_test goes: before the shared closest walk that calls it
_CLOSEST = "// --- the closest-hit walk of one group"
_IN_PLACE = ("  if (!kStream)\n"
             "    return blocks + static_cast<size_t>(c_id) * kBlockRows * "
             "kSlots;\n")
# the resident forms with the next position's slots prefetched into L1
_PREFETCH = """  if (!kStream) {
    const int nx = at < 31 ? at + 1 : 31;
    if (__shfl_sync(kFull, open, nx) && at < 31) {
      const float* nb = blocks + static_cast<size_t>(
          __shfl_sync(kFull, cid, nx)) * kBlockRows * kSlots;
      const int lines = (__shfl_sync(kFull, cnt, nx) + 31) >> 5;
      for (int j = lane; j < kTriRows * lines; j += 32)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(
            nb + (j / lines) * kSlots + 32 * (j % lines)));
    }
    return blocks + static_cast<size_t>(c_id) * kBlockRows * kSlots;
  }
"""
_ANY_SLOT_LOOP = """      bool hit = false;
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
"""
# a ray's threads vote within the slot loop: kAnySplit slots a step, one
# ballot a step, the ray's threads stop together at the step where one of
# them hit, the warp when no ray is left open
_ANY_VOTE_LOOP = """      for (int k0 = 0; k0 < c_cnt; k0 += kAnySplit) {
        const int k = k0 + q;
        bool hit = false;
        if (!occ && tmx > tmn && k < c_cnt) {
          float t, u, v;
          ++tests;
          hit = mt_slot(ray, s, k, false, tmn, tmx, t, u, v) && t < kBig;
        }
        const unsigned hits = __ballot_sync(kFull, hit);
        occ = occ || ((hits >> ray_at) & kAnyRayLanes) != 0;
        if (!__any_sync(kFull, !occ && tmx > tmn)) break;
      }
"""
_ANY_GROUP_RAYS = re.compile(r"constexpr int kAny(Stream)?Rays = \d+;")
_SLACK = "      const float reach = bound + fabsf(bound) * kEntrySlack;"


def _rays(n: int):
    def patch(src: str) -> str:
        out, hits = _GROUP_RAYS.subn(f"constexpr int kRays = {n};", src)
        assert hits == 1, f"the group size matches {hits} times"
        return out
    return patch


def _any_rays(n: int):
    """Groups of n rays in both any forms."""
    def patch(src: str) -> str:
        out, hits = _ANY_GROUP_RAYS.subn(
            lambda m: f"constexpr int kAny{m.group(1) or ''}Rays = {n};", src)
        assert hits == 2, f"the any group sizes match {hits} times"
        return out
    return patch


def _any_all_slots(src: str) -> str:
    """Every slot tested by the any forms, and so every slot staged."""
    src = _once(src, _ANY_SLOT_LOOP, _ANY_SLOT_LOOP.replace(
        "k < c_cnt; k += kAnySplit", "k < kSlots; k += kAnySplit"))
    return _once(src, _STAGE_CHUNKS, "  const int chunks = kSlots / 4;")


_SHIPPED = ("list_walk_closest", "list_walk_closest_stream")
_OWN_FORMS = ("list_walk_closest_own", "list_walk_closest_own_stream")
# name -> (patch of the shipped source, resident and streamed entry points,
# whether they take the cluster boxes, rays a group (None: the library's))
VARIANTS = {
    "shipped": (lambda s: s, _SHIPPED, False, None),
    "lockstep": (lambda s: s + _LOCKSTEP, ("list_walk_closest_lockstep",
                                           "list_walk_closest_lockstep_stream"),
                 False, None),
    "own": (lambda s: s + _OWN, _OWN_FORMS, True, 1),
    "own_exact": (lambda s: s + _once(_OWN, _SLACK,
                                      "      const float reach = bound;"),
                  _OWN_FORMS, True, 1),
    "all_slots": (_all_slots, _SHIPPED, False, None),
    **{f"rays{n}": (_rays(n), _SHIPPED, False, None)
       for n in (1, 2, 4, 8, 16, 32)},
    "prefetch": (lambda s: _once(s, _IN_PLACE, _PREFETCH), _SHIPPED, False,
                 None),
    "branch_free": (lambda s: _once(_once(
        s, _MT_SLOT, _MT_SLOT.replace("mt_slot", "mt_test")), _CLOSEST,
        _MT_TEST_FN + "\n" + _CLOSEST), _SHIPPED, False, None),
    **{f"unroll{n}": (lambda s, n=n: _once(s, _UNROLL, _UNROLL.replace(
        "unroll 4", f"unroll {n}")), _SHIPPED, False, None) for n in (2, 8)},
}

_ANY_SHIPPED = ("list_walk_any", "list_walk_any_stream")
# name -> (patch of the shipped source, resident and streamed entry points)
ANY_VARIANTS = {
    "any_shipped": (lambda s: s, _ANY_SHIPPED),
    "any_lockstep": (lambda s: s + _ANY_LOCKSTEP,
                     ("list_walk_any_lockstep",
                      "list_walk_any_lockstep_stream")),
    "any_all_slots": (_any_all_slots, _ANY_SHIPPED),
    "any_vote_loop": (lambda s: _once(s, _ANY_SLOT_LOOP, _ANY_VOTE_LOOP),
                      _ANY_SHIPPED),
    **{f"any_rays{n}": (_any_rays(n), _ANY_SHIPPED)
       for n in (1, 2, 4, 8, 16, 32)},
}


def build_variant(name: str, out_dir: str) -> tuple:
    """Patch, compile and load one variant -> (ctypes library, ptxas
    lines)."""
    from spcbpt_tpu_torch.kernels import build
    patch = (ANY_VARIANTS if name in ANY_VARIANTS else VARIANTS)[name][0]
    src = patch(build.source("list_walk"))
    cu = os.path.join(out_dir, f"list_walk_{name}.cu")
    so = os.path.join(out_dir, f"liblist_walk_{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{res.stderr}")
    regs = [line.strip() for line in res.stderr.splitlines()
            if "Used " in line or "spill" in line]
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name in ANY_VARIANTS:
        forms = ANY_VARIANTS[name][1]
        for fn in forms:
            getattr(lib, fn).argtypes = [p] * 9 + [i] * 3 + [p] * 3
    else:
        _, forms, boxes, _ = VARIANTS[name]
        ptrs = 12 if boxes else 10
        getattr(lib, forms[0]).argtypes = [p] * ptrs + [i] * 5 + [p] * 6
        getattr(lib, forms[1]).argtypes = [p] * ptrs + [i] * 4 + [p] * 6
    lib.list_walk_group_rays.argtypes = []
    lib.list_walk_any_group_rays.argtypes = [i]
    for fn in (*forms, "list_walk_group_rays", "list_walk_any_group_rays"):
        getattr(lib, fn).restype = i
    return lib, regs


def parted(cs, o, d, hit, ref) -> dict:
    """Where a variant's hits part from the plain walk's `ref`: the lanes,
    and for each the ray's own entry into the box of the plain hit's
    cluster (tile_entries' arithmetic over the ray alone) minus the plain
    hit's t, and the variant's t minus it, both in ulps of that t."""
    t, tri = hit[0], hit[1]
    lanes = torch.nonzero((tri != ref[1]) | (t != ref[0]))[:, 0]
    t_p, tri_p = ref[0][lanes], ref[1][lanes]
    cid = torch.searchsorted(cs.tri_begin, tri_p.clamp(min=0),
                             right=True) - 1
    oo, dd = o[lanes], d[lanes]
    straddle = dd == 0
    safe = torch.where(dd.abs() < 1e-12, torch.where(dd < 0, -1e-12, 1e-12),
                       dd)
    inv = 1.0 / safe
    lo_ab = torch.minimum(cs.cmin[cid] - oo, cs.cmax[cid] - oo)
    hi_ab = torch.maximum(cs.cmin[cid] - oo, cs.cmax[cid] - oo)
    ax_lo = torch.where(straddle, -1e30, torch.minimum(lo_ab * inv,
                                                       hi_ab * inv))
    entry = ax_lo.amax(dim=1)
    ulp = torch.nextafter(t_p, torch.full_like(t_p, float("inf"))) - t_p
    gap = ((entry - t_p) / ulp).tolist()
    moved = ((t[lanes] - t_p) / ulp).tolist()
    return {"lanes": lanes.tolist()[:8], "count": int(lanes.numel()),
            "plain_tri": tri_p.tolist()[:8], "tri": tri[lanes].tolist()[:8],
            "entry_minus_t_ulps": gap[:8], "t_minus_plain_t_ulps": moved[:8]}


def _ptr(*xs):
    return [x.data_ptr() for x in xs]


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("list_walk_variants: no CUDA device is available")
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.kernels import build
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    asked = argv or [*VARIANTS, *ANY_VARIANTS]
    unknown = set(asked) - set(VARIANTS) - set(ANY_VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: "
                         f"{[*VARIANTS, *ANY_VARIANTS]}")
    src = build.source("list_walk")
    # each query's shipped form beside its variants; the group size of the
    # shipped form is no variant
    names = []
    for table, shipped in ((VARIANTS, "shipped"),
                           (ANY_VARIANTS, "any_shipped")):
        mine = [a for a in asked if a in table and a != shipped]
        if mine or shipped in asked:
            names += [shipped] + [a for a in mine if table[a][0](src) != src]
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda name: build_variant(name, out_dir), names)))
    for name, (_, regs) in built.items():
        for line in regs:
            print(f"{name:14s} ptxas: {line}", flush=True)

    dev = torch.device("cuda", 0)
    path = resolve_scene("interior")
    wts, _, cam = load_trace_scene(path, dev)
    tts, _, _ = load_trace_scene(path, dev, mode="tile")
    cam.aspect = 1.0
    waves = chip_smoke.wavefronts(wts, cam, dev) + (
        chip_smoke.connection_wavefront(wts, cam, dev),)
    results = {name: {"ptxas": regs} for name, (_, regs) in built.items()}
    sets = ((128, wts.clusters_walk), (32, tts.clusters))
    time_closest({a: b for a, b in built.items() if a in VARIANTS}, sets,
                 waves, results, dev)
    time_any({a: b for a, b in built.items() if a in ANY_VARIANTS}, sets,
             waves, results, dev)
    print(json.dumps({"card": smi, "variants": results}))
    return 0


def time_closest(built, sets, waves, results, dev) -> None:
    """The closest variants on every wavefront and set (see the module
    note); each variant's numbers go to results[name]."""
    from spcbpt_tpu_torch.ops import pallas_walk

    stream = torch.cuda.current_stream(dev).cuda_stream
    for k, cs in sets:
        blocks = cs.blocks()
        for wave, o, d, tmax in waves:
            n = o.shape[0]
            tmin = torch.full((n,), 1e-3, device=dev)
            prep = pallas_walk.prepare(cs, o, d, tmin, tmax, TILE,
                                       not wave.startswith("camera"))[:-1]
            po, pd, ptn, ptx, _, entries, ids, bases, counts = prep
            nt, c = ids.shape
            plain = {}

            def plain_of(cull):
                if cull not in plain:
                    plain[cull] = pallas_walk.list_walk_closest_plain(
                        blocks, counts, ids, bases, entries, po, pd, ptn, ptx,
                        bool(cull))
                return plain[cull]
            # one tile alone: the one holding the shipped form's longest
            # group (the launch's chain, without the other tiles)
            lone = None
            ref = {}
            for name, (lib, _) in built.items():
                _, forms, boxes, group = VARIANTS[name]
                group = group or lib.list_walk_group_rays()
                out = {}
                for form, fn in zip(("resident", "streamed"), forms):
                    def launch(t0, t1, hit, rounds, cull, lib=lib, fn=fn,
                               form=form):
                        lanes = slice(t0 * TILE, t1 * TILE)
                        args = _ptr(counts[t0:t1], ids[t0:t1], bases[t0:t1],
                                   entries[t0:t1], po[lanes], pd[lanes],
                                   ptn[lanes], ptx[lanes], blocks,
                                   cs.tri_count)
                        if boxes:
                            args += _ptr(cs.cmin, cs.cmax)
                        args += [t1 - t0, TILE, c, cull] + (
                            [1] if form == "resident" else [])
                        err = getattr(lib, fn)(*args, *_ptr(*hit, rounds),
                                               stream)
                        assert err == 0, (name, fn, err)

                    hit = [torch.empty((nt * TILE,), device=dev)
                           for _ in range(4)]
                    hit[1] = hit[1].int()
                    rounds = torch.zeros((nt * TILE // group, 2),
                                         dtype=torch.int32, device=dev)
                    for cull in (1, 0):
                        launch(0, nt, hit, rounds, cull)
                        torch.cuda.synchronize()
                        if cull not in ref:
                            ref[cull] = [x.clone() for x in hit]
                            if cull == 1:
                                lone = int(rounds[:, 0].argmax()) * group \
                                    // TILE
                            if wave.startswith("bounce"):   # vs plain
                                for f, a, b in zip("t tri u v".split(),
                                                   plain_of(cull), ref[cull]):
                                    assert torch.equal(a, b), (k, cull, f)
                        if not all(torch.equal(a, b)
                                   for a, b in zip(hit, ref[cull])):
                            out[f"{form}_cull{cull}_differs"] = parted(
                                cs, po, pd, hit, plain_of(cull))
                    run = lambda: launch(0, nt, hit, rounds, 1)
                    out[f"{form}_ms"] = min(chip_smoke.cuda_ms(run, ITERS)
                                            for _ in range(ROUNDS))
                    out[f"{form}_tile_alone_ms"] = chip_smoke.cuda_ms(
                        lambda: launch(lone, lone + 1, hit, rounds, 1), ITERS)
                    if name != "lockstep":
                        run()
                        walked, slots = rounds.long().sum(dim=0).tolist()
                        out[f"{form}_rounds_sum"] = walked
                        out[f"{form}_rounds_max"] = int(rounds[:, 0].max())
                        out[f"{form}_tests"] = slots
                results[name][f"K={k} {wave}"] = out
                same = not any(key.endswith("differs") for key in out)
                print(f"{name:13s} K={k:3d} {wave:17s} " + ", ".join(
                    f"{key} {val:.4f}" if isinstance(val, float) else
                    f"{key} {val}" for key, val in out.items())
                    + (" (equal to shipped)" if same else ""), flush=True)


def time_any(built, sets, waves, results, dev) -> None:
    """The any variants on the bounce wavefront with segments up to 3 and
    on the connection wavefront's own segments, both sets, tile 256, sorted:
    each form's flags against the plain walk (the lanes where they part),
    the least of ROUNDS x ITERS-launch mean times, and (but the lock-step
    form) the rounds its groups walked and the slots its rays tested."""
    from spcbpt_tpu_torch.ops import pallas_walk

    stream = torch.cuda.current_stream(dev).cuda_stream
    name_b, o_b, d_b, tmax_b = waves[1]
    t3 = torch.where(tmax_b < 0, -1.0, torch.full_like(tmax_b, 3.0))
    for k, cs in sets:
        blocks = cs.blocks()
        for wave, o, d, tmax in ((f"{name_b} tmax 3", o_b, d_b, t3),
                                 waves[2]):
            tmin = torch.full((o.shape[0],), 1e-3, device=dev)
            po, pd, ptn, ptx, _, entries, ids, _, counts, _ = \
                pallas_walk.prepare(cs, o, d, tmin, tmax, TILE, True)
            nt, c = ids.shape
            plain = pallas_walk.list_walk_any_plain(blocks, counts, ids,
                                                    entries, po, pd, ptn, ptx)
            for name, (lib, _) in built.items():
                occ = torch.empty((nt * TILE,), dtype=torch.int32, device=dev)
                out = {}
                for stream, (form, fn) in enumerate(zip(
                        ("resident", "streamed"), ANY_VARIANTS[name][1])):
                    group = lib.list_walk_any_group_rays(stream)
                    rounds = torch.zeros((nt * TILE // group, 2),
                                         dtype=torch.int32, device=dev)
                    def launch(lib=lib, fn=fn, rounds=rounds):
                        err = getattr(lib, fn)(
                            *_ptr(counts, ids, entries, po, pd, ptn, ptx,
                                  blocks, cs.tri_count), nt, TILE, c,
                            *_ptr(occ, rounds), stream)
                        assert err == 0, (name, fn, err)
                    launch()
                    torch.cuda.synchronize()
                    if not torch.equal(occ, plain):
                        lanes = torch.nonzero(occ != plain)[:, 0]
                        assert name != "any_shipped", (k, wave, form)
                        out[f"{form}_differs"] = {
                            "count": int(lanes.numel()),
                            "lanes": lanes.tolist()[:8],
                            "occ": occ[lanes].tolist()[:8],
                            "plain_occ": plain[lanes].tolist()[:8]}
                    out[f"{form}_ms"] = min(chip_smoke.cuda_ms(launch, ITERS)
                                            for _ in range(ROUNDS))
                    if name != "any_lockstep":
                        launch()
                        walked, tests = rounds.long().sum(dim=0).tolist()
                        out[f"{form}_rounds_sum"] = walked
                        out[f"{form}_rounds_max"] = int(rounds[:, 0].max())
                        out[f"{form}_tests"] = tests
                results[name][f"K={k} {wave}"] = out
                same = not any(key.endswith("differs") for key in out)
                print(f"{name:13s} K={k:3d} {wave:24s} " + ", ".join(
                    f"{key} {val:.4f}" if isinstance(val, float) else
                    f"{key} {val}" for key, val in out.items())
                    + (" (equal to plain)" if same else ""), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Times design variants of the tile-walk kernels K4 (the round walk and its
single round) and K5 (the fused walk, closest and any hit) on one NVIDIA GPU.

    python3 tile_walk_variants.py [names] [--tile N] [--scale S]

The package ships one form of each in csrc/tile_walk.cu and no switch. This
script makes the other forms that were tried from that source in memory
(every patch must match the source exactly once; other forms are appended
whole), builds each with nvcc beside the shipped form, runs all of them (or
the named ones, with the shipped form) on chip_smoke.py's three interior
wavefronts in the tile mode (camera 512x512; 2^17 sorted bounce rays, a
quarter of the lanes dead; 3 x 2^16 connection segments, a third masked),
checks the shipped forms against their plain versions (`torch.equal`,
cull off, as timed) and every variant against the shipped form, and prints
each kernel alone: the least of 3 replays of a CUDA graph of 20 launches
(chip_smoke.graph_ms). --tile N gives the K4 kinds tiles of N rays (default
the tile mode's 256); --scale S (default 4) takes the interior at scale S
instead and times K5 any alone on its 2^16-ray connection wavefront (at 14:
399,856 triangles, 17,197 tile clusters); a variant above the clusters its
shared memory holds (MAX_CLUSTERS_OF) is skipped there. The variants:
  K4 walk   stage1     one staging buffer, filled after the round's bound
                       is known (no copy in flight during the tests);
            direct     no staging: the slots are read from the block in
                       global memory (L2) by every thread;
            wide_blocks  the first form of tiles above 256 (PR 17): one
                       thread a ray, blocks of 512 and 1,024 threads (the
                       1,024 instance capped at 64 registers);
            wide_skip  wide_blocks with the rays form's per-ray skip;
            rays       the tile on one block of up to 256 threads, 1, 2 or 4
                       rays a thread (a tile still on one SM), a ray
                       skipping a cluster whose tile entry is at or past
                       its own min(best_t, tmax);
            rays_unpruned  the rays form without its per-ray skip;
  K4 round  old_round  the first form: every running tile copies its
                       cluster's 9 x 128 floats with scalar loads into
                       shared memory, every ray tests tri_k slots, each test
                       leaving at a failing det;
            split2, split4  a ray's slots on 2 (4) threads, lanes 16 (8)
                       apart, and their lex-min by shuffles;
  K5 closest old_closest  the first form: one block per 128-ray tile, one
                       thread a ray, entry bounds of all C clusters in
                       shared memory, a block-wide lexicographic next
                       cluster over all C every round, the tile's block max
                       of min(best_t, tmax), the whole 9 x 128 block staged,
                       tri_k slots a ray, the tile in lock step;
            rays32, rays16  groups of 32 (16) rays a warp, 1 (2) threads a
                       ray, instead of 8 rays and 4 threads;
            ldg        the slots read in place through the read-only data
                       path (__ldg);
            stream     the shared group walk's streamed form (K6 closest's
                       streamed one): each warp stages its position's slots
                       below tri_count into a double buffer with cp.async,
                       the next position in flight while one is tested,
                       instead of reading them in place from L2;
            prologue   the walk cut off: the shared prologue alone (hull,
                       compaction, sort; returns misses: a floor, not
                       compared);
  K5 any    old_any    the form before its first redesign: the old closest
                       form's walk with an any-hit stop, every lane
                       occluded or dead;
            any_sorted the form of PRs 7-17: the tile's clusters in reach
                       sorted near to far once by (entry, id) in shared
                       memory (8 bytes a cluster, padded to a power of
                       two: at most 16,384 clusters) and walked with the
                       shipped form's staged rounds, no cut by the entry;
            any_unpruned  the shipped stream without its cuts by the tile
                       entry (every cluster in reach kept, every lane still
                       looking testing it);
            any_one_part  the shipped stream in one part a tile (a block
                       walks the whole set);
            any_span2048, any_span1024  a part every 2,048 (1,024)
                       clusters, up to 16 parts, in place of every 256 up
                       to 64;
            any_span512  a part every 512 clusters, up to 32 parts;
            any_no_compact  the shipped stream with each ray on its own
                       thread throughout (no packing of the rays still
                       looking);
            any_compact_chunks  the rays packed at each chunk scan only,
                       not every 8 rounds;
            any_stages2, any_stages8  the shipped stream with a ring of 2
                       (one cluster in flight, as the sorted form) or 8
                       staged clusters in place of 4;
            any_warp   one warp per 32 rays, 4 a block, nothing shared: each
                       warp reduces its own bounds with shuffles, streams
                       the set 32 clusters a ballot with the shipped form's
                       cuts by the entry and reads the slots from L2; no
                       block barrier;
            any_const_stride  the staging loop's stride the constant kTile
                       (the block's size) instead of blockDim.x;
  K4 walk, K5 any  all_slots  every slot below tri_k staged and tested, not
                       only those below the cluster's triangle count.
The last line is one JSON object with the card, its power limit and every
time. Needs a card, nvcc, and chip_smoke.py beside it. Nothing holds the
shipped source to these patches: once it changes so that one no longer
matches, the script stops and names the patch, and that variant is to be
written anew or dropped.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

# --- the first forms' helpers, appended before the forms that use them ------

_OLD_HELPERS = r'''
namespace {
constexpr int kOldWarps = kTile / 32;

// Rows 0..8 of cluster `cid`'s block into shared memory, s[row * 128 + slot].
__device__ __forceinline__ void stage_block(float* s,
                                            const float* __restrict__ blocks,
                                            int cid) {
  const float* b = blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
  for (int j = threadIdx.x; j < kTriRows * kSlots; j += blockDim.x)
    s[j] = __ldg(b + j);
}

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

__device__ __forceinline__ void lex_min(float& e, int& c, float oe, int oc) {
  if (oe < e || (oe == e && oc < c)) {
    e = oe;
    c = oc;
  }
}

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
  for (int w = 1; w < kOldWarps; ++w) lex_min(be, bc, red_e[w], red_c[w]);
  __syncthreads();
  e_out = be;
  c_out = bc;
}
}  // namespace
'''

_OLD_CLOSEST = _OLD_HELPERS + r'''
namespace {
__global__ void __launch_bounds__(kTile)
old_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax,
                   const float* __restrict__ cmin,
                   const float* __restrict__ cmax,
                   const int* __restrict__ tri_begin,
                   const float* __restrict__ blocks, int c_total, int tri_k,
                   int cull, float* __restrict__ out_t,
                   int* __restrict__ out_tri, float* __restrict__ out_u,
                   float* __restrict__ out_v) {
  extern __shared__ float smem_old[];
  float* blk = smem_old;
  float* entries = smem_old + kTriRows * kSlots;
  __shared__ float red_e[kOldWarps];
  __shared__ int red_c[kOldWarps];
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  const Hull h = block_hull<kTile>(r, tmn, tmx, red_e);
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
    const float bound = block_max<kTile>(fminf(best_t, tmx), red_e);
    if (!(e < kBig && e <= bound)) break;
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
    __syncthreads();
    last_e = e;
    last_c = cid;
  }
  out_t[i] = best_t;
  out_tri[i] = best_id;
  out_u[i] = best_u;
  out_v[i] = best_v;
}
}  // namespace

extern "C" int tile_walk_closest_old(const float* o, const float* d,
                                     const float* tmin, const float* tmax,
                                     const float* cmin, const float* cmax,
                                     const int* tri_begin,
                                     const float* blocks,
                                     const int* tri_count, int n,
                                     int c_total, int cull, int tri_k,
                                     float* out_t, int* out_tri,
                                     float* out_u, float* out_v,
                                     void* stream) {
  const size_t smem = sizeof(float) * (kTriRows * kSlots + c_total);
  const int err = allow_shared(old_closest_kernel, smem);
  if (err) return err;
  old_closest_kernel<<<n / kTile, kTile, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, tri_begin, blocks, c_total, tri_k, cull,
      out_t, out_tri, out_u, out_v);
  return static_cast<int>(cudaGetLastError());
}
'''

_OLD_ROUND = _OLD_HELPERS + r'''
namespace {
__global__ void __launch_bounds__(kRoundLanes)
old_round_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
  if (run[tile]) {
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
}  // namespace

extern "C" int tile_round_old(const float* o, const float* d,
                              const float* tmin, const float* tmax_eff,
                              const int* cid, const unsigned char* run,
                              const float* blocks, const int* tri_count,
                              int nt, int r, int tri_k, int cull,
                              float* out_t, float* out_u, float* out_v,
                              float* out_dn, int* out_slot, void* stream) {
  old_round_kernel<<<nt, r, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax_eff, cid, run, blocks, tri_k, cull, out_t, out_u,
      out_v, out_dn, out_slot);
  return static_cast<int>(cudaGetLastError());
}
'''


def _split_round(split: int) -> str:
    """K4's single round with a ray's slots on `split` threads."""
    return r'''
namespace {
template <int kSplit>
__global__ void __launch_bounds__(kRoundLanes * kSplit)
split_round_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax_eff,
                   const int* __restrict__ cid,
                   const unsigned char* __restrict__ run,
                   const float* __restrict__ blocks,
                   const int* __restrict__ tri_count, int tri_k, int cull,
                   float* __restrict__ out_t, float* __restrict__ out_u,
                   float* __restrict__ out_v, float* __restrict__ out_dn,
                   int* __restrict__ out_slot) {
  constexpr int kRays = 32 / kSplit;   // rays a warp; lane = kRays q + ray
  extern __shared__ __align__(16) float stage[];
  const int tile = blockIdx.x, lane = threadIdx.x & 31;
  const int q = lane / kRays;
  const int rays = blockDim.x / kSplit;
  const size_t i = static_cast<size_t>(tile) * rays +
                   (threadIdx.x >> 5) * kRays + lane % kRays;
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int bs = kSlots;
  if (run[tile]) {
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
    if (tmx > tmn) {
      for (int k = q; k < cnt; k += kSplit) {
        float t, u, v;
        if (mt_test<false>(r, stage, 4 * kq, k, cull != 0, tmn, tmx, t, u,
                           v) && t < bt) {
          bt = t;
          bu = u;
          bv = v;
          bs = k;
        }
      }
    }
    lex_min_threads<kRays>(bt, bs, bu, bv);
  }
  if (q == 0) {
    out_t[i] = bt;
    out_u[i] = bu;
    out_v[i] = bv;
    out_dn[i] = 1.0f;
    out_slot[i] = bs;
  }
}
}  // namespace

extern "C" int tile_round_split(const float* o, const float* d,
                                const float* tmin, const float* tmax_eff,
                                const int* cid, const unsigned char* run,
                                const float* blocks, const int* tri_count,
                                int nt, int r, int tri_k, int cull,
                                float* out_t, float* out_u, float* out_v,
                                float* out_dn, int* out_slot, void* stream) {
  const size_t smem = sizeof(float) * kTriRows * 4 * ((tri_k + 3) / 4);
  split_round_kernel<SPLIT><<<nt, r * SPLIT, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax_eff, cid, run, blocks, tri_count, tri_k, cull, out_t,
      out_u, out_v, out_dn, out_slot);
  return static_cast<int>(cudaGetLastError());
}
'''.replace("SPLIT", str(split))


_OLD_ANY = _OLD_HELPERS + r'''
namespace {
__global__ void __launch_bounds__(kTile)
old_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               const float* __restrict__ cmin, const float* __restrict__ cmax,
               const float* __restrict__ blocks, int c_total, int tri_k,
               int* __restrict__ out_occ) {
  extern __shared__ float smem_old[];
  float* blk = smem_old;
  float* entries = smem_old + kTriRows * kSlots;
  __shared__ float red_e[kOldWarps];
  __shared__ int red_c[kOldWarps];
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i), tmx = __ldg(tmax + i);
  const Hull h = block_hull<kTile>(r, tmn, tmx, red_e);
  for (int c = threadIdx.x; c < c_total; c += kTile)
    entries[c] = hull_entry(h, cmin, cmax, c);
  __syncthreads();
  bool occ = false;
  float last_e = -kBig;
  int last_c = -1;
  while (true) {
    float e;
    int cid;
    next_cluster(entries, c_total, last_e, last_c, red_e, red_c, e, cid);
    const bool run = !__syncthreads_and(occ || tmx < tmn) && e < kBig;
    if (!run) break;
    stage_block(blk, blocks, cid);
    __syncthreads();
    if (!occ && tmx > tmn) {
      for (int k = 0; k < tri_k; ++k) {
        float t, u, v;
        if (mt_slot(r, blk, k, false, tmn, tmx, t, u, v)) {
          occ = true;
          break;
        }
      }
    }
    __syncthreads();
    last_e = e;
    last_c = cid;
  }
  out_occ[i] = occ ? 1 : 0;
}
}  // namespace

extern "C" int tile_walk_any_old(const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const float* cmin, const float* cmax,
                                 const float* blocks, const int* tri_count,
                                 int n, int c_total, int tri_k, int* out_occ,
                                 int* out_rounds, void* stream) {
  const size_t smem = sizeof(float) * (kTriRows * kSlots + c_total);
  const int err = allow_shared(old_any_kernel, smem);
  if (err) return err;
  old_any_kernel<<<n / kTile, kTile, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, blocks, c_total, tri_k, out_occ);
  return static_cast<int>(cudaGetLastError());
}
'''

_ANY_WARP = r'''
namespace {
// The hull of the warp's 32 rays (shuffles only).
__device__ __forceinline__ Hull warp_hull(const Ray& r, float tmn, float tmx) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float dv[3] = {r.dx, r.dy, r.dz};
  Hull h;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    h.olo[a] = warp_min(o[a]);
    h.ohi[a] = warp_max(o[a]);
    hull_axis(h, a, warp_min(dv[a]), warp_max(dv[a]));
  }
  h.tmin_lb = warp_min(tmn);
  h.tmax_ub = warp_max(tmx);
  return h;
}

constexpr int kAnyWarps = 4;  // 32-ray groups a block of any_warp_kernel

// One warp per 32 rays with its own hull, nothing shared: the set streamed
// in id order 32 clusters a ballot (kept below the warp's bound, the
// shipped form's cuts by the entry), the kept ones walked in turn, the
// slots read from L2, until every lane of the warp is occluded or dead.
__global__ void __launch_bounds__(32 * kAnyWarps)
any_warp_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin, const float* __restrict__ tmax,
                const float* __restrict__ cmin, const float* __restrict__ cmax,
                const float* __restrict__ blocks,
                const int* __restrict__ tri_count, int c_total,
                int* __restrict__ out_occ) {
  const int lane = threadIdx.x & 31;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i), tmx = __ldg(tmax + i);
  const Hull h = warp_hull(r, tmn, tmx);
  bool occ = false;
  const bool dead = tmx < tmn;
  bool done = __all_sync(kFull, dead);
  for (int base = 0; base < c_total && !done; base += 32) {
    const int c = base + lane;
    const float ec = c < c_total ? hull_entry(h, cmin, cmax, c) : kBig;
    const float bound = warp_max(!occ && tmx > tmn ? tmx : -kBig);
    unsigned m = __ballot_sync(kFull, ec < bound);
    for (; m != 0 && !done; m &= m - 1) {
      const int at = __ffs(m) - 1;
      const int cid = base + at;
      const float e = __shfl_sync(kFull, ec, at);
      if (!occ && tmx > tmn && e < tmx)
        occ = any_in_slots<true>(
            r, blocks + static_cast<size_t>(cid) * kBlockRows * kSlots,
            kSlots, __ldg(tri_count + cid), tmn, tmx);
      done = __all_sync(kFull, occ || dead);
    }
  }
  out_occ[i] = occ ? 1 : 0;
}
}  // namespace

extern "C" int tile_walk_any_warp(const float* o, const float* d,
                                  const float* tmin, const float* tmax,
                                  const float* cmin, const float* cmax,
                                  const float* blocks, const int* tri_count,
                                  int n, int c_total, int tri_k, int* out_occ,
                                  int* out_rounds, void* stream) {
  any_warp_kernel<<<n / (32 * kAnyWarps), 32 * kAnyWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, blocks, tri_count, c_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}
'''

# K5 any as PRs 7-17 shipped it: tile_order's near-to-far list of (entry,
# id) keys in shared memory (8 bytes a cluster, padded to a power of two),
# walked with the staged rounds of the shipped form; at most 16,384
# clusters (MAX_CLUSTERS_OF)
_ANY_SORTED = r'''
namespace {
__global__ void __launch_bounds__(kTile)
sorted_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
}  // namespace

extern "C" int tile_walk_any_sorted(const float* o, const float* d,
                                    const float* tmin, const float* tmax,
                                    const float* cmin, const float* cmax,
                                    const float* blocks, const int* tri_count,
                                    int n, int c_total, int tri_k,
                                    int* out_occ, int* out_rounds,
                                    void* stream) {
  const size_t smem = sizeof(float) * 2 * kTriRows * 4 * ((tri_k + 3) / 4) +
                      sizeof(unsigned long long) * pow2_at_least(c_total);
  const int err = allow_shared(sorted_any_kernel, smem);
  if (err) return err;
  sorted_any_kernel<<<n / kTile, kTile, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, blocks, tri_count, c_total, tri_k,
      out_occ);
  return static_cast<int>(cudaGetLastError());
}
'''

# K4's walk on one block of up to 256 threads, R = 1, 2 or 4 rays a thread
# (a tile of 256 R rays on one SM), each ray skipping a round's cluster
# whose tile entry lies at or past its own min(best_t, tmax)
_RAYS_FORM = r'''
namespace {
template <int kRays>
__global__ void __launch_bounds__(kRoundLanes)
rays_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
  const int lanes = blockDim.x, tid = threadIdx.x, nw = lanes >> 5;
  const int kq = (tri_k + 3) >> 2, ks = 4 * kq;
  const size_t tile = blockIdx.x;
  // ray q of this thread: lane q * blockDim.x + tid of the tile
  Ray r[kRays];
  float tmn[kRays], tmx[kRays], best_t[kRays], best_u[kRays], best_v[kRays];
  int best_id[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const size_t i = (tile * kRays + q) * lanes + tid;
    r[q] = load_ray(o, d, i);
    tmn[q] = __ldg(tmin + i);
    tmx[q] = __ldg(tmax + i);
    best_t[q] = kBig;
    best_u[q] = 0.0f;
    best_v[q] = 0.0f;
    best_id[q] = -1;
  }
  const float* erow = entries + tile * n_cols;
  const int* irow = ids + tile * n_cols;

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
    float m = fminf(best_t[0], tmx[0]);
#pragma unroll
    for (int q = 1; q < kRays; ++q) m = fmaxf(m, fminf(best_t[q], tmx[q]));
    m = warp_max(m);
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
    if constexpr (kRays == 1) {
      const float tmax_eff = fminf(best_t[0], tmx[0]);
      if (tmax_eff > tmn[0]) {
        float cb = kBig, cu = 0.0f, cv = 0.0f;
        int cs = kSlots;
        closest_in_stage(r[0], cur, ks, cnt, cull != 0, tmn[0], tmax_eff, cb,
                         cu, cv, cs);
        if (cb < best_t[0]) {
          best_t[0] = cb;
          best_id[0] = __ldg(tri_begin + cid) + cs;
          best_u[0] = cu;
          best_v[0] = cv;
        }
      }
    } else {
      // a ray tests the cluster only where its tile entry e lies below the
      // ray's own min(best_t, tmax): e bounds below every hit t of the
      // tile's rays in the cluster (the stop's own premise), so no hit of a
      // ray past it passes t < tmax_eff; a warp whose rays are all past it
      // skips the slot loop
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        const float tmax_eff = fminf(best_t[q], tmx[q]);
        if (tmax_eff > tmn[q] && e < tmax_eff) {
          float cb = kBig, cu = 0.0f, cv = 0.0f;
          int cs = kSlots;
          closest_in_stage(r[q], cur, ks, cnt, cull != 0, tmn[q], tmax_eff,
                           cb, cu, cv, cs);
          if (cb < best_t[q]) {
            best_t[q] = cb;
            best_id[q] = __ldg(tri_begin + cid) + cs;
            best_u[q] = cu;
            best_v[q] = cv;
          }
        }
      }
    }
  }
  wait_all();  // a copy still in flight after the stop
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const size_t i = (tile * kRays + q) * lanes + tid;
    out_t[i] = best_t[q];
    out_tri[i] = best_id[q];
    out_u[i] = best_u[q];
    out_v[i] = best_v[q];
  }
  if (tid == 0) out_rounds[tile] = rnd;
}

}  // namespace

extern "C" int tile_round_walk_rays_form(const float* o, const float* d,
                                         const float* tmin, const float* tmax,
                                         const float* entries, const int* ids,
                                         const float* blocks,
                                         const int* tri_begin,
                                         const int* tri_count, int nt, int r,
                                         int n_cols, int tri_k, int cull,
                                         float* out_t, int* out_tri,
                                         float* out_u, float* out_v,
                                         int* out_rounds, void* stream) {
  const size_t smem = sizeof(float) * 2 * kTriRows * 4 * ((tri_k + 3) / 4);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rays = r <= kRoundLanes ? 1 : r <= 2 * kRoundLanes ? 2 : 4;
  auto launch = [&](auto kernel) {
    kernel<<<nt, r / rays, smem, st>>>(o, d, tmin, tmax, entries, ids, blocks,
                                       tri_begin, tri_count, n_cols, tri_k,
                                       cull, out_t, out_tri, out_u, out_v,
                                       out_rounds);
  };
  if (rays == 1)
    launch(rays_walk_kernel<1>);
  else if (rays == 2)
    launch(rays_walk_kernel<2>);
  else
    launch(rays_walk_kernel<4>);
  return static_cast<int>(cudaGetLastError());
}
'''

# K4's walk at tiles above 256 as PR 17 built it: one thread a ray, a
# template on the block (256, 512, 1,024 threads); the 1,024 instance capped
# at 64 registers by its launch bounds
_WIDE_BLOCKS = r'''
namespace {
template <int kLanes>
__global__ void __launch_bounds__(kLanes)
block_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
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
  __shared__ float se[kLanes];  // a block-width of rounds of the visit order
  __shared__ int sc[kLanes];
  __shared__ int sk[kLanes];    // their clusters' triangle counts
  __shared__ float red[kLanes / 32];
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
}  // namespace

extern "C" int tile_round_walk_blocks(const float* o, const float* d,
                                      const float* tmin, const float* tmax,
                                      const float* entries, const int* ids,
                                      const float* blocks,
                                      const int* tri_begin,
                                      const int* tri_count, int nt, int r,
                                      int n_cols, int tri_k, int cull,
                                      float* out_t, int* out_tri,
                                      float* out_u, float* out_v,
                                      int* out_rounds, void* stream) {
  const size_t smem = sizeof(float) * 2 * kTriRows * 4 * ((tri_k + 3) / 4);
  by_round_lanes(r, [&](auto lanes) {
    block_walk_kernel<decltype(lanes)::value>
        <<<nt, r, smem, static_cast<cudaStream_t>(stream)>>>(
            o, d, tmin, tmax, entries, ids, blocks, tri_begin, tri_count,
            n_cols, tri_k, cull, out_t, out_tri, out_u, out_v, out_rounds);
  });
  return static_cast<int>(cudaGetLastError());
}
'''

# --- patches of the shipped source -------------------------------------------

# K4 walk: the first cluster staged before the loop, and each round's copy of
# the next cluster
_WALK_PROLOGUE = """  const int first = __ldg(irow);
  stage_slots(stage, blocks, first, (__ldg(tri_count + first) + 3) >> 2, kq);
  commit();
"""
_WALK_STAGE = """    float* cur = stage + (rnd & 1) * kTriRows * ks;
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
"""
_WALK_STAGE1 = """    float* cur = stage;
    stage_slots(cur, blocks, cid, (cnt + 3) >> 2, kq);
    commit();
    wait_all();
"""
_WALK_DIRECT = """    const float* cur =
        blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
"""
_WALK_DRAIN = "  wait_all();  // a copy still in flight after the stop\n"
_WALK_TEST = "closest_in_stage(r, cur, ks, cnt,"
# the rays form's per-ray skip by the cluster's tile entry; K5 any's skip
# by it and its chunk bound, and its ring
_RAYS_SKIP = "if (tmax_eff > tmn[q] && e < tmax_eff) {"
_ANY_SKIP = "if (holds && !occ && tmx > tmn && e < tmx) {"
_ANY_CHUNK_BOUND = "chunk_bound(holds && !occ && tmx > tmn, tmx, red)"
_ANY_PACK = "    const bool looking = holds && !occ && tmx > tmn;\n"
_ANY_COMPACT_ROUNDS = "constexpr int kAnyCompactRounds = 8;"
_ANY_STAGES = "constexpr int kAnyStages = 4;"
_ANY_SPAN = "constexpr int kAnyPartClusters = 256;"
_ANY_MAX_PARTS = "constexpr int kAnyMaxParts = 64;"
_WIDE_TEST = """    const float tmax_eff = fminf(best_t, tmx);
    if (tmax_eff > tmn) {"""
_ANY_TEST = "ks, cnt,\n                                tmn, tmx);"
_ANY_STAGE = ("(__ldg(tri_count + c) + 3) >> 2, kq);",)

# K5 closest
_RAYS = "constexpr int kClosestRays = 8;"
_CLOSEST_BUF = "  float* buf = nullptr;  // the slots are read in place\n"
_CLOSEST_WALK = "closest_group_walk<kClosestRays, false, kEntry>("
_CLOSEST_CALL = """  const GroupHit h = closest_group_walk<kClosestRays, false, kEntry>(
      r, tmn, tmx, count, cull, 1, blocks, tri_count, buf, lane,"""
_CLOSEST_SMEM = """  const size_t smem = sizeof(unsigned long long) * pow2_at_least(c_total);
  auto launch = [&](auto kernel) {"""


def _once(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, f"patch matches {src.count(old)} times:\n{old}"
    return src.replace(old, new)


def _stage1(src: str) -> str:
    return _once(_once(src, _WALK_STAGE, _WALK_STAGE1), _WALK_PROLOGUE, "")


def _direct(src: str) -> str:
    src = _once(_once(src, _WALK_STAGE, _WALK_DIRECT), _WALK_PROLOGUE, "")
    src = _once(src, _WALK_DRAIN, "")
    return _once(src, _WALK_TEST, _WALK_TEST.replace(", ks,", ", kSlots,"))


def _all_slots(src: str) -> str:
    """K4's walk and K5 any: all tri_k slots staged and tested."""
    src = _once(src, _WALK_PROLOGUE, _WALK_PROLOGUE.replace(
        "(__ldg(tri_count + first) + 3) >> 2", "kq"))
    src = _once(src, "                  (ncnt + 3) >> 2, kq);",
                "                  kq, kq);")
    for test in (_WALK_TEST, _ANY_TEST):
        src = _once(src, test, test.replace("cnt,", "tri_k,"))
    for stage in _ANY_STAGE:
        src = _once(src, stage, "kq, kq);")
    return src


def _stream(src: str) -> str:
    """K5 closest with each warp's slots staged into a double buffer: the
    streamed form of the shared group walk (K6 closest's), its buffers
    after the keys in shared memory."""
    src = _once(src, _CLOSEST_BUF, """\
  float* buf = reinterpret_cast<float*>(keys + pow2_at_least(c_total)) +
               warp * 2 * kStage;
""")
    src = _once(src, _CLOSEST_WALK, _CLOSEST_WALK.replace("false", "true"))
    return _once(src, _CLOSEST_SMEM, _CLOSEST_SMEM.replace(
        "pow2_at_least(c_total);", "pow2_at_least(c_total) +\n"
        "      sizeof(float) * 2 * kStage * kClosestWarps;"))


def _prologue(src: str) -> str:
    """K5 closest with its walk cut off (its count written as the triangle
    id, so that nothing of the prologue is dropped)."""
    return _once(src, _CLOSEST_CALL, """\
  const GroupHit h{kBig, 0.0f, 0.0f, count, 0, 0};  // the prologue alone
  if (false) closest_group_walk<kClosestRays, false, kEntry>(
      r, tmn, tmx, count, cull, 1, blocks, tri_count, buf, lane,""")


_MT_LOADS = """  const float p0x = s[0 * kSlots + k], p0y = s[1 * kSlots + k],
              p0z = s[2 * kSlots + k];
  const float e1x = s[3 * kSlots + k], e1y = s[4 * kSlots + k],
              e1z = s[5 * kSlots + k];
  const float e2x = s[6 * kSlots + k], e2y = s[7 * kSlots + k],
              e2z = s[8 * kSlots + k];
"""


def _ldg(src: str) -> str:
    """K5 closest's in-place slot reads through the read-only data path."""
    return _once(src, _MT_LOADS, _MT_LOADS.replace("s[", "__ldg(s + ").replace(
        " * kSlots + k]", " * kSlots + k)"))


def _rays_unpruned(src: str) -> str:
    """The rays form without its per-ray skip: every ray with tmax_eff
    above its tmin tests every round's cluster."""
    return src + _once(_RAYS_FORM, _RAYS_SKIP, "if (tmax_eff > tmn[q]) {")


def _wide_skip(src: str) -> str:
    """The first wide form (one thread a ray, blocks up to 1,024) with the
    rays form's per-ray skip."""
    return src + _once(_WIDE_BLOCKS, _WIDE_TEST, _WIDE_TEST.replace(
        "(tmax_eff > tmn)", "(tmax_eff > tmn && e < tmax_eff)"))


def _any_unpruned(src: str) -> str:
    """K5 any streamed without the tile entry's cuts: every chunk keeps the
    clusters in reach, every lane still looking tests each of them."""
    src = _once(src, _ANY_SKIP, "if (holds && !occ && tmx > tmn) {")
    return _once(src, _ANY_CHUNK_BOUND, "kBig")


def _any_split(span: int, parts: int):
    """K5 any with a part of the set every `span` clusters, up to `parts`
    (256 and 64 shipped)."""
    return lambda s: _once(_once(s, _ANY_SPAN, _ANY_SPAN.replace(
        "256", str(span))), _ANY_MAX_PARTS, _ANY_MAX_PARTS.replace(
        "64", str(parts)))


def _any_stages(n: int):
    """K5 any with a ring of n staged clusters (n - 1 rounds ahead)."""
    return lambda s: _once(s, _ANY_STAGES, _ANY_STAGES.replace("4", str(n)))


def _any_const_stride(src: str) -> str:
    """The staging loop with a constant stride (kTile, K5 any's block)."""
    return _once(src, "j < kTriRows * chunks; j += blockDim.x) {",
                 "j < kTriRows * chunks; j += kTile) {")


def _rays(n: int):
    return lambda s: _once(s, _RAYS, _RAYS.replace("8", str(n)))


# name -> (patch of the shipped source, {kernel: its entry point}); a K5
# closest entry that ends in "+tri_k" (the first form) takes tri_k after
# cull and no rounds output
VARIANTS = {
    "shipped": (lambda s: s, {"K4 walk": "tile_round_walk",
                              "K4 round": "tile_round",
                              "K5 closest": "tile_walk_closest",
                              "K5 any": "tile_walk_any"}),
    "stage1": (_stage1, {"K4 walk": "tile_round_walk"}),
    "direct": (_direct, {"K4 walk": "tile_round_walk"}),
    "all_slots": (_all_slots, {"K4 walk": "tile_round_walk",
                               "K5 any": "tile_walk_any"}),
    "old_round": (lambda s: s + _OLD_ROUND, {"K4 round": "tile_round_old"}),
    "split2": (lambda s: s + _split_round(2),
               {"K4 round": "tile_round_split"}),
    "split4": (lambda s: s + _split_round(4),
               {"K4 round": "tile_round_split"}),
    "old_closest": (lambda s: s + _OLD_CLOSEST,
                    {"K5 closest": "tile_walk_closest_old+tri_k"}),
    "rays32": (_rays(32), {"K5 closest": "tile_walk_closest"}),
    "rays16": (_rays(16), {"K5 closest": "tile_walk_closest"}),
    "stream": (_stream, {"K5 closest": "tile_walk_closest"}),
    "ldg": (_ldg, {"K5 closest": "tile_walk_closest"}),
    "prologue": (_prologue, {"K5 closest": "tile_walk_closest"}),
    "wide_blocks": (lambda s: s + _WIDE_BLOCKS,
                    {"K4 walk": "tile_round_walk_blocks"}),
    "wide_skip": (_wide_skip, {"K4 walk": "tile_round_walk_blocks"}),
    "rays": (lambda s: s + _RAYS_FORM,
             {"K4 walk": "tile_round_walk_rays_form"}),
    "rays_unpruned": (_rays_unpruned,
                      {"K4 walk": "tile_round_walk_rays_form"}),
    "any_unpruned": (_any_unpruned, {"K5 any": "tile_walk_any"}),
    "any_stages2": (_any_stages(2), {"K5 any": "tile_walk_any"}),
    "any_no_compact": (lambda s: _once(s, _ANY_PACK, "    return;  // only "
                                       "the other parts' finds\n" + _ANY_PACK),
                       {"K5 any": "tile_walk_any"}),
    "any_compact_chunks": (lambda s: _once(
        s, _ANY_COMPACT_ROUNDS, _ANY_COMPACT_ROUNDS.replace("8", "1 << 30")),
        {"K5 any": "tile_walk_any"}),
    "any_one_part": (_any_split(256, 1), {"K5 any": "tile_walk_any"}),
    "any_span2048": (_any_split(2048, 16), {"K5 any": "tile_walk_any"}),
    "any_span1024": (_any_split(1024, 16), {"K5 any": "tile_walk_any"}),
    "any_span512": (_any_split(512, 32), {"K5 any": "tile_walk_any"}),
    "any_stages8": (_any_stages(8), {"K5 any": "tile_walk_any"}),
    "old_any": (lambda s: s + _OLD_ANY, {"K5 any": "tile_walk_any_old"}),
    "any_sorted": (lambda s: s + _ANY_SORTED,
                   {"K5 any": "tile_walk_any_sorted"}),
    "any_warp": (lambda s: s + _ANY_WARP, {"K5 any": "tile_walk_any_warp"}),
    "any_const_stride": (_any_const_stride, {"K5 any": "tile_walk_any"}),
}
FLOORS = ("prologue",)   # not the same function: timed, not compared
# the most clusters a variant takes (its shared memory); larger sets skip it
MAX_CLUSTERS_OF = {"any_sorted": 1 << 14, "old_closest": 1 << 14}
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"K4 walk": [_P] * 9 + [_I] * 5 + [_P] * 6,
            "K4 round": [_P] * 8 + [_I] * 4 + [_P] * 6,
            "K5 closest": [_P] * 9 + [_I] * 3 + [_P] * 7,
            "K5 any": [_P] * 8 + [_I] * 3 + [_P] * 3}
# the first form of K5 closest: tri_k after cull, no rounds or entry output
ARGTYPES_TRI_K = [_P] * 9 + [_I] * 4 + [_P] * 5


def build_variant(name: str, out_dir: str) -> tuple:
    """Patch, compile and load one variant -> (ctypes library, registers)."""
    from spcbpt_tpu_torch.kernels import build
    src = VARIANTS[name][0](build.source("tile_walk"))
    cu = os.path.join(out_dir, f"tile_walk_{name}.cu")
    so = os.path.join(out_dir, f"libtile_walk_{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{res.stderr}")
    regs = [line.strip() for line in res.stderr.splitlines()
            if "Used " in line]
    lib = ctypes.CDLL(so)
    for kind, entry in VARIANTS[name][1].items():
        fn, _, extra = entry.partition("+")
        getattr(lib, fn).argtypes = ARGTYPES_TRI_K if extra else \
            ARGTYPES[kind]
    return lib, regs


def launcher(kind: str, lib, entry: str, inputs: dict):
    """A closure that allocates `kind`'s outputs, launches `entry` of `lib`
    on the current stream (taken at each launch, so that it can be captured
    in a CUDA graph) and returns the outputs."""
    fn_name, _, extra = entry.partition("+")
    fn = getattr(lib, fn_name)
    x = inputs[kind]
    ptr = lambda *ts: [t.data_ptr() for t in ts]

    def run():
        dev = x["dev"]
        stream = torch.cuda.current_stream(dev).cuda_stream
        f32 = lambda shape: torch.empty(shape, device=dev)
        i32 = lambda shape: torch.empty(shape, dtype=torch.int32, device=dev)
        if kind == "K4 walk":
            nt, r = x["nt"], x["r"]
            out = (f32((nt, r)), i32((nt, r)), f32((nt, r)), f32((nt, r)),
                   i32((nt,)))
            err = fn(*ptr(*x["args"]), nt, r, x["n_cols"], x["tri_k"], 0,
                     *ptr(*out), stream)
        elif kind == "K4 round":
            nt, r = x["nt"], x["r"]
            out = (f32((nt, r)), f32((nt, r)), f32((nt, r)), f32((nt, r)),
                   i32((nt, r)))
            err = fn(*ptr(*x["args"]), nt, r, x["tri_k"], 0, *ptr(*out),
                     stream)
        elif kind == "K5 closest":
            n = x["n"]
            out = (f32((n,)), i32((n,)), f32((n,)), f32((n,)))
            err = fn(*ptr(*x["args"]), n, x["c"], 0, x["tri_k"], *ptr(*out),
                     stream) if extra else fn(*ptr(*x["args"]), n, x["c"], 0,
                                              *ptr(*out), None, None, stream)
        else:   # the shipped form sets flags in place: zero first
            out = (torch.zeros((x["n"],), dtype=torch.int32, device=dev),)
            err = fn(*ptr(*x["args"]), x["n"], x["c"], x["tri_k"],
                     *ptr(*out), None, stream)
        assert err == 0, (entry, err)
        return out
    return run


def inputs_of(cs, o, d, tmax, tseg, dev, tile: int = 0) -> tuple:
    """Each kernel's inputs on one wavefront as its wrapper prepares them
    (K4: sorted, padded, tiles of `tile` rays (default the tile mode's
    TILE_LANES) busiest first, round 0 for the single round; K5: sorted and
    padded; any hit on the segment ends `tseg`), and the plain versions'
    outputs, cull off."""
    from spcbpt_tpu_torch.ops import pallas_tile, tile_trace
    from spcbpt_tpu_torch.scene.scene import TILE_LANES

    tile = tile or TILE_LANES
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    _, so, sd, stn, stx = tile_trace.sort_rays_live(cs, o, d, tmin, tmax)
    po, pd, ptn, ptx, _ = tile_trace._pad_rays(so, sd, stn, stx, tile)
    entries, ids, o_t, d_t, tmin_t, tmax_t, _, nt = tile_trace._prepare(
        cs, po, pd, ptn, ptx, tile)
    run0 = entries[:, 0] < 1e30
    cid0 = ids[:, 0].contiguous()
    qo, qd, qtn, qtx, _, _ = pallas_tile.prepare(cs, o, d, tmin, tmax, True)
    qseg = pallas_tile.prepare(cs, o, d, tmin, tseg, True)[3]
    c, k, nq = cs.num_clusters, cs.tri_k, qo.shape[0]
    common = dict(dev=dev, tri_k=k, c=c)
    inputs = {
        "K4 walk": dict(common, nt=nt, r=tile, n_cols=c, args=(
            o_t, d_t, tmin_t, tmax_t, entries, ids, cs.tri_block,
            cs.tri_begin, cs.tri_count)),
        "K4 round": dict(common, nt=nt, r=tile, args=(
            o_t, d_t, tmin_t, tmax_t, cid0, run0, cs.tri_block,
            cs.tri_count)),
        "K5 closest": dict(common, n=nq, args=(
            qo, qd, qtn, qtx, cs.cmin, cs.cmax, cs.tri_begin, cs.tri_block,
            cs.tri_count)),
        "K5 any": dict(common, n=nq, args=(
            qo, qd, qtn, qseg, cs.cmin, cs.cmax, cs.tri_block,
            cs.tri_count))}
    plain = {
        "K4 walk": lambda: tile_trace._in_buckets(
            lambda *a: tile_trace._round_walk(
                *a, False, pallas_tile.mt_round_blocks_plain))(
            cs, entries, ids, o_t, d_t, tmin_t, tmax_t),
        "K4 round": lambda: pallas_tile.mt_round_blocks_plain(
            o_t, d_t, cs.tri_block, cs.tri_count, cid0, run0, tmin_t, tmax_t,
            k, False),
        "K5 closest": lambda: pallas_tile.closest_tiles_plain(
            cs, qo, qd, qtn, qtx, False),
        "K5 any": lambda: (pallas_tile.any_tiles_plain(
            cs, qo, qd, qtn, qseg),)}
    return inputs, plain


def _any_rounds(x: dict) -> dict:
    """The shipped K5 any's own work on its inputs `x` (its rounds output):
    the clusters its tiles visited (sum, largest, 99th percentile) and the
    slots their lanes tested."""
    from spcbpt_tpu_torch.kernels import tile_walk

    o, d, tmn, tmx, cmin, cmax, blocks, count = x["args"]
    rounds = torch.empty((x["n"] // tile_walk.TILE, 2), dtype=torch.int32,
                         device=x["dev"])
    tile_walk.walk_any(o, d, tmn, tmx, cmin, cmax, blocks, count, x["tri_k"],
                       rounds)
    visits = rounds[:, 0].double()
    return {"K5 any visits sum": int(visits.sum()),
            "K5 any visits max": int(visits.max()),
            "K5 any visits p99": int(torch.quantile(visits, 0.99)),
            "K5 any tests": int(rounds[:, 1].long().sum())}


def _options(argv: list) -> tuple:
    """(variant names, --scale, --tile) of the command line."""
    names, scale, tile = [], 4, 0
    it = iter(argv)
    for a in it:
        if a in ("--scale", "--tile"):
            value = int(next(it))
            scale, tile = (value, tile) if a == "--scale" else (scale, value)
        else:
            names.append(a)
    return names, scale, tile


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tile_walk_variants: no CUDA device is available")
    import chip_smoke   # its wavefronts and timing (it imports this module)
    from spcbpt_tpu_torch.apps.render_cli import generate_interior
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.kernels import build
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    argv, scale, tile = _options(argv)
    names = ["shipped"] + [a for a in argv if a != "shipped"]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: "
                         f"{sorted(VARIANTS)}")
    if len(names) == 1 and not argv:
        names = list(VARIANTS)
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda name: build_variant(name, out_dir), names)))

    dev = torch.device("cuda", 0)
    if scale == 4:
        path = resolve_scene("interior")
        ts, _, cam = load_trace_scene(path, dev)
        kinds = ("K4 walk", "K4 round", "K5 closest", "K5 any")
    else:   # a larger interior: K5 any alone, on its connection wavefront
        path = generate_interior(os.path.join(
            chip_smoke.REPO, "smoke_out", f"interior{scale}"), scale)
        ts = None
        kinds = ("K5 any",)
    tts, _, tcam = load_trace_scene(path, dev, mode="tile")
    cam = cam if ts is not None else tcam
    cam.aspect = 1.0
    cs = tts.clusters
    waves = (chip_smoke.wavefronts(ts, cam, dev) + (
        chip_smoke.connection_wavefront(ts, cam, dev),) if ts is not None
        else (chip_smoke.connection_wavefront(tts, cam, dev, draws=1),))
    print(f"interior scale {scale}: {cs.num_clusters} tile clusters; K4 "
          f"tiles of {tile or 'TILE_LANES'}; kinds {list(kinds)}", flush=True)
    results = {name: {"ptxas": regs} for name, (_, regs) in built.items()}
    for wave, o, d, tmax in waves:
        tseg = chip_smoke.any_segments(wave, tmax, o.shape[0], dev)
        inputs, plain = inputs_of(cs, o, d, tmax, tseg, dev, tile)
        ref = {}
        for kind, fn in plain.items():
            if kind in kinds and (kind != "K4 walk"
                                  or wave.startswith("bounce")):
                ref[kind] = fn()
        for name, (lib, _) in built.items():
            if cs.num_clusters > MAX_CLUSTERS_OF.get(name, cs.num_clusters):
                print(f"{name:11s} {wave:17s} skipped: above its "
                      f"{MAX_CLUSTERS_OF[name]} clusters", flush=True)
                continue
            out = {}
            for kind, entry in VARIANTS[name][1].items():
                if kind not in kinds:
                    continue
                run = launcher(kind, lib, entry, inputs)
                got = run()
                torch.cuda.synchronize()
                if name == "shipped":
                    shipped = got
                    ref_k = ref.get(kind)
                    if ref_k is not None:   # the plain walk's four outputs
                        assert all(torch.equal(a, b) for a, b in
                                   zip(got, ref_k)), \
                            f"shipped {kind} on {wave}: differs from plain"
                    ref[kind, "shipped"] = shipped
                elif name not in FLOORS:
                    assert all(torch.equal(a, b) for a, b in
                               zip(got, ref[kind, "shipped"])), \
                        f"{kind} variant {name} on {wave}: differs from " \
                        f"shipped"
                out[f"{kind} ms"] = chip_smoke.graph_ms(run)
                if kind == "K5 any" and name == "shipped":
                    out.update(_any_rounds(inputs[kind]))
                if kind == "K4 walk":
                    out["K4 rounds max"] = int(got[4].max())
                    out["K4 rounds sum"] = int(got[4].sum())
            if not out:
                continue
            results[name][wave] = out
            print(f"{name:11s} {wave:17s} " + ", ".join(
                f"{key} {val:.4f}" if isinstance(val, float) else
                f"{key} {val}" for key, val in out.items())
                + (" (a floor, not compared)" if name in FLOORS else
                   " (equal to shipped)"), flush=True)
    print(json.dumps({"card": smi, "scale": scale, "tile": tile or None,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

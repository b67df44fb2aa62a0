#!/usr/bin/env python3
"""Times design variants of the tile-walk kernels K4 (the round walk and its
single round) and K5 (the fused walk, closest and any hit) on one NVIDIA GPU.

    python3 tile_walk_variants.py [names]

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
(chip_smoke.graph_ms). The variants:
  K4 walk   stage1     one staging buffer, filled after the round's bound
                       is known (no copy in flight during the tests);
            direct     no staging: the slots are read from the block in
                       global memory (L2) by every thread;
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
  K5 any    old_any    the form before its redesign: the old closest form's
                       walk with an any-hit stop, every lane occluded or
                       dead;
            any_warp   one warp per 32 rays, 4 a block, nothing shared: each
                       warp reduces its own bounds with shuffles, compacts
                       its own candidate list (entry, id) in shared memory,
                       takes the lexicographic successor each round and
                       reads the slots from L2; no block barrier;
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
                                 void* stream) {
  const size_t smem = sizeof(float) * (kTriRows * kSlots + c_total);
  const int err = allow_shared(old_any_kernel, smem);
  if (err) return err;
  old_any_kernel<<<n / kTile, kTile, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, blocks, c_total, tri_k, out_occ);
  return static_cast<int>(cudaGetLastError());
}
'''

_ANY_WARP = _OLD_HELPERS + r'''
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

__device__ __forceinline__ void warp_next(const float* le, const int* lc,
                                          int count, int c_total, int lane,
                                          float last_e, int last_c,
                                          float& e_out, int& c_out) {
  float be = kBig;
  int bc = c_total;
  for (int j = lane; j < count; j += 32) {
    const float e = le[j];
    const int c = lc[j];
    if (e > last_e || (e == last_e && c > last_c)) lex_min(be, bc, e, c);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    lex_min(be, bc, __shfl_xor_sync(kFull, be, m),
            __shfl_xor_sync(kFull, bc, m));
  e_out = be;
  c_out = bc;
}

constexpr int kAnyWarps = 4;  // 32-ray groups a block of any_warp_kernel

__global__ void __launch_bounds__(32 * kAnyWarps)
any_warp_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ tmin, const float* __restrict__ tmax,
                const float* __restrict__ cmin, const float* __restrict__ cmax,
                const float* __restrict__ blocks,
                const int* __restrict__ tri_count, int c_total, int tri_k,
                int* __restrict__ out_occ) {
  extern __shared__ __align__(16) float lists[];  // per warp: entries, ids
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* le = lists + static_cast<size_t>(warp) * 2 * c_total;
  int* lc = reinterpret_cast<int*>(le + c_total);
  const size_t i = (static_cast<size_t>(blockIdx.x) * kAnyWarps + warp) * 32 +
                   lane;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i), tmx = __ldg(tmax + i);
  const Hull h = warp_hull(r, tmn, tmx);
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int base = 0; base < c_total; base += 32) {
    const int c = base + lane;
    const float e = c < c_total ? hull_entry(h, cmin, cmax, c) : kBig;
    const bool keep = e < kBig;
    const unsigned m = __ballot_sync(kFull, keep);
    if (keep) {
      le[count + __popc(m & below)] = e;
      lc[count + __popc(m & below)] = c;
    }
    count += __popc(m);
  }
  __syncwarp();

  bool occ = false;
  const bool dead = tmx < tmn;
  float last_e = -kBig;
  int last_c = -1;
  while (!__all_sync(kFull, occ || dead)) {
    float e;
    int cid;
    warp_next(le, lc, count, c_total, lane, last_e, last_c, e, cid);
    if (!(e < kBig)) break;
    if (!occ && tmx > tmn)
      occ = any_in_slots<true>(
          r, blocks + static_cast<size_t>(cid) * kBlockRows * kSlots, kSlots,
          __ldg(tri_count + cid), tmn, tmx);
    last_e = e;
    last_c = cid;
  }
  out_occ[i] = occ ? 1 : 0;
}
}  // namespace

extern "C" int tile_walk_any_warp(const float* o, const float* d,
                                  const float* tmin, const float* tmax,
                                  const float* cmin, const float* cmax,
                                  const float* blocks, const int* tri_count,
                                  int n, int c_total, int tri_k, int* out_occ,
                                  void* stream) {
  const size_t smem = sizeof(float) * 2 * kAnyWarps * c_total;
  const int err = allow_shared(any_warp_kernel, smem);
  if (err) return err;
  any_warp_kernel<<<n / (32 * kAnyWarps), 32 * kAnyWarps, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, cmin, cmax, blocks, tri_count, c_total, tri_k,
      out_occ);
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
_ANY_TEST = "ks, cnt,\n                                tmn, tmx);"

# K5 closest
_RAYS = "constexpr int kClosestRays = 8;"
_CLOSEST_BUF = "  float* buf = nullptr;  // the slots are read in place\n"
_CLOSEST_WALK = "closest_group_walk<kClosestRays, false>("
_CLOSEST_CALL = """  const GroupHit h = closest_group_walk<kClosestRays, false>(
      r, tmn, tmx, count, cull, 1, blocks, tri_count, buf, lane,"""
_CLOSEST_SMEM = """  const size_t smem = sizeof(unsigned long long) * pow2_at_least(c_total);
  const int err = allow_shared(closest_walk_kernel, smem);"""


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
    src = _once(src, _WALK_TEST, _WALK_TEST.replace("cnt,", "tri_k,"))
    return _once(src, _ANY_TEST, _ANY_TEST.replace("cnt,", "tri_k,"))


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
  if (false) closest_group_walk<kClosestRays, false>(
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
    "old_any": (lambda s: s + _OLD_ANY, {"K5 any": "tile_walk_any_old"}),
    "any_warp": (lambda s: s + _ANY_WARP, {"K5 any": "tile_walk_any_warp"}),
    "any_const_stride": (_any_const_stride, {"K5 any": "tile_walk_any"}),
}
FLOORS = ("prologue",)   # not the same function: timed, not compared
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {"K4 walk": [_P] * 9 + [_I] * 5 + [_P] * 6,
            "K4 round": [_P] * 8 + [_I] * 4 + [_P] * 6,
            "K5 closest": [_P] * 9 + [_I] * 3 + [_P] * 6,
            "K5 any": [_P] * 8 + [_I] * 3 + [_P] * 2}


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
        getattr(lib, fn).argtypes = ARGTYPES[kind][:12] + [_I] + \
            ARGTYPES[kind][13:] if extra else ARGTYPES[kind]
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
                                              *ptr(*out), None, stream)
        else:
            out = (i32((x["n"],)),)
            err = fn(*ptr(*x["args"]), x["n"], x["c"], x["tri_k"],
                     *ptr(*out), stream)
        assert err == 0, (entry, err)
        return out
    return run


def inputs_of(cs, o, d, tmax, tseg, dev) -> tuple:
    """Each kernel's inputs on one wavefront as its wrapper prepares them
    (K4: sorted, padded, tiles busiest first, round 0 for the single round;
    K5: sorted and padded; any hit on the segment ends `tseg`), and the
    plain versions' outputs, cull off."""
    from spcbpt_tpu_torch.ops import pallas_tile, tile_trace
    from spcbpt_tpu_torch.scene.scene import TILE_LANES

    n = o.shape[0]
    tmin = torch.full((n,), 1e-3, device=dev)
    _, so, sd, stn, stx = tile_trace.sort_rays_live(cs, o, d, tmin, tmax)
    po, pd, ptn, ptx, _ = tile_trace._pad_rays(so, sd, stn, stx, TILE_LANES)
    entries, ids, o_t, d_t, tmin_t, tmax_t, _, nt = tile_trace._prepare(
        cs, po, pd, ptn, ptx, TILE_LANES)
    run0 = entries[:, 0] < 1e30
    cid0 = ids[:, 0].contiguous()
    qo, qd, qtn, qtx, _, _ = pallas_tile.prepare(cs, o, d, tmin, tmax, True)
    qseg = pallas_tile.prepare(cs, o, d, tmin, tseg, True)[3]
    c, k, nq = cs.num_clusters, cs.tri_k, qo.shape[0]
    common = dict(dev=dev, tri_k=k, c=c)
    inputs = {
        "K4 walk": dict(common, nt=nt, r=TILE_LANES, n_cols=c, args=(
            o_t, d_t, tmin_t, tmax_t, entries, ids, cs.tri_block,
            cs.tri_begin, cs.tri_count)),
        "K4 round": dict(common, nt=nt, r=TILE_LANES, args=(
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


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tile_walk_variants: no CUDA device is available")
    import chip_smoke   # its wavefronts and timing (it imports this module)
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.kernels import build
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

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
    path = resolve_scene("interior")
    ts, _, cam = load_trace_scene(path, dev)
    tts, _, _ = load_trace_scene(path, dev, mode="tile")
    cam.aspect = 1.0
    cs = tts.clusters
    waves = chip_smoke.wavefronts(ts, cam, dev) + (
        chip_smoke.connection_wavefront(ts, cam, dev),)
    results = {name: {"ptxas": regs} for name, (_, regs) in built.items()}
    for wave, o, d, tmax in waves:
        tseg = chip_smoke.any_segments(wave, tmax, o.shape[0], dev)
        inputs, plain = inputs_of(cs, o, d, tmax, tseg, dev)
        ref = {}
        for kind, fn in plain.items():
            if kind != "K4 walk" or wave.startswith("bounce"):
                ref[kind] = fn()
        for name, (lib, _) in built.items():
            out = {}
            for kind, entry in VARIANTS[name][1].items():
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
                if kind == "K4 walk":
                    out["K4 rounds max"] = int(got[4].max())
                    out["K4 rounds sum"] = int(got[4].sum())
            results[name][wave] = out
            print(f"{name:11s} {wave:17s} " + ", ".join(
                f"{key} {val:.4f}" if isinstance(val, float) else
                f"{key} {val}" for key, val in out.items())
                + (" (a floor, not compared)" if name in FLOORS else
                   " (equal to shipped)"), flush=True)
    print(json.dumps({"card": smi, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Times design variants of the tile-walk kernels K4 (the round walk) and
K5 any (the fused any-hit walk) on one NVIDIA GPU.

    python3 tile_walk_variants.py

The package ships one form of each in csrc/tile_walk.cu and no switch. This
script makes the other forms that were tried from that source in memory
(every patch must match the source exactly once; other forms are appended
whole), builds each with nvcc beside the shipped form, runs all of them on
chip_smoke.py's three interior wavefronts in the tile mode (camera 512x512;
2^17 sorted bounce rays, a quarter of the lanes dead; 3 x 2^16 connection
segments, a third masked), checks the shipped forms against their plain
versions on the bounce wavefront and every variant against the shipped form
(`torch.equal`), and prints the least of 3 x ITERS-launch mean times. The
variants:
  K4  stage1    one staging buffer, filled after the round's bound is known
                (no copy in flight during the tests);
      direct    no staging: the slots are read from the block in global
                memory (L2) by every thread;
  both all_slots every slot below tri_k tested, not only those below the
                cluster's triangle count (tri_count);
  K5  any_warp  one warp per 32 rays, 4 a block, nothing shared: each warp
                reduces its own bounds with shuffles, compacts its own
                candidate list (entry, id) in shared memory, takes the
                lexicographic successor each round and reads the slots from
                L2; no block barrier;
      old_any   the form before: one block per 128-ray tile, entry bounds of
                all C clusters in shared memory, a block-wide lexicographic
                next cluster over all C every round, the whole 9 x 128 block
                staged every round (all 128 slots' rows, tri_k tested).
The last line is one JSON object with the card, its power limit and every
time. Needs a card, nvcc, and chip_smoke.py beside it. Nothing holds the
shipped source to these patches: once it changes so that one no longer
matches, the script stops and names the patch.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke

ROUNDS, ITERS = 3, 10

_SHIPPED_STAGE = """    float* cur = stage + (rnd & 1) * kTriRows * ks;
    if (rnd + 1 < n_cols) {
      const int nxt = j + 1 < lanes ? sc[j + 1] : __ldg(irow + rnd + 1);
      stage_slots(stage + ((rnd + 1) & 1) * kTriRows * ks, blocks, nxt, kq);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this round's copies have landed
"""
_PROLOGUE = """  stage_slots(stage, blocks, __ldg(irow), kq);
  cp_async_commit();
"""
_STAGE1 = """    float* cur = stage;
    stage_slots(cur, blocks, cid, kq);
    cp_async_commit();
    cp_async_wait<0>();
"""
_DIRECT = """    const float* cur = blocks + static_cast<size_t>(cid) * kBlockRows * kSlots;
"""
_SHIPPED_TEST = "mt_test<false>(r, cur, ks, k, cull != 0, tmn, tmax_eff, t, u, v)"
_DIRECT_TEST = "mt_test<true>(r, cur, kSlots, k, cull != 0, tmn, tmax_eff, t, u, v)"

_OLD_ANY = r'''
namespace {
__global__ void __launch_bounds__(kTile)
old_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               const float* __restrict__ cmin, const float* __restrict__ cmax,
               const float* __restrict__ blocks, int c_total, int tri_k,
               int* __restrict__ out_occ) {
  extern __shared__ float smem[];
  float* blk = smem;
  float* entries = smem + kTriRows * kSlots;
  __shared__ float red_e[kWarps];
  __shared__ int red_c[kWarps];
  const size_t i = static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  const Ray r = load_ray(o, d, i);
  const float tmn = __ldg(tmin + i), tmx = __ldg(tmax + i);
  const Hull h = block_hull(r, tmn, tmx, red_e);
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


def _once(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, f"patch matches {src.count(old)} times:\n{old}"
    return src.replace(old, new)


def _stage1(src: str) -> str:
    return _once(_once(src, _SHIPPED_STAGE, _STAGE1), _PROLOGUE, "")


_K4_LOOP = "      for (int k = 0; k < cnt; ++k) {"
_ANY_SLOTS = ("occ = any_in_slots<false>(r, stage + (rnd & 1) * kTriRows * "
              "ks, ks, cnt,")


def _direct(src: str) -> str:
    src = _once(_once(src, _SHIPPED_STAGE, _DIRECT), _PROLOGUE, "")
    src = _once(src, "  cp_async_wait<0>();  // a copy still in flight "
                     "after the stop\n", "")
    return _once(src, _SHIPPED_TEST, _DIRECT_TEST)


# name -> (patch of the shipped source, K4 entry point or None, K5 any entry
# point or None)
VARIANTS = {
    "shipped": (lambda s: s, "tile_round_walk", "tile_walk_any"),
    "stage1": (_stage1, "tile_round_walk", None),
    "direct": (_direct, "tile_round_walk", None),
    "all_slots": (lambda s: _once(_once(s, _K4_LOOP, _K4_LOOP.replace(
        "cnt", "tri_k")), _ANY_SLOTS, _ANY_SLOTS.replace("cnt", "tri_k")),
        "tile_round_walk", "tile_walk_any"),
    "any_warp": (lambda s: s + _ANY_WARP, None, "tile_walk_any_warp"),
    "old_any": (lambda s: s + _OLD_ANY, None, "tile_walk_any_old"),
}


def build_variant(name: str, out_dir: str) -> tuple:
    """Patch, compile and load one variant -> (ctypes library, registers)."""
    from spcbpt_tpu_torch.kernels import build
    with open(os.path.join(build.SRC_DIR, "tile_walk.cu")) as f:
        src = VARIANTS[name][0](f.read())
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
    p, i = ctypes.c_void_p, ctypes.c_int
    _, k4, k5 = VARIANTS[name]
    if k4:
        getattr(lib, k4).argtypes = [p] * 9 + [i] * 5 + [p] * 6
    if k5:
        getattr(lib, k5).argtypes = [p] * 8 + [i] * 3 + [p] * 2
    return lib, regs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tile_walk_variants: no CUDA device is available")
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.kernels import build
    from spcbpt_tpu_torch.ops import pallas_tile, tile_trace
    from spcbpt_tpu_torch.scene.scene import TILE_LANES, load_trace_scene

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda name: build_variant(name, out_dir), VARIANTS)))

    dev = torch.device("cuda", 0)
    path = resolve_scene("interior")
    ts, _, cam = load_trace_scene(path, dev)
    tts, _, _ = load_trace_scene(path, dev, mode="tile")
    cam.aspect = 1.0
    cs = tts.clusters
    c, k = cs.num_clusters, cs.tri_k
    ptr = lambda *xs: [x.data_ptr() for x in xs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    waves = chip_smoke.wavefronts(ts, cam, dev) + (
        chip_smoke.connection_wavefront(ts, cam, dev),)
    results = {name: {"ptxas": regs} for name, (_, regs) in built.items()}
    for wave, o, d, tmax in waves:
        n = o.shape[0]
        tmin = torch.full((n,), 1e-3, device=dev)
        tseg = chip_smoke.any_segments(wave, tmax, n, dev)
        # K4's inputs as tile_closest prepares them (sorted, padded, tile
        # order busiest first)
        _, so, sd, stn, stx = tile_trace.sort_rays_live(cs, o, d, tmin, tmax)
        po, pd, ptn, ptx, _ = tile_trace._pad_rays(so, sd, stn, stx,
                                                   TILE_LANES)
        entries, ids, o_t, d_t, tmin_t, tmax_t, _, nt = tile_trace._prepare(
            cs, po, pd, ptn, ptx, TILE_LANES)
        # K5 any's as pallas_any prepares them
        qo, qd, qtn, qseg, _, _ = pallas_tile.prepare(cs, o, d, tmin, tseg,
                                                      True)
        nq = qo.shape[0]
        ref4 = ref5 = None
        for name, (lib, _) in built.items():
            _, k4, k5 = VARIANTS[name]
            out = {}
            if k4:
                hit = [torch.empty((nt, TILE_LANES), device=dev)
                       for _ in range(4)]
                hit[1] = hit[1].int()
                rounds = torch.empty((nt,), dtype=torch.int32, device=dev)

                def run4(lib=lib, k4=k4, hit=hit, rounds=rounds):
                    err = getattr(lib, k4)(
                        *ptr(o_t, d_t, tmin_t, tmax_t, entries, ids,
                             cs.tri_block, cs.tri_begin, cs.tri_count), nt,
                        TILE_LANES, c,
                        k, 0, *ptr(*hit, rounds), stream)
                    assert err == 0, (name, err)
                run4()
                torch.cuda.synchronize()
                got = tuple(hit) + (rounds,)
                if ref4 is None:
                    ref4 = tuple(x.clone() for x in got)
                    if wave.startswith("bounce"):   # shipped vs plain
                        plain = tile_trace.tile_closest_plain(
                            cs, o, d, tmin, tmax, False, tile=TILE_LANES,
                            sort_rays=True)
                        mine = tile_trace.tile_closest(
                            cs, o, d, tmin, tmax, False, tile=TILE_LANES,
                            use_kernel=True, sort_rays=True)
                        for f in ("t", "tri", "u", "v"):
                            assert torch.equal(getattr(plain, f),
                                               getattr(mine, f)), f
                assert all(torch.equal(a, b) for a, b in zip(got, ref4)), \
                    f"K4 variant {name} on {wave}: differs from shipped"
                out["K4_ms"] = min(chip_smoke.cuda_ms(run4, ITERS)
                                   for _ in range(ROUNDS))
                out["K4_rounds_max"] = int(rounds.max())
                out["K4_rounds_sum"] = int(rounds.sum())
            if k5:
                occ = torch.empty((nq,), dtype=torch.int32, device=dev)

                def run5(lib=lib, k5=k5, occ=occ):
                    err = getattr(lib, k5)(
                        *ptr(qo, qd, qtn, qseg, cs.cmin, cs.cmax,
                             cs.tri_block, cs.tri_count), nq, c, k,
                        occ.data_ptr(), stream)
                    assert err == 0, (name, err)
                run5()
                torch.cuda.synchronize()
                if ref5 is None:
                    ref5 = occ.clone()
                    plain = pallas_tile.any_tiles_plain(cs, qo, qd, qtn, qseg)
                    assert torch.equal(plain, occ), f"K5 any {wave} vs plain"
                assert torch.equal(occ, ref5), \
                    f"K5 any variant {name} on {wave}: differs from shipped"
                out["K5_any_ms"] = min(chip_smoke.cuda_ms(run5, ITERS)
                                       for _ in range(ROUNDS))
            results[name][wave] = out
            print(f"{name:9s} {wave:17s} " + ", ".join(
                f"{key} {val:.4f}" if isinstance(val, float) else
                f"{key} {val}" for key, val in out.items())
                + " (equal to shipped)", flush=True)
    print(json.dumps({"card": smi, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

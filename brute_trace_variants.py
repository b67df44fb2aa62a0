#!/usr/bin/env python3
"""Times design variants of the brute-force kernels K3 on one NVIDIA GPU.

    python3 brute_trace_variants.py [names]

The package ships one form of csrc/brute_trace.cu and no switch. This
script makes the other forms that were tried, builds each with nvcc beside
the shipped form, runs all of them on chip_smoke.py's K3 wavefronts (the
Cornell box's camera 512x512, bounce 2^17 with a quarter of its lanes dead
and connection 3 x 2^16 with a third masked, against its 32 triangles; the
interior's camera 512x512 against the 512 triangles that hold most of
its closest hits), checks that each returns the plain version's results
(`torch.equal`; closest with cull=False as the render loops trace it, any
hit on the segments of chip_smoke.brute_segments), and prints each kernel
alone: the least of 3 replays of a CUDA graph of 20 launches
(chip_smoke.graph_ms), and the shipped form once more at the end of each
wavefront. The forms:
  first_form     the port's first K3, whole: one thread per ray (dead lanes
                 idle in their warps), a static 18 KB table of (T, 9) rows
                 copied with an integer division per float, every stage of
                 a pair computed past det and the conditions combined at the
                 end, contiguous tmin/tmax, int32 flags;
  voted          the lanes of a warp leave a pair together, at the first
                 stage that all of them have failed (a vote, no divergent
                 branch), instead of each lane at its own failing check;
  pre_division   an exact rejection on u's numerator before the division:
                 where |un| > 1.125 |det|, or un and det have opposite signs
                 and |un| 2^60 > |det|, u is sure to fail [0, 1];
  all_stages     det rejects a lane, the rest is computed for every pair
                 and tested at the end;
  scalar_rows    the table read one float at a time (nine shared loads a
                 pair) instead of a float4 row of four triangles;
  no_pack        no packing of live rays: each thread takes its own lane,
                 dead lanes idle in their warps;
  block128       128-thread blocks instead of 256;
  regs_free      no register cap (70 a thread: three 256-thread blocks an
                 SM instead of four);
  io_floor       the pair loop removed: launch, bounds, packing and outputs
                 alone (returns misses: a floor, not compared);
and the shipped any hit over the triangles by area, largest first
(`any_area_order`, the tables permuted on the host). Nothing holds the
shipped source to these patches: once it changes so that one no longer
matches, the script stops and names the patch, and that variant is to be
written anew or dropped. The last line is one JSON object with the card,
its power limit and every time. Needs a card, nvcc, and chip_smoke.py
beside it.
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

FIRST_FORM = r"""
#include <cuda_runtime.h>
namespace {
constexpr float kBig = 1e30f;
constexpr float kEpsDet = 1e-10f;
constexpr int kBlock = 128;
constexpr int kMaxTris = 512;
constexpr int kTriFloats = 9;

__device__ __forceinline__ void load_tris(float* s, const float* __restrict__ p0,
                                          const float* __restrict__ e1,
                                          const float* __restrict__ e2,
                                          int t_total) {
  for (int k = threadIdx.x; k < 3 * t_total; k += kBlock) {
    const int j = k / 3;
    const int c = k - 3 * j;
    s[kTriFloats * j + c] = __ldg(p0 + k);
    s[kTriFloats * j + 3 + c] = __ldg(e1 + k);
    s[kTriFloats * j + 6 + c] = __ldg(e2 + k);
  }
  __syncthreads();
}

struct Ray { float ox, oy, oz, dx, dy, dz; };

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray r;
  r.ox = __ldg(o + 3 * i); r.oy = __ldg(o + 3 * i + 1); r.oz = __ldg(o + 3 * i + 2);
  r.dx = __ldg(d + 3 * i); r.dy = __ldg(d + 3 * i + 1); r.dz = __ldg(d + 3 * i + 2);
  return r;
}

__device__ __forceinline__ bool mt_hit(const Ray& r, const float* s, bool cull,
                                       float tmn, float tmx, float& t,
                                       float& u, float& v) {
  const float p0x = s[0], p0y = s[1], p0z = s[2];
  const float e1x = s[3], e1y = s[4], e1z = s[5];
  const float e2x = s[6], e2y = s[7], e2z = s[8];
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

__global__ void __launch_bounds__(kBlock)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax,
               const float* __restrict__ p0, const float* __restrict__ e1,
               const float* __restrict__ e2, int n, int t_total, int cull,
               float* __restrict__ out_t, int* __restrict__ out_tri,
               float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ float tris[kMaxTris * kTriFloats];
  load_tris(tris, p0, e1, e2, t_total);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  if (tmx > tmn) {
    const Ray r = load_ray(o, d, i);
    for (int j = 0; j < t_total; ++j) {
      float t, u, v;
      if (mt_hit(r, tris + kTriFloats * j, cull != 0, tmn, tmx, t, u, v) &&
          t < best_t) {
        best_t = t; best_id = j; best_u = u; best_v = v;
      }
    }
  }
  out_t[i] = best_t; out_tri[i] = best_id; out_u[i] = best_u; out_v[i] = best_v;
}

__global__ void __launch_bounds__(kBlock)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tmin, const float* __restrict__ tmax,
           const float* __restrict__ p0, const float* __restrict__ e1,
           const float* __restrict__ e2, int n, int t_total,
           int* __restrict__ out_occ) {
  __shared__ float tris[kMaxTris * kTriFloats];
  load_tris(tris, p0, e1, e2, t_total);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float tmn = __ldg(tmin + i);
  const float tmx = __ldg(tmax + i);
  int occ = 0;
  if (tmx > tmn) {
    const Ray r = load_ray(o, d, i);
    for (int j = 0; j < t_total; ++j) {
      float t, u, v;
      if (mt_hit(r, tris + kTriFloats * j, false, tmn, tmx, t, u, v)) {
        occ = 1;
        break;
      }
    }
  }
  out_occ[i] = occ;
}
}  // namespace

extern "C" int brute_closest(const float* o, const float* d, const float* tmin,
                             const float* tmax, const float* p0,
                             const float* e1, const float* e2, int n,
                             int t_total, int cull, float* out_t, int* out_tri,
                             float* out_u, float* out_v, void* stream) {
  closest_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      o, d, tmin, tmax, p0, e1, e2, n, t_total, cull, out_t, out_tri, out_u,
      out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brute_any(const float* o, const float* d, const float* tmin,
                         const float* tmax, const float* p0, const float* e1,
                         const float* e2, int n, int t_total, int* out_occ,
                         void* stream) {
  any_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(o, d, tmin, tmax, p0, e1,
                                                    e2, n, t_total, out_occ);
  return static_cast<int>(cudaGetLastError());
}
"""

_TAIL = """  const float inv = 1.0f / det;
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
"""
_ALL_STAGES = """  const float inv = 1.0f / det;
  const float tvx = r.ox - tr.p0x;
  const float tvy = r.oy - tr.p0y;
  const float tvz = r.oz - tr.p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * tr.e1z - tvz * tr.e1y;
  const float qvy = tvz * tr.e1x - tvx * tr.e1z;
  const float qvz = tvx * tr.e1y - tvy * tr.e1x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  t = (tr.e2x * qvx + tr.e2y * qvy + tr.e2z * qvz) * inv;
  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > tmn) & (t < hi);
"""
_DIVISION = """  const float inv = 1.0f / det;
  const float tvx = r.ox - tr.p0x;
  const float tvy = r.oy - tr.p0y;
  const float tvz = r.oz - tr.p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
"""
# u = un * (1/det) sure to fall outside [0, 1], exact for |det| > 1e-10:
# |un| > fl(1.125 |det|) gives |u| > 1 after both roundings (1/det keeps 22
# bits even where subnormal); opposite signs with |un| 2^60 > |det| give
# u < 0, far from an underflow to -0.0 (which passes u >= 0)
_PRE_DIVISION = """  const float tvx = r.ox - tr.p0x;
  const float tvy = r.oy - tr.p0y;
  const float tvz = r.oz - tr.p0z;
  const float un = tvx * pvx + tvy * pvy + tvz * pvz;
  const float a = fabsf(un), b = fabsf(det);
  if (a > 1.125f * b ||
      (((un < 0.0f) != (det < 0.0f)) && un != 0.0f && a * 0x1p60f > b))
    return false;
  const float inv = 1.0f / det;
  u = un * inv;
"""
_DET = """  if (kCull ? !(det > kEpsDet) : !(fabsf(det) > kEpsDet)) return false;
"""
_VOTED = """  bool ok = on && (kCull ? det > kEpsDet : fabsf(det) > kEpsDet);
  if (!__any_sync(m, ok)) return false;
  const float inv = 1.0f / det;
  const float tvx = r.ox - tr.p0x;
  const float tvy = r.oy - tr.p0y;
  const float tvz = r.oz - tr.p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  ok = ok && u >= 0.0f && u <= 1.0f;
  if (!__any_sync(m, ok)) return false;
  const float qvx = tvy * tr.e1z - tvz * tr.e1y;
  const float qvy = tvz * tr.e1x - tvx * tr.e1z;
  const float qvz = tvx * tr.e1y - tvy * tr.e1x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv;
  ok = ok && v >= 0.0f && u + v <= 1.0f;
  if (!__any_sync(m, ok)) return false;
  t = (tr.e2x * qvx + tr.e2y * qvy + tr.e2z * qvz) * inv;
  return ok && t > tmn && t < hi;
"""
_ANY_LOOP = """  bool occ = false;
  for (int q = 0; q < tq && !occ; ++q) {
    const Quad x = load_quad(table, tq, q);
#pragma unroll
    for (int c = 0; c < kTriVec && !occ; ++c) {
      float t, u, v;
      occ = pair_hit<false>(r, x.tri(c), tmn, tmx, t, u, v);
    }
  }
"""
# an occluded lane stays in the warp's votes, off
_VOTED_ANY_LOOP = """  bool occ = false;
  for (int q = 0; q < tq && __any_sync(m, !occ); ++q) {
    const Quad x = load_quad(table, tq, q);
#pragma unroll
    for (int c = 0; c < kTriVec; ++c) {
      float t, u, v;
      occ |= pair_hit<false>(r, x.tri(c), tmn, tmx, !occ, m, t, u, v);
    }
  }
"""
_PACK = """  const int count = pack_live(i, alive, live, counts);
  return static_cast<int>(threadIdx.x) < count ? live[threadIdx.x] : -1;
"""
_ROW_TRI = """// Triangle j of the table, one shared load per float.
__device__ __forceinline__ Tri row_tri(const float4* table, int tq, int j) {
  const float* s = reinterpret_cast<const float*>(table);
  const int tp = tq * kTriVec;
  return Tri{s[j], s[tp + j], s[2 * tp + j], s[3 * tp + j], s[4 * tp + j],
             s[5 * tp + j], s[6 * tp + j], s[7 * tp + j], s[8 * tp + j]};
}

"""
_TQ = "  const int tq = (t_total + kTriVec - 1) / kTriVec;\n"


def _patch(src: str, old: str, new: str, count: int = 1) -> str:
    assert src.count(old) == count, \
        f"patch matches {src.count(old)} times, not {count}:\n{old}"
    return src.replace(old, new)


def _scalar_rows(src: str) -> str:
    src = _patch(src, "// Moller-Trumbore of ray r", _ROW_TRI
                 + "// Moller-Trumbore of ray r")
    src = _patch(src, "    const Quad x = load_quad(table, tq, q);\n", "", 2)
    return _patch(src, "x.tri(c)", "row_tri(table, tq, kTriVec * q + c)", 2)


def _voted(src: str) -> str:
    """The warp leaves a pair together, at the first stage that all its
    lanes have failed (a vote), instead of each lane at its own."""
    src = _patch(src, "float tmn, float hi, float& t,",
                 "float tmn, float hi, bool on, unsigned m, float& t,")
    src = _patch(src, _DET + _TAIL, _VOTED)
    src = _patch(src, "  if (k < 0) return;\n",
                 "  const unsigned m = __ballot_sync(kFull, k >= 0);\n"
                 "  if (k < 0) return;\n", 2)
    src = _patch(src, "pair_hit<kCull>(r, x.tri(c), tmn, hi, t, u, v)",
                 "pair_hit<kCull>(r, x.tri(c), tmn, hi, true, m, t, u, v)")
    return _patch(src, _ANY_LOOP, _VOTED_ANY_LOOP)


VARIANTS = {
    "shipped": lambda s: s,
    "first_form": lambda s: FIRST_FORM,
    "voted": _voted,
    "pre_division": lambda s: _patch(s, _DIVISION, _PRE_DIVISION),
    "all_stages": lambda s: _patch(s, _TAIL, _ALL_STAGES),
    "scalar_rows": _scalar_rows,
    "no_pack": lambda s: _patch(s, _PACK, "  __syncthreads();\n"
                                "  return alive ? i : -1;\n"),
    "block128": lambda s: _patch(s, "constexpr int kBlock = 256;",
                                 "constexpr int kBlock = 128;"),
    "regs_free": lambda s: _patch(s, "constexpr int kMinBlocks = 4;",
                                  "constexpr int kMinBlocks = 1;"),
    "io_floor": lambda s: _patch(s, _TQ, "  const int tq = 0;\n", 2),
}
FLOORS = ("io_floor",)   # not the same function: timed, not compared


def build_variant(name: str, out_dir: str) -> tuple:
    """Patch, compile and load one variant -> (ctypes library, registers)."""
    from spcbpt_tpu_torch.kernels import build
    with open(os.path.join(build.SRC_DIR, "brute_trace.cu")) as f:
        src = VARIANTS[name](f.read())
    cu = os.path.join(out_dir, f"brute_trace_{name}.cu")
    so = os.path.join(out_dir, f"libbrute_trace_{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{res.stderr}")
    regs = [int(line.split("Used ")[1].split()[0])
            for line in res.stderr.splitlines() if "Used " in line]
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "first_form":
        lib.brute_closest.argtypes = [p] * 7 + [i, i, i] + [p] * 5
        lib.brute_any.argtypes = [p] * 7 + [i, i] + [p] * 2
    else:
        bound = [p, i, f]
        lib.brute_closest.argtypes = ([p] * 2 + bound * 2 + [p] * 3
                                      + [i, i, i] + [p] * 5)
        lib.brute_any.argtypes = ([p] * 2 + bound * 2 + [p] * 3 + [i, i]
                                  + [p] * 2)
    return lib, regs


def area_order(tris) -> torch.Tensor:
    """The triangles by area, largest first (equal areas by id)."""
    area = torch.linalg.vector_norm(torch.cross(tris[1], tris[2], dim=-1),
                                    dim=-1)
    return torch.sort(-area, stable=True).indices


def launchers(name, lib, o, d, tmin, tmax, tseg, tris) -> tuple:
    """(closest, any) of one variant on one wavefront, each a call that
    allocates its outputs and launches on the current stream (a CUDA
    graph's capture stream inside graph_ms)."""
    n, t_total = o.shape[0], tris[0].shape[0]
    dev = o.device
    ptr = lambda *xs: [x.data_ptr() for x in xs]
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    first = name == "first_form"

    def closest():
        t = torch.empty(n, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        u, v = torch.empty_like(t), torch.empty_like(t)
        bounds = ptr(tmin, tmax) if first else \
            [tmin.data_ptr(), 1, 0.0, tmax.data_ptr(), 1, 0.0]
        err = lib.brute_closest(*ptr(o, d), *bounds, *ptr(*tris), n, t_total,
                                0, *ptr(t, tri, u, v), stream())
        assert err == 0, (name, err)
        return t, tri, u, v

    def any_hit():
        occ = torch.empty(n, dtype=torch.int32 if first else torch.bool,
                          device=dev)
        bounds = ptr(tmin, tseg) if first else \
            [tmin.data_ptr(), 1, 0.0, tseg.data_ptr(), 1, 0.0]
        err = lib.brute_any(*ptr(o, d), *bounds, *ptr(*tris), n, t_total,
                            occ.data_ptr(), stream())
        assert err == 0, (name, err)
        return occ

    return closest, any_hit


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("brute_trace_variants: no CUDA device is available")
    from spcbpt_tpu_torch.apps.render_cli import resolve_scene
    from spcbpt_tpu_torch.kernels import build
    from spcbpt_tpu_torch.ops import brute_trace
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    names = ["shipped"] + [n for n in (argv or VARIANTS) if n != "shipped"]
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda name: build_variant(name, out_dir), names)))

    dev = torch.device("cuda", 0)
    cts, _, ccam = load_trace_scene(resolve_scene("cornell"), dev)
    its, _, icam = load_trace_scene(resolve_scene("interior"), dev)
    ccam.aspect = icam.aspect = 1.0
    results = {name: {"registers": regs} for name, (_, regs) in built.items()}
    for wave, o, d, tmax, tris in chip_smoke.brute_wavefronts(
            cts, ccam, its, icam, dev):
        n = o.shape[0]
        tmin = torch.full((n,), 1e-3, device=dev)
        ref = brute_trace.brute_closest_plain(o, d, tmin, tmax, *tris, False)
        tseg = chip_smoke.brute_segments(wave, ref, tmax, n, dev)
        ref_any = brute_trace.brute_any_plain(o, d, tmin, tseg, *tris)
        ordered = tuple(x[area_order(tris)].contiguous() for x in tris)
        for name, (lib, _) in built.items():
            closest, any_hit = launchers(name, lib, o, d, tmin, tmax, tseg,
                                         tris)
            forms = {"closest": closest, "any": any_hit}
            if name == "shipped":
                # the any hit over the triangles by area, largest first
                forms["any_area_order"] = launchers(
                    name, lib, o, d, tmin, tmax, tseg, ordered)[1]
            got = {k: fn() for k, fn in forms.items()}
            torch.cuda.synchronize()
            if name not in FLOORS:
                for f, a in zip(("t", "tri", "u", "v"), got["closest"]):
                    assert torch.equal(a, getattr(ref, f)), \
                        f"variant {name} on {wave}: {f} differs from plain"
                for k in forms:
                    if k != "closest":
                        assert torch.equal(got[k] != 0, ref_any), \
                            f"variant {name} on {wave}: {k} differs from plain"
            times = {f"{k}_ms": chip_smoke.graph_ms(fn)
                     for k, fn in forms.items()}
            results[name][wave] = times
            print(f"{name:13s} {wave:28s} " + "  ".join(
                f"{k} {v:.4f}" for k, v in times.items())
                + f"  (registers {results[name]['registers']}"
                + (")" if name in FLOORS else ", equal to plain)"),
                flush=True)
        closest, any_hit = launchers("shipped", built["shipped"][0], o, d,
                                     tmin, tmax, tseg, tris)
        again = {"closest_ms": chip_smoke.graph_ms(closest),
                 "any_ms": chip_smoke.graph_ms(any_hit)}
        results["shipped"][wave]["again"] = again
        print(f"{'shipped again':13s} {wave:28s} " + "  ".join(
            f"{k} {v:.4f}" for k, v in again.items()), flush=True)
    print(json.dumps({"card": smi, "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Traversal profiler of the list walk (kernel K6), the counterpart of the
JAX package's tools/prof_traversal.py at its full width and defaults.

    python -m spcbpt_tpu_torch.apps.prof_traversal
    python -m spcbpt_tpu_torch.apps.prof_traversal --device cpu --rays 512 --scale 1

On the procedural interior (scale 4: 32,576 triangles) it takes both
cluster sets from one BVH over one triangle order: the K=32 set of the
`tile` mode (1,370 clusters) and the K=128 set of the `walk` mode (368),
and checks that their triangle arrays are equal. Wavefronts, as in JAX:
  * camera: the first `--rays` (2^17) rays of a 512x512 grid in 16x16
    pixel blocks;
  * bounce: BSDF samples from the camera hits, shuffled with
    RandomState(0), traced with sort_rays=True.
Lines: walk_closest at K in {32, 128} x tile in {128, 256} on both
wavefronts, each in the resident and the streamed form, then walk_any at
K=128 with tmax 3 (sorted bounce rays), both forms. Each line gives ms per
call and Mrays/s: on the card device ms from CUDA events over 5 calls
after one warm call, on the CPU host ms of one call (the plain
versions). Camera lines give the triangle-id agreement with
tile_trace.tile_closest at K=32, tile 256 (K4 on the card), as does the last
line for the sorted bounce wavefront at K=128. The last line of the output
is one JSON object: the device, the BVH route, each line's ms and
agreement, and K6's launches.
Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from ..kernels import list_walk as kernels
from ..ops import bsdf, bvh, pallas_walk, tile_trace
from ..ops.clusters import ClusterSet
from ..render.common import camera_rays
from ..scene.scene import load_trace_scene, local_geometry
from ..utils import rng
from .render_cli import generate_interior, resolve_scene

GRID = 512
ITERS = 5    # timed calls per line on the card, after one warm call


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--rays", type=int, default=1 << 17,
                   help=f"rays per wavefront, at most {GRID * GRID}")
    p.add_argument("--scale", type=int, default=4,
                   help="interior tessellation scale (4: the builtin scene)")
    return p


def _timer(dev):
    """fn -> (ms per call, last output): device ms from CUDA events after a
    warm call on the card, host ms of one call on the CPU."""
    def run(fn):
        if dev.type == "cpu":
            t0 = time.perf_counter()
            out = fn()
            return (time.perf_counter() - t0) * 1e3, out
        fn()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / ITERS, out
    return run


def _scenes(scale: int, dev, root: str):
    path = (resolve_scene("interior") if scale == 4
            else generate_interior(root, scale))
    tts, _, cam = load_trace_scene(path, dev, mode="tile")
    route = bvh.BUILD_ROUTE
    wts, _, _ = load_trace_scene(path, dev, mode="walk")
    if not isinstance(wts.clusters_walk, ClusterSet):
        raise SystemExit(f"interior scale {scale}: its walk set is split "
                         f"into parts; the list walk takes one set")
    # one BVH over one triangle order: both sets index the same triangles
    assert torch.equal(tts.tri_p0, wts.tri_p0), "cluster sets disagree"
    return tts, wts, cam, route


def _wavefronts(tts, cam, n: int, dev):
    """Camera rays, the K4 reference hits on them, and the shuffled BSDF
    bounce rays from those hits."""
    cam.aspect = 1.0
    eye, U, V, W = cam.uvw()
    o, d, _ = camera_rays(eye, U, V, W, GRID, GRID, 0, block=16, device=dev)
    o, d = o[:n].contiguous(), d[:n].contiguous()
    tmn = torch.full((n,), 1e-3, device=dev)
    tmx = torch.full((n,), 1e16, device=dev)
    h_ref = tile_trace.tile_closest(tts.clusters, o, d, tmn, tmx, True,
                                    tile=256, use_kernel=True)
    geom = local_geometry(tts, h_ref, o, d)
    state = rng.seed(torch.arange(n, device=dev), 7)
    mat = bsdf.gather_mat(tts.mats, geom["mat_id"], geom["base_color"])
    nd, _ = bsdf.sample_bsdf(mat, geom["Ns"], -d, state)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(n)).to(dev)
    o2, d2 = geom["P"][perm].contiguous(), nd[perm].contiguous()
    return o, d, o2, d2, tmn, tmx, h_ref


def run(args) -> dict:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if not 0 < args.rays <= GRID * GRID:
        raise SystemExit(f"--rays must lie in 1..{GRID * GRID}")
    dev = torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    unit = "device ms" if dev.type == "cuda" else "host ms (cpu)"
    n = args.rays
    with tempfile.TemporaryDirectory() as root:
        tts, wts, cam, route = _scenes(args.scale, dev, root)
    cs32, cs128 = tts.clusters, wts.clusters_walk
    print(f"[prof] {name}: interior scale {args.scale}, {tts.num_tris} tris, "
          f"BVH {route}; K=32 {cs32.num_clusters} clusters, K=128 "
          f"{cs128.num_clusters}; {n} rays", flush=True)
    o, d, o2, d2, tmn, tmx, h_ref = _wavefronts(tts, cam, n, dev)
    timed = _timer(dev)
    kernels.reset_launches()

    times, agreement = {}, {}

    def line(label, ms, extra=""):
        times[label] = ms
        print(f"[prof] {label:44s} {ms:10.3f} {unit} "
              f"({n / ms / 1e3:8.2f} Mrays/s){extra}", flush=True)

    for wave, (wo, wd, sort) in (("camera", (o, d, False)),
                                 ("secondary", (o2, d2, True))):
        for cs, k in ((cs32, 32), (cs128, 128)):
            for tile in (128, 256):
                for form, res in (("resident", True), ("streamed", False)):
                    ms, h = timed(lambda: pallas_walk.walk_closest(
                        cs, wo, wd, tmn, tmx, True, tile=tile,
                        sort_rays=sort, vmem_resident=res))
                    label = (f"{wave} walk K={k} tile={tile} {form}"
                             f"{' (sorted)' if sort else ''}")
                    extra = ""
                    if wave == "camera":
                        agree = (h.tri == h_ref.tri).float().mean().item()
                        agreement[label] = agree
                        extra = f"; tri agree vs K4 {agree:.5f}"
                    line(label, ms, extra)
    t3 = torch.full((n,), 3.0, device=dev)
    for form, res in (("resident", True), ("streamed", False)):
        ms, occ = timed(lambda: pallas_walk.walk_any(
            cs128, o2, d2, tmn, t3, tile=256, sort_rays=True,
            vmem_resident=res))
        line(f"secondary walk_any K=128 tmax=3 {form} (sorted)", ms,
             f"; occluded {occ.float().mean().item():.4f}")
    h_ref2 = tile_trace.tile_closest(cs32, o2, d2, tmn, tmx, True, tile=256,
                                     use_kernel=True, sort_rays=True)
    h2 = pallas_walk.walk_closest(cs128, o2, d2, tmn, tmx, True, tile=256,
                                  sort_rays=True)
    label = "secondary walk K=128 tile=256 (sorted) vs K4 at K=32"
    agreement[label] = (h2.tri == h_ref2.tri).float().mean().item()
    print(f"[prof] {label}: tri agree {agreement[label]:.5f}", flush=True)
    return {"device": name, "unit": unit, "bvh_route": route, "rays": n,
            "ms": times, "tri_agree": agreement,
            "launches": dict(kernels.LAUNCHES)}


def main(argv=None) -> int:
    out = run(build_argparser().parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

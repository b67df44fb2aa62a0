"""Traversal benchmark of the port: the measurement of the JAX package's
root bench.py (its child, bench.py:208-389) on one NVIDIA GPU.

    python -m spcbpt_tpu_torch.apps.bench
    python -m spcbpt_tpu_torch.apps.bench --device cpu --dim 64 --scale 1 --rays 1024

The frozen metric `traversal_throughput_33k_tris` is closest-hit traversal
of camera wavefronts (32x32 pixel blocks, tmin/tmax as tensors) over the
procedural interior (scale 4: 32,576 triangles) through the tile mode's
round walk over clusters of at most TRI_K = 16 triangles, in Mrays/s,
steady state over several frames. JAX measures its matmul walk at tiles
of 1,024 rays; on the card the round walk is kernel K4
(kernels/tile_walk.round_walk, `tile_round_walk`). The port's number is
taken at TILE = 256 rays a tile, where it was first measured, and the JSON
says so (`tile`, `kernel`); `mrays_tile1024` is the same 1024^2 headline
at JAX's tile (JAX_TILE). On CPU tensors the same call runs K4's plain
version (the host loop over the plain round).

Stages, in order, each line printed as soon as it is measured:
  1. the (dim/2)^2 wavefront: SMALL_ITERS frames after one warm frame;
     prints the first line;
  2. the dim^2 headline: BIG_ITERS frames; prints the merged line;
     then mrays_tile1024, the same at tiles of JAX_TILE rays (the same
     gate);
  3. secondary_mrays_walk: a bounce wavefront of `--rays` rays (camera hits
     -> BSDF samples, lanes shuffled by RandomState(0)) through the row
     walk (K1) with the coherence sort, ITERS calls;
  4. mrays_parts_<n>k_p<parts>: the interior midpoint-subdivided 1:4 per
     level (levels 1 and 2), its row-walk set cut into parts of at most
     PART_MAX_TRIS triangles (and at most the clusters one K1 block holds),
     walked on the (dim/2)^2 camera wavefront, ITERS calls;
  5. pt_ms_per_spp_<dim/2>: PT at (dim/2)^2, depth PT_DEPTH, 1 spp a call,
     PT_CALLS calls after a warm one;
then the final merged line with bench_seconds. A stage that the time left
of `--budget` does not allow (the gates of JAX's bench) is listed in
`skipped`; a stage that fails raises. Every timed loop ends in
torch.cuda.synchronize() on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import bsdf, bvh, clusters, ray_walk, tile_trace
from ..render import pt_pool
from ..render.common import camera_rays
from ..scene.scene import local_geometry, trace_closest
from ..utils import rng
from ..utils.profiling import nvidia_smi_line
from .render_cli import _sync as sync
from .render_cli import load_interior

METRIC = "traversal_throughput_33k_tris"
TRI_K = 16                                # triangles a tile-mode cluster
# rays a tile of the frozen metric: pinned, not K4's largest
# (kernels/tile_walk.MAX_ROUND_LANES, 1,024), so that the metric keeps the
# tile it was first measured at
TILE = 256
JAX_TILE = 1024                           # bench.py's tile
HIT_SHARE = 0.9                           # camera lanes that must hit
SMALL_ITERS = 6
BIG_ITERS = 10
ITERS = 5                                 # secondary and parts
PART_MAX_TRIS = 120_000
PT_DEPTH = 12
PT_CALLS = 2
# seconds of the budget that must be left to start a stage (JAX's gates)
GATE_HEADLINE = 120
GATE_SECONDARY = 150
GATE_PARTS = 150
GATE_PT = 90


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--budget", type=float, default=420.0,
                   help="seconds; a stage starts only with its gate left")
    p.add_argument("--dim", type=int, default=1024,
                   help="headline wavefront side (a multiple of 64); the "
                        "other wavefronts and PT take half of it")
    p.add_argument("--scale", type=int, default=4,
                   help="interior tessellation scale (4: the metric's "
                        "32,576 triangles)")
    p.add_argument("--rays", type=int, default=1 << 17,
                   help="rays of the secondary wavefront")
    return p


def triangles(ts) -> tuple:
    """The scene's (p0, e1, e2) as numpy."""
    return tuple(a.cpu().numpy() for a in (ts.tri_p0, ts.tri_e1, ts.tri_e2))


def tile_clusters(ts):
    """The metric's cluster set: a BVH over the scene's triangles, cut into
    tile-mode clusters of at most TRI_K (bench.py:171-175)."""
    p0, e1, e2 = triangles(ts)
    flat = bvh.build_bvh(p0, e1, e2)
    o = flat.order
    return clusters.build_tile_clusters(flat, p0[o], e1[o], e2[o], TRI_K,
                                        device=ts.device)


def camera_wavefront(cam, side: int, frame: int, block: int, dev):
    """Origins and directions of a side^2 camera wavefront in block x block
    pixel tiles."""
    eye, U, V, W = cam.uvw()
    o, d, _ = camera_rays(eye, U, V, W, side, side, frame, block=block,
                          device=dev)
    return o.contiguous(), d.contiguous()


def measure_camera(cs, cam, side: int, iters: int, tile: int = TILE):
    """Mrays/s of closest hits of side^2 camera wavefronts in tiles of
    `tile` rays, frames 1..iters after frame 0 (bench.py:208-232); returns
    (Mrays/s, frame 0's share of lanes hit). Raises unless more than
    HIT_SHARE of the lanes hit."""
    dev = cs.cmin.device
    n = side * side
    tmn = torch.full((n,), 1e-3, device=dev)
    tmx = torch.full((n,), 1e16, device=dev)

    def trace(frame):
        o, d = camera_wavefront(cam, side, frame, 32, dev)
        hit = tile_trace.tile_closest(cs, o, d, tmn, tmx, True, tile=tile,
                                      use_kernel=True)
        return hit.t.sum(), (hit.tri >= 0).sum()

    hits = int(trace(0)[1]) / n
    if hits <= HIT_SHARE:
        raise RuntimeError(f"camera rays must hit the interior: {hits:.4f} "
                           f"of {n} lanes hit")
    t0 = time.perf_counter()
    for i in range(iters):
        out = trace(i + 1)
    sync(dev)
    dt = time.perf_counter() - t0
    del out
    return n * iters / dt / 1e6, hits


def secondary_wavefront(ts, cam, nb: int, side: int):
    """The bounce wavefront of bench.py:303-317: the first nb lanes of a
    side^2 camera wavefront in 16x16 blocks traced, BSDF-sampled from
    their hits (rng seeded by lane, frame 7) and shuffled by
    RandomState(0). Returns (origins, directions)."""
    dev = ts.device
    o1, d1 = camera_wavefront(cam, side, 0, 16, dev)
    o1, d1 = o1[:nb].contiguous(), d1[:nb].contiguous()
    hit = trace_closest(ts, o1, d1, 1e-3, 1e16, True)
    geom = local_geometry(ts, hit, o1, d1)
    st = rng.seed(torch.arange(nb, device=dev), 7)
    mat = bsdf.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
    nd, _ = bsdf.sample_bsdf(mat, geom["Ns"], -d1, st)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(nb)).to(dev)
    return geom["P"][perm].contiguous(), nd[perm].contiguous()


def timed_calls(fn, calls: int, dev) -> float:
    """Seconds per call of `fn` over `calls` calls after a warm one."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn()
    sync(dev)
    del out
    return (time.perf_counter() - t0) / calls


def subdivide(p0, e1, e2):
    """Midpoint 1:4 split of every triangle (bench.py:339-345): returns the
    (p0, e1, e2) of four times the triangles, the same surface."""
    A, B, C = p0, p0 + e1, p0 + e2
    mab, mac, mbc = (A + B) / 2, (A + C) / 2, (B + C) / 2
    sp0 = np.concatenate([A, mab, mac, mbc])
    sp1 = np.concatenate([mab, B, mbc, mac])
    sp2 = np.concatenate([mac, mbc, C, mab])
    return sp0, sp1 - sp0, sp2 - sp0


def cluster_parts(p0, e1, e2, dev):
    """The row walk's parts of a large triangle set (bench.py:352-356)."""
    flat = bvh.build_bvh(p0, e1, e2)
    o = flat.order
    return clusters.build_cluster_parts(flat, p0[o], e1[o], e2[o],
                                        max_tris=clusters.SLOTS,
                                        part_max_tris=PART_MAX_TRIS,
                                        device=dev)


def run(args) -> dict:
    """Runs the stages, printing each line; returns the final one."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if args.dim <= 0 or args.dim % 64:
        raise SystemExit("--dim must be a positive multiple of 64")
    dev = torch.device(args.device)
    t_start = time.perf_counter()
    remaining = lambda: args.budget - (time.perf_counter() - t_start)
    emit = lambda obj: print(json.dumps(obj), flush=True)
    big, small = args.dim, args.dim // 2

    ts, cam = load_interior(args.scale, dev)
    cs = tile_clusters(ts)
    print(f"[bench] interior scale {args.scale}: {ts.num_tris} tris, "
          f"{cs.num_clusters} tile clusters of at most {TRI_K}, BVH "
          f"{bvh.BUILD_ROUTE}", file=sys.stderr, flush=True)
    cuda = dev.type == "cuda"
    primary = {"metric": METRIC, "value": None,
               "unit": "Mrays/s/chip" if cuda else "Mrays/s on the host CPU"}
    extras = {"backend": args.device,
              "device": nvidia_smi_line() if cuda else "cpu",
              "tris": ts.num_tris, "tile": TILE,
              "kernel": "tile_round_walk" if cuda
              else "tile_round_walk's plain version (host loop)",
              "skipped": []}

    mrays, hits = measure_camera(cs, cam, small, SMALL_ITERS)
    primary["value"] = mrays
    extras.update(wavefront=f"{small}x{small}", hits=hits)
    emit({**primary, **extras})

    if remaining() > GATE_HEADLINE:
        mrays_big, hits = measure_camera(cs, cam, big, BIG_ITERS)
        primary["value"] = mrays_big
        extras.update(wavefront=f"{big}x{big}", hits=hits)
        extras[f"mrays_{small}"] = mrays
        emit({**primary, **extras})
    else:
        extras["skipped"].append("headline")

    if remaining() > GATE_HEADLINE:
        extras["mrays_tile1024"] = measure_camera(cs, cam, big, BIG_ITERS,
                                                  JAX_TILE)[0]
    else:
        extras["skipped"].append("tile1024")

    if remaining() > GATE_SECONDARY:
        if not isinstance(ts.clusters_walk, clusters.ClusterSet):
            raise RuntimeError("the secondary wavefront walks one set; this "
                               "interior's is split into parts")
        nb = min(args.rays, small * small)
        o2, d2 = secondary_wavefront(ts, cam, nb, small)
        tb = torch.full((nb,), 1e-3, device=dev)
        te = torch.full((nb,), 1e16, device=dev)
        s = timed_calls(lambda: ray_walk.walk_closest(
            ts.clusters_walk, o2, d2, tb, te, True, sort_rays=True).t.sum(),
            ITERS, dev)
        extras["secondary_mrays_walk"] = nb / s / 1e6
    else:
        extras["skipped"].append("secondary")

    sp = triangles(ts)
    oL, dL = camera_wavefront(cam, small, 0, 32, dev)
    nL = small * small
    tbL = torch.full((nL,), 1e-3, device=dev)
    teL = torch.full((nL,), 1e16, device=dev)
    for level in (1, 2):
        if remaining() < GATE_PARTS:
            extras["skipped"].append(f"parts_level{level}")
            continue
        sp = subdivide(*sp)
        parts = cluster_parts(*sp, dev)
        print(f"[bench] level {level}: {len(sp[0])} tris in "
              f"{len(parts.parts)} parts of "
              f"{[b - a for a, b in parts.bounds]} clusters",
              file=sys.stderr, flush=True)
        s = timed_calls(lambda: ray_walk.walk_closest_parts(
            parts, oL, dL, tbL, teL, True, sort_rays=True).t.sum(),
            ITERS, dev)
        key = f"mrays_parts_{len(sp[0]) // 1000}k_p{len(parts.parts)}"
        extras[key] = nL / s / 1e6
        del parts

    if remaining() > GATE_PT:
        uvw = cam.uvw()
        frame = iter(range(PT_CALLS + 1))
        s = timed_calls(lambda: pt_pool.render_pool(
            ts, uvw, small, small, 1, next(frame), max_depth=PT_DEPTH),
            PT_CALLS, dev)
        extras[f"pt_ms_per_spp_{small}"] = s * 1e3
    else:
        extras["skipped"].append("pt")

    extras["bench_seconds"] = time.perf_counter() - t_start
    final = {**primary, **extras}
    emit(final)
    return final


def main(argv=None) -> int:
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

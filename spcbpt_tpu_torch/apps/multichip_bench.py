"""BASELINE config 5: multi-device tiled SPCBPT at 2048x2048, equal-time
SPCBPT(uniform)=BDPT vs SPCBPT over a device mesh.

Port of spcbpt_tpu/apps/multichip_bench.py. Each mesh shape TILExSPP runs
as its own torch.distributed world, one process per rank
(parallel/launch.spawn): NCCL with one rank per card on `--device cuda`
(the default; it fails without a card, and a mesh larger than the cards
present is skipped, as JAX skips meshes larger than its devices), gloo
over `--world` CPU ranks on `--device cpu`. For each mesh it renders PT
(pixel-seeded: every TILEx1 mesh must reproduce the single-device image,
mean within 1e-5), then BDPT and SPCBPT (per-rank light caches, so
agreement across meshes is statistical, within 15%), and reports means,
seconds, lanes per rank and, on the card, peak memory. `--equal-time`
then accumulates BDPT and SPCBPT subframes on the largest mesh that fits
for that many seconds each (a discarded warm-up subframe first; the loop
stops when the next subframe would overshoot) and reports relMSE against
`--ref-npz` (key 'img', (W*H, 3)).

Usage:
  python -m spcbpt_tpu_torch.apps.multichip_bench --meshes 1x1 \
      --dim 2048x2048 --sub-blocks 4 --subframes 1 --mesh-algs spcbpt
  python -m spcbpt_tpu_torch.apps.multichip_bench --device cpu --world 4 \
      --meshes 1x1,2x1,2x2 --dim 32x16
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

PT_DEV = 1e-5      # PT mean vs the smallest mesh of the same spp
ALG_DEV = 0.15     # BDPT/SPCBPT mean vs the smallest mesh of the same spp
MESH_TIMEOUT_S = 3000.0   # one mesh's ranks in all, set-up included


def build_argparser():
    p = argparse.ArgumentParser(description="spcbpt_tpu_torch multi-device "
                                            "benchmark")
    p.add_argument("--scene", default="cornell_glossy")
    p.add_argument("--dim", default="2048x2048")
    p.add_argument("--light-paths-per-chip", type=int, default=8192)
    p.add_argument("--max-depth", type=int, default=8)
    p.add_argument("--meshes", default="1x1,2x1,4x1,4x2",
                   help="comma list of TILExSPP mesh shapes")
    p.add_argument("--checkpoint", default=None,
                   help="trained SubspaceState npz: spcbpt entries run the "
                        "trained two-stage sampler instead of untrained")
    p.add_argument("--equal-time", type=float, default=None,
                   help="seconds per algorithm: after the mesh sweep, "
                        "accumulate subframes of bdpt+spcbpt on the largest "
                        "mesh and report relMSE vs --ref-npz")
    p.add_argument("--ref-npz", default=None,
                   help="reference image npz (key 'img', (W*H,3)) for the "
                        "equal-time relMSE")
    p.add_argument("--discard", type=float, default=0.001)
    p.add_argument("--sub-blocks", type=int, default=1,
                   help="sequential sub-wavefronts per rank row block "
                        "(memory / sub_blocks, estimator unchanged)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--world", type=int, default=None,
                   help="ranks available: the cards present on cuda (NCCL "
                        "takes one rank a card), 8 gloo ranks on cpu")
    p.add_argument("--subframes", type=int, default=3,
                   help="subframe index of each mesh-correctness render")
    p.add_argument("--mesh-algs", default="pt,bdpt,spcbpt",
                   help="algorithms to run in the mesh-correctness sweep")
    p.add_argument("--single-run", action="store_true",
                   help="mesh sweep only: take the mean from the first run "
                        "and skip the warm timed rerun ('seconds' then "
                        "includes the first run's set-up)")
    p.add_argument("--json", default=None)
    return p


def _state(args, dev):
    from .. import checkpoint
    from ..train import classify
    if args.checkpoint:
        return checkpoint.load_subspace_state(args.checkpoint, dev)
    return classify.untrained_state(dev)


def _setup(args, scene_path):
    """The rank's device, scene, camera and state."""
    from ..parallel import launch
    from ..scene.scene import load_trace_scene
    from ..train import classify

    dev = launch.rank_device(args.device, torch.distributed.get_rank())
    if dev.type == "cuda":
        classify.use_fp32_matmul()
    width, height = map(int, args.dim.lower().split("x"))
    ts, _, cam = load_trace_scene(scene_path, dev)
    cam.aspect = width / height
    return dev, ts, cam.uvw(), _state(args, dev), width, height


def _timed(fn, dev):
    """(result, seconds) of fn() with the device synchronised and every
    rank lined up at both ends."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        torch.distributed.barrier()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _mesh_rank(rank, world, args, scene_path, shape) -> dict:
    """Every algorithm of the sweep on one mesh; each rank returns the
    same numbers (the image is gathered on every rank) but its own kernel
    launches, counted over the last run."""
    from .. import kernels
    from ..parallel import tile as par

    dev, ts, uvw, ss, width, height = _setup(args, scene_path)
    t_, s_ = shape
    mesh = par.make_mesh(tile=t_, spp=s_)
    algs = args.mesh_algs.split(",")
    nsub = args.subframes
    entry = {}
    if "pt" in algs:
        fn = lambda: par.sharded_pt_render(ts, uvw, width, height, nsub, mesh,
                                           max_depth=args.max_depth)
        _timed(fn, dev)
        kernels.reset_launches()
        img, dt = _timed(fn, dev)
        entry["pt"] = {"mean": float(img.mean()), "seconds": dt,
                       "mpaths_per_s_total": width * height / dt / 1e6,
                       "launches": kernels.read_launches()}
    for alg, uniform in (("bdpt", True), ("spcbpt", False)):
        if alg not in algs:
            continue
        fn = lambda uniform=uniform: par.sharded_spcbpt_render(
            ts, ss, uvw, width, height, nsub, mesh, args.light_paths_per_chip,
            max_depth=args.max_depth, uniform=uniform,
            sub_blocks=args.sub_blocks)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        img, first_s = _timed(fn, dev)
        dt = first_s
        if not args.single_run:
            kernels.reset_launches()
            img, dt = _timed(fn, dev)
        entry[alg] = {"mean": float(img.mean()), "seconds": dt,
                      "first_seconds": first_s,
                      "lanes_per_chip": width * height // t_,
                      "mpaths_per_s_total": width * height / dt / 1e6,
                      "finite": bool(torch.isfinite(img).all()),
                      "launches": kernels.read_launches()}
        if dev.type == "cuda":
            entry[alg]["peak_mem_gb"] = \
                torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if args.single_run:
            entry[alg]["single_run"] = True
    return entry


def _equal_time_rank(rank, world, args, scene_path, shape) -> dict:
    """Equal-time BDPT and SPCBPT on one mesh; returns the accumulated
    images (on rank 0) and their counts."""
    from ..parallel import tile as par

    dev, ts, uvw, ss, width, height = _setup(args, scene_path)
    mesh = par.make_mesh(tile=shape[0], spp=shape[1])
    out = {}
    for alg, uniform in (("bdpt", True), ("spcbpt", False)):
        fn = lambda sub, uniform=uniform: par.sharded_spcbpt_render(
            ts, ss, uvw, width, height, sub, mesh, args.light_paths_per_chip,
            max_depth=args.max_depth, uniform=uniform,
            sub_blocks=args.sub_blocks)
        # warm-up subframe: discarded, not counted
        _timed(lambda: fn(0), dev)
        acc, n = None, 0
        stop = torch.zeros((), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        while True:
            el = time.perf_counter() - t0
            # rank 0 decides, so every rank runs the same subframes
            stop.fill_(int(n > 0 and el + el / n > args.equal_time))
            torch.distributed.broadcast(stop, src=0)
            if int(stop):
                break
            img = fn(n + 1)
            acc = img if acc is None else acc + img
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            n += 1
        dt = time.perf_counter() - t0
        out[alg] = {"img": (acc / n).cpu().numpy() if rank == 0 else None,
                    "subframes": n, "seconds": dt}
    return out


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    from ..parallel import launch
    from ..utils.image import rel_mse
    from .render_cli import resolve_scene

    if args.device == "cuda":
        n_dev = torch.cuda.device_count()
        if args.world:
            n_dev = min(n_dev, args.world)
    else:
        n_dev = args.world or 8
    print(f"[devices] {n_dev} x {args.device} "
          f"({launch.backend_for(args.device)})", flush=True)
    scene_path = resolve_scene(args.scene)
    width, height = map(int, args.dim.lower().split("x"))
    shapes = [tuple(map(int, s.lower().split("x")))
              for s in args.meshes.split(",")]

    def run(target, shape):
        return launch.spawn(target, shape[0] * shape[1],
                            args=(args, scene_path, shape),
                            device=args.device, timeout_s=MESH_TIMEOUT_S)[0]

    results = {"scene": args.scene, "dim": args.dim, "devices": n_dev,
               "device": args.device, "meshes": {}}
    if args.device == "cuda":
        results["card"] = torch.cuda.get_device_name(0)
    base_mean = {}
    for t_, s_ in shapes:
        shape = f"{t_}x{s_}"
        if t_ * s_ > n_dev:
            print(f"[skip] mesh {shape}: needs {t_ * s_} devices", flush=True)
            continue
        entry = run(_mesh_rank, (t_, s_))
        for alg, e in entry.items():
            key = (alg, s_)
            base_mean.setdefault(key, e["mean"])
            dev = abs(e["mean"] / base_mean[key] - 1.0)
            e["mean_vs_smallest_mesh"] = dev
            mem = (f", peak {e['peak_mem_gb']:.2f} GiB"
                   if "peak_mem_gb" in e else "")
            print(f"[mesh {shape}] {alg}: mean {e['mean']:.6f} (dev "
                  f"{dev:.2e}) {e['seconds']:.3f}s ({e['mpaths_per_s_total']:.3f}"
                  f" Mpaths/s total){mem}", flush=True)
            if alg == "pt":
                assert dev < PT_DEV, f"PT pixel-split mismatch on mesh {shape}"
            else:
                # BDPT/SPCBPT trace their light caches per rank with
                # decorrelated seeds: agreement is statistical
                assert dev < ALG_DEV, \
                    f"estimator mismatch on mesh {shape} {alg}"
        results["meshes"][shape] = entry
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=2)

    if args.equal_time:
        ref = np.load(args.ref_npz)["img"] if args.ref_npz else None
        t_, s_ = max((t, s) for t, s in shapes if t * s <= n_dev)
        res = run(_equal_time_rank, (t_, s_))
        results["equal_time"] = {"mesh": f"{t_}x{s_}",
                                 "budget_s": args.equal_time, "algs": {}}
        for alg, r in res.items():
            e = (rel_mse(r["img"], ref, discard=args.discard)
                 if ref is not None else None)
            n = r["subframes"]
            results["equal_time"]["algs"][alg] = {
                "relmse": e, "subframes": n, "seconds": r["seconds"],
                "spp_per_pixel": n * s_}
            print(f"[equal-time {t_}x{s_}] {alg}: relMSE "
                  f"{e if e is not None else float('nan'):.5f} at {n} "
                  f"subframes ({r['seconds']:.1f}s)", flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

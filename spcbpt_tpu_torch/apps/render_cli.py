"""Renderer CLI — port of spcbpt_tpu/apps/render_cli.py.

Same flags and output (PNG, --hdr-out, --stats-json, the `[render] ...
Mpaths/s` line, the per-frame `[frame]` lines of BDPT/SPCBPT). `--device`
replaces the JAX `--platform` and defaults to `cuda`, which fails when no
card is present. `--alg spcbpt` trains the subspace state first (pretrace,
trees, Q, Gamma: train/pipeline.py, 8,192 pretrace lanes, at most 50,000
light paths of depth 8 per Q launch), unless `--resume` loads one (a
checkpoint of either package); `--checkpoint` saves the trained state.
`--classifier nn` also trains the close-set network (train/nn_classifier.py)
and renders with its blended first stage.

BDPT and SPCBPT render one light-vertex cache per frame, as the JAX CLI
does: frame s traces `--light-paths` light sub-paths with seed
s+seed+7919, builds the sampler, and renders one eye sample per pixel
with subframe s+seed.

Usage:
  python -m spcbpt_tpu_torch.apps.render_cli --scene interior --alg pt \
      --dim 1024x1024 --spp 4 --out out.png
  python -m spcbpt_tpu_torch.apps.render_cli --scene cornell --alg spcbpt \
      --checkpoint state.npz --spp 4 --out out.png
  python -m spcbpt_tpu_torch.apps.render_cli --scene cornell --alg spcbpt \
      --resume state.npz --spp 4 --out out.png
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def build_argparser():
    p = argparse.ArgumentParser(description="spcbpt_tpu_torch renderer")
    p.add_argument("--scene", default="cornell",
                   help=".scene path, or builtin: cornell | cornell_glossy |"
                        " interior | interior_lit | interior_cove")
    p.add_argument("--alg", default="pt", choices=["pt", "bdpt", "spcbpt"])
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--dim", default=None, help="WxH override, e.g. 512x512")
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--out", default="render.png")
    p.add_argument("--hdr-out", default=None, help="also save HDR npz")
    p.add_argument("--one-frame", action="store_true",
                   help="render a single sample (reference P key)")
    p.add_argument("--print-camera", action="store_true")
    p.add_argument("--light-paths", type=int, default=100_000,
                   help="light sub-paths per frame (reference M=100000)")
    p.add_argument("--light-depth", type=int, default=16)
    p.add_argument("--connection-n", type=int, default=3)
    p.add_argument("--train-samples", type=int, default=200_000,
                   help="pretraced paths for Gamma training")
    p.add_argument("--q-samples", type=int, default=500_000)
    p.add_argument("--classifier", default="centroid",
                   choices=["centroid", "nn"],
                   help="'nn' additionally trains the close-set refinement "
                        "network (blended first-stage sampling)")
    p.add_argument("--checkpoint", default=None,
                   help="save trained state (npz) here after preprocessing")
    p.add_argument("--resume", default=None,
                   help="load trained state instead of preprocessing")
    p.add_argument("--stats-json", default=None,
                   help="write render stats as JSON here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def resolve_scene(name: str) -> str:
    if os.path.exists(name):
        return name
    if name in ("cornell", "cornell_glossy"):
        from ..scene.cornell import default_scene_path
        return default_scene_path(glossy=name == "cornell_glossy")
    if name in ("interior", "interior_lit", "interior_cove"):
        from ..scene.interior import default_scene_path
        mode = {"interior": "interior", "interior_lit": "lit",
                "interior_cove": "cove"}[name]
        return default_scene_path(mode=mode)
    raise SystemExit(f"scene not found: {name}")


def generate_interior(root: str, scale: int) -> str:
    """The procedural interior at `scale` (1: 2,264 triangles; 4, the
    builtin's: 32,576), generated under `root`; returns its scene path."""
    from ..scene.interior import generate
    return generate(root, scale=scale)


def load_interior(scale: int, device):
    """The procedural interior at `scale` (4: the builtin scene; others
    generated in a temporary directory) on `device`, in the mode its size
    picks: (TraceScene, Camera), the camera square."""
    import tempfile
    from ..scene.scene import load_trace_scene
    with tempfile.TemporaryDirectory() as root:
        path = (resolve_scene("interior") if scale == 4
                else generate_interior(root, scale))
        ts, _, cam = load_trace_scene(path, device)
    cam.aspect = 1.0
    return ts, cam


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    device = torch.device(args.device)

    from ..config import PT_MAX_DEPTH, PretraceConfig
    from .. import checkpoint
    from ..render.film import Film
    from ..scene.scene import load_trace_scene
    from ..train import classify, pipeline

    scene_path = resolve_scene(args.scene)
    t0 = time.time()
    ts, desc, cam = load_trace_scene(scene_path, device)
    width, height = desc.width, desc.height
    if args.dim:
        width, height = map(int, args.dim.lower().split("x"))
        cam.aspect = width / height
    eye, U, V, W = cam.uvw()
    print(f"[scene] {scene_path}: {ts.num_tris} tris, "
          f"{ts.num_lights} lights, mode={ts.mode} "
          f"({time.time()-t0:.1f}s)", flush=True)
    if args.print_camera:
        print(f"[camera] eye {desc.eye} lookat {desc.lookat} up {desc.up} "
              f"fov {desc.fov}")

    spp = 1 if args.one_frame else args.spp
    max_depth = args.max_depth or (PT_MAX_DEPTH if args.alg == "pt" else 16)
    film = Film(width, height, device)
    stats = {"alg": args.alg, "width": width, "height": height, "spp": spp,
             "device": str(device), "phases": {}}
    if device.type == "cuda":
        # set-up, not render time: build (or load) the traversal kernels
        from ..kernels import build
        name = {"walk": "ray_walk", "tile": "tile_walk"}.get(ts.mode,
                                                             "brute_trace")
        t0 = time.time()
        build.load(name)
        stats["phases"]["kernel_build"] = time.time() - t0
        print(f"[build] {name} kernels ready "
              f"({stats['phases']['kernel_build']:.1f}s)", flush=True)
        classify.use_fp32_matmul()

    ss = classify.untrained_state(device)
    if args.alg == "spcbpt" and args.resume:
        ss = checkpoint.load_subspace_state(args.resume, device)
        print(f"[train] resumed from {args.resume}", flush=True)
    elif args.alg == "spcbpt":
        print("[train] preprocessing (pretrace + trees + Q + Gamma)...",
              flush=True)
        cfg = PretraceConfig(num_core=8192, target_samples=args.train_samples,
                             target_q_samples=args.q_samples)
        ss, pstats = pipeline.preprocess(
            ts, (eye, U, V, W), width, height, cfg,
            lt_paths=min(args.light_paths, 50_000),
            lt_depth=min(args.light_depth, 8),
            nn_train=args.classifier == "nn", verbose=True)
        stats["phases"]["preprocess"] = pstats.seconds
        stats["train"] = dict(
            n_paths=pstats.n_paths, n_conns=pstats.n_conns,
            q_paths=pstats.q_paths, gamma_losses=pstats.gamma_losses,
            pretrace_launches=pstats.pretrace_launches,
            q_launches=pstats.q_launches, second_stage=pstats.second_stage,
            flux_dr=pstats.flux_dr, nn_losses=pstats.nn_losses)
        print(f"[train] done: {pstats.seconds}", flush=True)
        if args.checkpoint:
            checkpoint.save_subspace_state(args.checkpoint, ss)
            print(f"[train] checkpoint -> {args.checkpoint}", flush=True)

    _sync(device)
    t_render = time.time()
    if args.alg == "pt":
        from ..render import pt_pool
        fsum, count = pt_pool.render_pool(ts, (eye, U, V, W), width, height,
                                          spp, args.seed, max_depth=max_depth)
    else:
        from ..render import light_trace, lvc, spcbpt_pool
        uniform = args.alg == "bdpt"
        build_sampler = lvc.make_builder(None if uniform else ss)
        fsum = torch.zeros((width * height, 3), device=device)
        count = torch.zeros((width * height,), dtype=torch.int32,
                            device=device)
        if args.alg == "spcbpt" and ss.trained:
            print(f"[render] second stage '{ss.second_stage}'", flush=True)
        stats["frames"] = []
        for s in range(spp):
            t_lt = time.time()
            lv = light_trace.trace_light_paths(
                ts, ss, args.light_paths, s + args.seed + 7919,
                max_depth=args.light_depth)
            sampler = build_sampler(lv, s + args.seed)
            _sync(device)
            t_eye = time.time()
            fs, ct = spcbpt_pool.render_pool(
                ts, ss, sampler, (eye, U, V, W), width, height, 1,
                s + args.seed, max_depth=max_depth,
                connection_n=args.connection_n, uniform=uniform)
            fsum += fs
            count += ct
            _sync(device)
            light_ms = 1e3 * (t_eye - t_lt)
            eye_ms = 1e3 * (time.time() - t_eye)
            stats["frames"].append({"light_ms": light_ms, "eye_ms": eye_ms})
            print(f"[frame {s+1}/{spp}] light {light_ms:.0f} ms "
                  f"+ eye {eye_ms:.0f} ms", flush=True)
    film.accum = fsum / torch.clamp(count[:, None], min=1)
    film.subframe = spp
    _sync(device)
    dt = time.time() - t_render
    rays = width * height * spp
    stats["render_seconds"] = dt
    stats["count_min"] = int(count.min())
    stats["count_max"] = int(count.max())
    stats["mean_radiance"] = float(film.accum.mean())
    stats["finite"] = bool(torch.isfinite(film.accum).all())
    stats["samples_per_second"] = rays / dt
    print(f"[render] {spp} spp in {dt:.1f}s "
          f"({rays/dt/1e6:.2f} Mpaths/s)", flush=True)

    film.save_png(args.out)
    print(f"[out] {args.out}")
    if args.hdr_out:
        film.save_hdr(args.hdr_out)
        print(f"[out] {args.hdr_out}")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of a BDPT/SPCBPT frame goes: Cornell at 512x512, one
frame as render_cli renders it (100,000 light paths, light and eye depth 16,
3 connections), SPCBPT under a synthetic trained state.

    python -m spcbpt_tpu_torch.apps.profile_spcbpt --out prof.json
    python -m spcbpt_tpu_torch.apps.profile_spcbpt --alg bdpt

In one process, after one warm-up frame (kernel build, library init):
  1. an unprofiled frame: light-pass ms (light trace + sampler build),
     eye-pass ms, K3 launches, peak device memory;
  2. the same frame under torch.profiler: device busy ms, its share of the
     profiled wall, and the kernels that take the most device time;
  3. the same frame with a synchronised timer around each stage
     (profile_pt.stage_breakdown): each stage's exclusive ms.
Every frame uses the same seeds. Prints one JSON object and writes it to
`--out`. Needs a CUDA card, except `frame_fn` and STAGES, which the CPU
tests use.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..kernels import brute_trace as kernels
from ..render import light_trace, lvc, rmis, spcbpt, spcbpt_pool
from ..train import classify
from . import profile_pt

# (module, attribute, stage), looked up at call time as in profile_pt
STAGES = (
    (light_trace, "trace_light_paths", "light pass (the rest)"),
    (light_trace, "trace_closest", "light trace_closest wrapper"),
    (lvc, "build_sampler", "LVC build_sampler"),
    (spcbpt_pool, "_eye_bounce", "eye bounce (the rest)"),
    (spcbpt, "trace_closest", "eye trace_closest wrapper"),
    (spcbpt, "local_geometry", "eye local_geometry"),
    (rmis, "tracing_update_eye", "tracing_update_eye"),
    (rmis, "light_hit_cached", "light_hit_cached"),
    (classify, "classify", "classify (labels)"),
    (spcbpt, "_connections", "connection sampling (the rest)"),
    (spcbpt, "connect_vertex_fused", "connect_vertex_fused"),
    (spcbpt, "visibility", "connection visibility wrapper"),
    (kernels, "closest", "K3 closest kernel"),
    (kernels, "any_hit", "K3 any kernel"),
)
SCENE, DIM, LIGHT_PATHS, DEPTH, CONNECTIONS = "cornell", 512, 100_000, 16, 3
TOP = 15


def frame_fn(ts, ss, uvw, alg: str, dim: int = DIM,
             light_paths: int = LIGHT_PATHS, device=None):
    """A function rendering one frame of render_cli's loop (frame 0, seed 0)
    and returning (film_sum, count, light_ms, eye_ms)."""
    uniform = alg == "bdpt"
    build = lvc.make_builder(None if uniform else ss)
    device = device or ts.device

    def frame():
        t0 = time.perf_counter()
        lv = light_trace.trace_light_paths(ts, ss, light_paths, 7919,
                                           max_depth=DEPTH)
        sampler = build(lv, 0)
        profile_pt._sync(device)
        t1 = time.perf_counter()
        out = spcbpt_pool.render_pool(ts, ss, sampler, uvw, dim, dim, 1, 0,
                                      max_depth=DEPTH,
                                      connection_n=CONNECTIONS,
                                      uniform=uniform)
        profile_pt._sync(device)
        t2 = time.perf_counter()
        return (*out, (t1 - t0) * 1e3, (t2 - t1) * 1e3)
    return frame


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--alg", default="spcbpt", choices=["bdpt", "spcbpt"])
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_spcbpt: no CUDA device is available")
    from ..scene.scene import load_trace_scene
    from .render_cli import resolve_scene

    device = torch.device("cuda", 0)
    classify.use_fp32_matmul()
    ts, _, cam = load_trace_scene(resolve_scene(SCENE), device)
    cam.aspect = 1.0
    ss = (classify.synthetic_trained_state(ts, seed=0)
          if args.alg == "spcbpt" else classify.untrained_state(device))
    frame = frame_fn(ts, ss, cam.uvw(), args.alg)

    frame()                                      # warm-up, kernel build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, count, light_ms, eye_ms = frame()
    out = {"card": torch.cuda.get_device_name(0), "scene": SCENE,
           "alg": args.alg, "num_tris": ts.num_tris, "mode": ts.mode,
           "dim": DIM, "light_paths": LIGHT_PATHS, "depth": DEPTH,
           "connections": CONNECTIONS,
           "wall_ms": (time.perf_counter() - t0) * 1e3,
           "light_ms": light_ms, "eye_ms": eye_ms,
           "count_exact": bool((count == 1).all()),
           "launches": dict(kernels.LAUNCHES),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    out.update(profile_pt._device_profile(frame, TOP))
    out["busy_share_of_wall"] = out["device_busy_ms"] / out["wall_ms"]
    out["synchronised_stages"] = profile_pt.stage_breakdown(frame, device,
                                                            STAGES)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

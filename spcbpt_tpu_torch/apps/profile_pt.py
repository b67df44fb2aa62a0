"""Where the time of a PT render goes: the interior at 1024x1024, 1 spp.

    python -m spcbpt_tpu_torch.apps.profile_pt --out prof.json

In one process, after one warm-up render:
  1. an unprofiled render: wall ms, pool iterations (K1 launches), peak
     device memory;
  2. the same render under torch.profiler: device busy ms (the union of the
     device's kernel and copy intervals), its share of the profiled wall,
     and the kernels that take the most device time;
  3. the same render with a synchronised timer around each stage: each
     stage's exclusive ms (its own time less that of the stages it calls),
     the rest of the render booked to the pool loop. The syncs stall the
     host, so this render is slower than the first; the shares are what it
     is for.
Prints one JSON object and writes it to `--out`. Needs a CUDA card, except
`stage_breakdown`, which also runs on the CPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import torch

from ..kernels import ray_walk as kernels
from ..ops import ray_walk
from ..render import pt_pool

# (module, attribute, stage): the functions timed by stage_breakdown. Each is
# looked up through its module at call time, so replacing the attribute
# times every call the render makes.
STAGES = (
    (ray_walk, "row_entries", "row_entries"),
    (ray_walk, "prepare", "sort key + argsort + pad"),
    (kernels, "closest", "K1 closest kernel"),
    (kernels, "any_hit", "K2 any-hit kernel"),
    (ray_walk, "closest_rows_plain", "K1 plain version"),
    (ray_walk, "any_rows_plain", "K2 plain version"),
    (ray_walk, "walk_closest", "walk_closest unsort + hit"),
    (ray_walk, "walk_any", "walk_any unsort"),
    (pt_pool, "local_geometry", "local_geometry"),
    (pt_pool, "emitter_hit", "emitter_hit"),
    (pt_pool, "_nee", "NEE without its shadow trace"),
    (pt_pool, "bounce", "RR + BSDF bounce"),
)
REST = "pool loop (the rest)"
SCENE, DIM, SPP, SEED = "interior", 1024, 1, 0   # the PT ms/spp metric's render
TOP = 15                                          # kernels listed by device ms


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_breakdown(render, device: torch.device, stages=STAGES) -> dict:
    """Run `render()` once with a synchronised timer around each stage of
    `stages` ((module, attribute, stage) triples). Returns {"total_ms",
    "stages": {stage: {"ms", "calls"}}}; the stages' exclusive ms and REST
    add up to total_ms."""
    ms = collections.defaultdict(float)
    calls = collections.Counter()
    stack = []          # per open stage: ms spent in the stages it called

    def timed(fn, stage):
        def inner(*args, **kwargs):
            _sync(device)
            t0 = time.perf_counter()
            stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(device)
                dt = (time.perf_counter() - t0) * 1e3
                ms[stage] += dt - stack.pop()
                calls[stage] += 1
                if stack:
                    stack[-1] += dt
        return inner

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in stages]
    for (mod, name, fn), (_, _, stage) in zip(saved, stages):
        setattr(mod, name, timed(fn, stage))
    try:
        _sync(device)
        t0 = time.perf_counter()
        render()
        _sync(device)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    out = {s: {"ms": ms[s], "calls": calls[s]} for _, _, s in stages
           if calls[s]}
    out[REST] = {"ms": total - sum(ms.values()), "calls": 1}
    return {"total_ms": total, "stages": out}


def _device_profile(render, top: int) -> dict:
    """Device busy ms of one render under torch.profiler, and its `top`
    kernels by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        render()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    spans = []
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        k = per_kernel[ev.name[:100]]
        k[0] += (end - start) / 1e3
        k[1] += 1
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):                   # union of the intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms_profiled": wall, "device_busy_ms": busy_us / 1e3,
            "busy_share_of_profiled_wall": busy_us / 1e3 / wall,
            "device_events": len(spans),
            "top_kernels": [{"name": n, "device_ms": v[0], "count": v[1]}
                            for n, v in ranked]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pt: no CUDA device is available")
    from ..scene.scene import load_trace_scene
    from .render_cli import resolve_scene

    device = torch.device("cuda", 0)
    ts, _, cam = load_trace_scene(resolve_scene(SCENE), device)
    cam.aspect = 1.0
    uvw = cam.uvw()

    def render():
        return pt_pool.render_pool(ts, uvw, DIM, DIM, SPP, SEED)

    render()                                     # warm-up, kernel build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    render()
    torch.cuda.synchronize()
    out = {"card": torch.cuda.get_device_name(0), "scene": SCENE,
           "num_tris": ts.num_tris, "mode": ts.mode, "dim": DIM, "spp": SPP,
           "wall_ms": (time.perf_counter() - t0) * 1e3,
           "launches": dict(kernels.LAUNCHES),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    out.update(_device_profile(render, TOP))
    out["busy_share_of_wall"] = out["device_busy_ms"] / out["wall_ms"]
    out["synchronised_stages"] = stage_breakdown(render, device)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of a PT render goes: the interior at 1024x1024, 1 spp.

    python -m spcbpt_tpu_torch.apps.profile_pt --out prof.json
    python -m spcbpt_tpu_torch.apps.profile_pt --mode tile

`--mode` picks the scene's traversal: the row walk (K1/K2, the default) or
the tile walk (K4 rounds for closest hits, K5 for any hits).
In one process, after one warm-up render:
  1. an unprofiled render: wall ms, the traversal kernels' launches (and the
     tile walk's rounds and host syncs), peak device memory;
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
from ..kernels import tile_walk as tile_kernels
from ..ops import pallas_tile, ray_walk, tile_trace
from ..render import pt_pool
from ..utils.profiling import nvidia_smi_line

# (module, attribute, stage): the functions timed by stage_breakdown. Each is
# looked up through its module at call time, so replacing the attribute
# times every call the render makes.
_PT_STAGES = (
    (pt_pool, "local_geometry", "local_geometry"),
    (pt_pool, "emitter_hit", "emitter_hit"),
    (pt_pool, "_nee", "NEE without its shadow trace"),
    (pt_pool, "bounce", "RR + BSDF bounce"),
)
# row_entries and the plain versions run only on CPU tensors: on the card
# K1/K2 compute their rows' entries themselves
STAGES = (
    (ray_walk, "row_entries", "row_entries"),
    (ray_walk, "prepare", "sort key + argsort + pad"),
    (kernels, "closest", "K1 closest kernel"),
    (kernels, "any_hit", "K2 any-hit kernel"),
    (ray_walk, "closest_rows_plain", "K1 plain version"),
    (ray_walk, "any_rows_plain", "K2 plain version"),
    (ray_walk, "walk_closest", "walk_closest unsort + hit"),
    (ray_walk, "walk_any", "walk_any unsort"),
) + _PT_STAGES
# the tile mode: K4's round walk and K5 on the card, the matmul walk on the
# CPU
TILE_STAGES = (
    (tile_trace, "tile_entries", "tile_entries"),
    (tile_trace, "_prepare", "visit-order sort + tile order"),
    (tile_kernels, "round_walk", "K4 round-walk kernel"),
    (tile_kernels, "walk_any", "K5 any-hit kernel"),
    (tile_trace, "_closest_loop", "matmul closest walk"),
    (tile_trace, "_any_loop", "matmul any walk"),
    (tile_trace, "tile_closest", "tile_closest sort + pad + unsort"),
    (pallas_tile, "pallas_any", "pallas_any sort + pad + unsort"),
    (tile_trace, "tile_any", "tile_any sort + pad + unsort"),
) + _PT_STAGES
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
    p.add_argument("--mode", default="walk", choices=["walk", "tile"],
                   help="the scene's traversal mode")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pt: no CUDA device is available")
    from ..scene.scene import load_trace_scene
    from .render_cli import resolve_scene

    device = torch.device("cuda", 0)
    ts, _, cam = load_trace_scene(resolve_scene(SCENE), device,
                                  mode=args.mode)
    tile = ts.mode == "tile"
    launch_mod = tile_kernels if tile else kernels
    cam.aspect = 1.0
    uvw = cam.uvw()

    def render():
        return pt_pool.render_pool(ts, uvw, DIM, DIM, SPP, SEED)

    render()                                     # warm-up, kernel build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_mod.reset_launches()
    tile_trace.reset_walk_stats()
    ray_walk.PLAIN_CALLS["row_entries"] = 0
    t0 = time.perf_counter()
    render()
    torch.cuda.synchronize()
    out = {"card": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi_line(), "scene": SCENE,
           "num_tris": ts.num_tris, "mode": ts.mode, "dim": DIM, "spp": SPP,
           "wall_ms": (time.perf_counter() - t0) * 1e3,
           "launches": dict(launch_mod.LAUNCHES),
           "row_entries_calls": ray_walk.PLAIN_CALLS["row_entries"],
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    if tile:
        out["round_walk"] = dict(tile_trace.WALK_STATS)
    out.update(_device_profile(render, TOP))
    out["busy_share_of_wall"] = out["device_busy_ms"] / out["wall_ms"]
    out["synchronised_stages"] = stage_breakdown(
        render, device, TILE_STAGES if tile else STAGES)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

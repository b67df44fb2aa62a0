"""One run of one cell: set-up, the timed window of frames, the traced
stretch (`--trace 1`), the check against the plain reference, and the
result line.

Set-up runs from the process's start to the first timed frame: imports,
the CUDA context, the scene and its clusters (the program's
`load_trace_scene`), the traversal kernels' library, the subspace state
from the seed (SPCBPT), and one warm-up frame. Its parts are printed on
stderr as `[setup]`.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

import torch

from . import check, frames, inputs, manifest, trace

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "spcbpt_tpu")
# whole frames in the traced stretch (one more names the idle gaps)
TRACE_FRAMES = 2


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def first_subframe(seed: int) -> int:
    """The window's first subframe (the warm-up frame takes the one
    before): every seed renders the same work with other samples."""
    return 2 + int(seed) % (1 << 30)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def run(workload: str, seed: int, seconds: float, traced: bool,
        root: str = manifest.ROOT, device=None, t_start: float = None,
        log=print) -> dict:
    """The cell's run; returns the result line's object. `device` is the
    card unless given (tests pass the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    setup = {}
    mark = [t_start]

    def phase(name):
        now = time.perf_counter()
        setup[name] = now - mark[0]
        mark[0] = now

    from spcbpt_tpu_torch.kernels import build, read_launches, reset_launches
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import classify
    phase("import")

    man = manifest.load(root)
    wl = manifest.workload(man, workload)
    cfg = manifest.config(man, wl["config"], root)
    traffic = manifest.traffic(wl["traffic"], root)
    limits = manifest.limits(workload, root)
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
        classify.use_fp32_matmul()
    phase("cuda_context")

    path = inputs.scene_path(cfg, root)
    ts, desc, cam = load_trace_scene(path, dev)
    width, height = cfg["image"]
    cam.aspect = width / height
    uvw = cam.uvw()
    phase("scene")

    if cuda:
        build.load({"walk": "ray_walk", "tile": "tile_walk"}.get(
            ts.mode, "brute_trace"))
    phase("kernels")

    spcbpt = traffic["algorithm"] == "spcbpt"
    arrays, ss = {}, None
    if spcbpt:
        arrays = inputs.state_arrays(seed, inputs.geometry(path), dev)
        ss = inputs.program_state(arrays, dev)
    phase("state")

    first = first_subframe(seed)
    loop = frames.Frames(traffic, ts, uvw, ss, width, height, first)
    pixels = check.pick_pixels(seed, width * height, dev)
    rec = check.Recorder(
        pixels,
        check.pick_frames(seed, check.LV_SPAN, 1)[0] if spcbpt else None)
    loop.render(-1)                      # warm-up: subframe first - 1
    for v in loop.spans.values():
        v.clear()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    phase("warmup")
    setup_s = time.perf_counter() - t_start
    log("[setup] " + json.dumps({k: round(v, 4) for k, v in setup.items()}),
        file=sys.stderr)

    # ---- the timed window ----
    reset_launches()
    t0 = time.perf_counter()
    k = 0
    while True:
        loop.render(k, rec.keep(k))
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    n_frames = k
    launches = read_launches()
    frame_s = list(loop.spans["frame_s"])

    prof = None
    if traced:
        n_trace = TRACE_FRAMES

        def traced_frames():
            for j in range(n_frames, n_frames + n_trace):
                loop.render(j, rec.keep(j), fence=True)

        def gap_frame():
            loop.render(n_frames + n_trace, rec.keep(n_frames + n_trace))
        prof = trace.profile(traced_frames, gap_frame, dev)
        prof["frames"] = n_trace
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    card = _card_line() if cuda else "cpu"
    frame_ms = sorted(1e3 * x for x in frame_s)
    log("[frames] " + json.dumps({
        "card": card, "frames": n_frames, "window_s": window_s,
        "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_p95": frame_ms[min(len(frame_ms) - 1,
                                     int(0.95 * len(frame_ms)))],
        "frame_ms_max": frame_ms[-1],
        "frame_ms": [round(1e3 * x) for x in frame_s],
        "launches": launches,
        "first_subframe": first}), file=sys.stderr)

    # ---- the check, with the program's state freed ----
    kept = sorted(rec.samples)
    if spcbpt:
        checked = rec.lv_frames()
    else:
        checked = [kept[i] for i in check.pick_frames(
            seed, len(kept), int(traffic["check_frames"]))]
    prog = [rec.samples[j].float().cpu() for j in checked]
    prog_lvs = [rec.lvs[j] for j in checked] if spcbpt else None
    # the spans of the traced frames' two passes (fenced), the window's
    # frames
    spans = {"light_s": list(loop.spans["light_s"]),
             "eye_s": list(loop.spans["eye_s"]), "frame_s": frame_s}
    bad_pairs, bad_frames = rec.count_errors()
    state_np = inputs.host_copy(arrays)
    del loop, ts, ss, arrays, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref, ref_lvs = check.reference_frames(
        traffic, path, width, height, [first + j for j in checked],
        pixels, state_np, dev)
    numbers = dict(check.compare(prog, ref), count_errors=bad_pairs)
    if spcbpt:
        numbers.update(check.compare_light(prog_lvs, ref_lvs))
    correct, compared = check.judge(numbers, limits)
    log("[check] " + json.dumps({
        "frames_checked": [first + j for j in checked],
        "pixels": int(pixels.shape[0]), **numbers,
        "seconds": time.perf_counter() - t_check}), file=sys.stderr)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    record = {"setup_s": setup_s, "setup": setup, "window_s": window_s,
              "frames": n_frames,
              "spans": spans, "launches": launches, "profile": prof}
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in manifest.reported(man, wl, kind):
        value = manifest.reader(m["name"], root).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": n_frames,
           "failed": bad_frames, "metrics": metrics, "device": dev_info}
    if traced:
        dev_info["busy_s"] = prof["busy_s"]
        dev_info["window_s"] = prof["wall_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
        log("[trace] " + json.dumps({k: prof[k] for k in (
            "frames", "wall_s", "busy_s", "kernels", "events", "reduce_s")}),
            file=sys.stderr)
    out["compared"] = compared
    for name, v in compared.items():
        log(f"compared {name} {v['value']} limit {v['limit']}",
            file=sys.stderr)
    return out

"""Warm ms/spp of PT and uniform BDPT on the interior: the port of the JAX
package's tools/time_frames.py, the fixed probe of the pool loops.

    python -m spcbpt_tpu_torch.apps.time_frames
    python -m spcbpt_tpu_torch.apps.time_frames --device cpu --dim 32 --scale 1 --light-paths 256,512

From the untrained subspace state (classify.untrained_state), at
--dim x --dim (512):
  * PT, depth PT_DEPTH, 1 spp a call;
  * uniform BDPT at each of --light-paths (16,384 and 65,536): a call traces
    that many light paths of depth LIGHT_DEPTH with frame s, builds the
    sampler and renders 1 spp of depth PT_DEPTH with subframe s.
Each is called once warm (s = 0), then CALLS times (s = 1..CALLS), each
call synchronised, as JAX blocks on each. Prints JAX's three lines
("pt: <ms> ms/spp", "bdpt lp=<n>: <ms> ms/spp") and, on the card, the card's
name and power limit (nvidia-smi). Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..render import light_trace, lvc, pt_pool, spcbpt_pool
from ..train import classify
from ..utils.profiling import nvidia_smi_line
from .render_cli import _sync, load_interior

PT_DEPTH = 12
LIGHT_DEPTH = 8
CALLS = 4


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dim", type=int, default=512, help="frame side")
    p.add_argument("--scale", type=int, default=4,
                   help="interior tessellation scale (4: the builtin scene)")
    p.add_argument("--light-paths", default="16384,65536",
                   help="comma-separated light paths a BDPT frame")
    return p


def pt_frame(ts, uvw, side: int, s: int):
    """One PT sample a pixel with subframe s: (film sum, counts)."""
    return pt_pool.render_pool(ts, uvw, side, side, 1, s, max_depth=PT_DEPTH)


def bdpt_frame(ts, ss, uvw, side: int, light_paths: int, s: int):
    """One uniform BDPT sample a pixel from a light-vertex cache of frame s:
    (film sum, counts)."""
    lv = light_trace.trace_light_paths(ts, ss, light_paths, s,
                                       max_depth=LIGHT_DEPTH)
    return spcbpt_pool.render_pool(ts, ss, lvc.build_sampler(lv), uvw, side,
                                   side, 1, s, max_depth=PT_DEPTH,
                                   uniform=True)


def time_frames(fn, dev):
    """fn(s) for s = 0 (warm) then 1..CALLS, each synchronised; returns (ms
    a call, the last call's output)."""
    def call(s):
        out = fn(s)
        _sync(dev)
        return out

    call(0)
    t0 = time.perf_counter()
    for s in range(1, CALLS + 1):
        out = call(s)
    return (time.perf_counter() - t0) / CALLS * 1e3, out


def run(args) -> list:
    """Times the frames, printing a line each; returns [(label, ms, (film
    sum, counts) of the last call)]."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        classify.use_fp32_matmul()
        print(f"card: {nvidia_smi_line()}", flush=True)
    ts, cam = load_interior(args.scale, dev)
    uvw = cam.uvw()
    ss = classify.untrained_state(dev)
    side = args.dim

    out = []
    ms, img = time_frames(lambda s: pt_frame(ts, uvw, side, s), dev)
    print(f"pt: {ms:.1f} ms/spp", flush=True)
    out.append(("pt", ms, img))
    for lp in (int(x) for x in args.light_paths.split(",")):
        ms, img = time_frames(
            lambda s: bdpt_frame(ts, ss, uvw, side, lp, s), dev)
        print(f"bdpt lp={lp}: {ms:.1f} ms/spp", flush=True)
        out.append((f"bdpt lp={lp}", ms, img))
    return out


def main(argv=None) -> int:
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The one traffic generator: progressive frames of the program, from a
traffic mix's parameters.

Frame k renders one sample of every pixel with subframe `first + k`
(upstream's progressive frame: one sample per pixel per frame), as
the program's CLI (`apps/render_cli.py`) and its frame timer
(`apps/time_frames.py`) drive the pools, and ends in a device sync; the
loop is closed. The algorithms:

* "pt": `render/pt_pool.render_pool(ts, uvw, W, H, 1, subframe,
  max_depth, n_pool)`;
* "spcbpt": `render/light_trace.trace_light_paths(ts, ss, light_paths,
  subframe + LIGHT_FRAME_OFFSET, light_depth)`, then
  `render/lvc.make_builder(ss)(lv, subframe)`, then
  `render/spcbpt_pool.render_pool(...)` with `connection_n`, `eye_depth`
  and `n_pool`, with no sync between them, as the CLI runs them.

The frame's film and counts are added into the progressive sums, as the
CLI adds them. Host-clock spans, each ending in a sync: `frame_s` for
every frame; `light_s` (the light pass and its sampler) and `eye_s` (the
eye pool and the sums) only for a frame rendered with `fence`, which
adds a sync between the two passes, so that the timed window never has
one.
"""
from __future__ import annotations

import time

import torch

# the light pass of frame s traces with frame index s + this, as the CLI's
LIGHT_FRAME_OFFSET = 7919


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Frames:
    def __init__(self, traffic: dict, ts, uvw, ss, width: int, height: int,
                 first: int):
        self.t = traffic
        self.ts, self.uvw, self.ss = ts, uvw, ss
        self.width, self.height = width, height
        self.first = first
        self.device = ts.device
        n = width * height
        self.fsum = torch.zeros((n, 3), device=self.device)
        self.count = torch.zeros((n,), dtype=torch.int32, device=self.device)
        self.spans = {"light_s": [], "eye_s": [], "frame_s": []}
        if traffic["algorithm"] == "spcbpt":
            from spcbpt_tpu_torch.render import lvc
            self.builder = lvc.make_builder(ss)

    def subframe(self, k: int) -> int:
        return self.first + k

    def render(self, k: int, keep=None, fence: bool = False):
        """Frame k: (film sum (W*H, 3), counts (W*H,)) of its samples, the
        sums and spans updated. keep(fs, ct, lv) is queued before the
        frame's last sync (the check's gathers; lv, the frame's light
        vertices, is None for path tracing). fence: a sync after the light
        pass, for the spans of the two passes."""
        t = self.t
        s = self.subframe(k)
        t0 = time.perf_counter()
        if t["algorithm"] == "pt":
            from spcbpt_tpu_torch.render import pt_pool
            t1, lv = t0, None
            fs, ct = pt_pool.render_pool(
                self.ts, self.uvw, self.width, self.height, 1, s,
                n_pool=int(t["n_pool"]), max_depth=int(t["max_depth"]))
        elif t["algorithm"] == "spcbpt":
            from spcbpt_tpu_torch.render import light_trace, spcbpt_pool
            lv = light_trace.trace_light_paths(
                self.ts, self.ss, int(t["light_paths"]),
                s + LIGHT_FRAME_OFFSET,
                max_depth=int(t["light_depth"]))
            sampler = self.builder(lv, s)
            if fence:
                sync(self.device)
                t1 = time.perf_counter()
                self.spans["light_s"].append(t1 - t0)
            fs, ct = spcbpt_pool.render_pool(
                self.ts, self.ss, sampler, self.uvw, self.width, self.height,
                1, s, n_pool=int(t["n_pool"]),
                max_depth=int(t["eye_depth"]),
                connection_n=int(t["connection_n"]))
        else:
            raise SystemExit(f"unknown algorithm {t['algorithm']!r}")
        self.fsum += fs
        self.count += ct
        if keep is not None:
            keep(fs, ct, lv)
        sync(self.device)
        t2 = time.perf_counter()
        if fence and t["algorithm"] != "pt":
            self.spans["eye_s"].append(t2 - t1)
        self.spans["frame_s"].append(t2 - t0)
        return fs, ct

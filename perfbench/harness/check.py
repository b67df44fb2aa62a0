"""How `correct` is decided: the program's samples and light vertices from
the timed window against the plain reference's, and the counts of every
pixel.

Before the window a set of pixels is drawn from the seed, and for SPCBPT
one of the first LV_SPAN frames. After each frame its samples at those
pixels are gathered (queued before the frame's last sync) with the number
of its pixels whose sample count is not 1; the drawn frame's light
vertices are kept, and the latest frame's. After the window the reference
works from the scene files and the state arrays alone. The numbers
compared:

* `mismatch_share`: the share of compared samples that depart from the
  reference's by more than RTOL * |reference| + ATOL in some channel. A
  pixel's sample is a deterministic function of (pixel, subframe) and,
  for SPCBPT, of the frame's light vertices, so the two sides agree to
  rounding wherever the path takes the same turns. Path tracing: frames
  drawn from the seed among those completed. SPCBPT: the drawn frame (the
  latest completed if the window ended before it), rendered whole by the
  reference: its own light pass, its own sampler, its eye pass.
* `light_mismatch_share` (SPCBPT): the share of the program's light
  vertices of that frame (valid on either side) departing from the
  reference's own light pass: an id, flag or depth that differs, or a
  float field off by more than RTOL of its magnitude.
* `count_errors`: (frame, pixel) pairs of the run whose sample count is
  not 1. Exact: limit 0.

The control is the reference in bfloat16 put in the program's place
(`perfbench/control.py`); no run of the benchmark runs it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .frames import LIGHT_FRAME_OFFSET

_SALT_PIXELS = 0x5eed01
_SALT_FRAMES = 0x5eed02
# pixels drawn a run; the tolerance of one sample: rounding (a few ulps
# here and there, relative 1e-6) passes, a path that turned does not
PIXELS = 4096
RTOL = 1e-3
ATOL = 1e-5
# SPCBPT's checked frame is drawn among the first LV_SPAN frames
LV_SPAN = 8
_EXACT = ("mat_id", "subspace_id", "eye_label", "last_zone_id", "depth",
          "is_origin", "is_env", "is_ll_direction", "is_brdf", "last_brdf",
          "valid")


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, salt])


def pick_pixels(seed: int, n_pixels: int, device, count: int = PIXELS):
    """`count` distinct pixels drawn from the seed (all of a smaller
    frame), ascending."""
    count = min(count, n_pixels)
    pix = np.sort(_rng(seed, _SALT_PIXELS).choice(n_pixels, count,
                                                  replace=False))
    return torch.as_tensor(pix, dtype=torch.int64, device=device)


def pick_frames(seed: int, n_frames: int, count: int) -> list:
    """`count` distinct frames of n_frames drawn from the seed, ascending."""
    count = min(count, n_frames)
    return sorted(int(k) for k in _rng(seed, _SALT_FRAMES).choice(
        n_frames, count, replace=False))


class Recorder:
    """Gathers each frame's samples at the drawn pixels and its bad
    counts, and keeps the light vertices of frame `lv_frame` and of the
    latest frame."""

    def __init__(self, pixels, lv_frame: int = None):
        self.pixels = pixels
        self.lv_frame = lv_frame
        self.samples = {}
        self.bad = {}
        self.lvs = {}

    def keep(self, k: int):
        def fn(fs, ct, lv):
            self.samples[k] = fs.index_select(0, self.pixels)
            self.bad[k] = (ct != 1).sum()
            if lv is not None:
                self.lvs = {j: v for j, v in self.lvs.items()
                            if j == self.lv_frame}
                self.lvs[k] = lv
        return fn

    def lv_frames(self) -> list:
        """The SPCBPT frame to check: the drawn one, or the latest."""
        if self.lv_frame in self.lvs:
            return [self.lv_frame]
        return [max(self.lvs)]

    def count_errors(self) -> tuple:
        """(bad (frame, pixel) pairs, frames with any) over kept frames."""
        bad = [int(v) for v in self.bad.values()]
        return sum(bad), sum(1 for b in bad if b)


def reference_frames(traffic: dict, scene_file: str, width: int,
                     height: int, subframes: list, pixels, state_np: dict,
                     device, dtype=torch.float32) -> tuple:
    """The reference's samples of the pixels in each subframe, (P, 3)
    float32 on the CPU, computed in `dtype`; and, for SPCBPT, the light
    vertices of its light pass of each frame, which its eye pass connects
    to."""
    from ..reference import classify as ref_classify
    from ..reference import render as ref_render
    from ..reference import scene as ref_scene

    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    ref_classify.use_fp32_matmul()
    try:
        ts, _, cam = ref_scene.load_trace_scene(scene_file, device)
        cam.aspect = width / height
        uvw = cam.uvw()
        pix = pixels.to(device)
        samples, lvs = [], []
        if traffic["algorithm"] == "pt":
            for s in subframes:
                samples.append(ref_render.pt_samples(
                    ts, uvw, width, height, pix, s,
                    int(traffic["max_depth"])).float().cpu())
            return samples, None
        ss = ref_render.subspace_state(state_np, device)
        for s in subframes:
            lv = ref_render.light_pass(ts, ss, s + LIGHT_FRAME_OFFSET,
                                       int(traffic["light_paths"]),
                                       int(traffic["light_depth"]))
            samples.append(ref_render.spcbpt_samples(
                ts, ss, uvw, width, height, pix, s, lv,
                int(traffic["eye_depth"]),
                int(traffic["connection_n"])).float().cpu())
            lvs.append(lv)
        return samples, lvs
    finally:
        torch.set_default_dtype(old)


def departs(prog, ref, rtol: float = RTOL, atol: float = ATOL):
    """(P,) bool: samples of prog (P, 3) departing from ref (P, 3) by more
    than rtol * |ref| + atol in some channel (a non-finite sample
    departs)."""
    return ~((prog - ref).abs() <= rtol * ref.abs() + atol).all(dim=1)


def compare(prog: list, ref: list) -> dict:
    """The mismatch share, with the largest relative gaps of the mismatched
    samples (their largest channel's, against the reference's largest) for
    the record."""
    total = sum(p.shape[0] for p in prog)
    miss, gaps = 0, []
    for p, r in zip(prog, ref):
        bad = departs(p, r)
        miss += int(bad.sum())
        g = (p - r).abs().amax(dim=1) / r.abs().amax(dim=1).clamp(min=ATOL)
        gaps += g[bad].tolist()
    gaps.sort()
    return {"samples": total, "mismatched": miss,
            "mismatch_share": miss / max(total, 1),
            "mismatch_rel_gaps": [round(g, 6) for g in gaps[-8:]]}


def light_departs(prog, ref):
    """Bool over the vertex axes: vertices valid on either side whose
    light-vertex record departs from the reference's."""
    bad = torch.zeros_like(ref.valid)
    for f in dataclasses.fields(ref):
        a, b = getattr(prog, f.name), getattr(ref, f.name)
        if f.name in _EXACT:
            bad |= a.to(b.dtype) != b
            continue
        a, b = a.float(), b.float()
        scale = b.abs().amax(dim=-1) if b.dim() > ref.valid.dim() \
            else b.abs()
        gap = (a - b).abs()
        if gap.dim() > ref.valid.dim():
            gap = gap.amax(dim=-1)
        bad |= ~(gap <= RTOL * scale + 1e-30)
    return bad & (prog.valid.to(torch.bool) | ref.valid)


def compare_light(prog: list, ref: list) -> dict:
    total = sum(int((p.valid.to(torch.bool) | r.valid).sum())
                for p, r in zip(prog, ref))
    miss = sum(int(light_departs(p, r).sum()) for p, r in zip(prog, ref))
    return {"light_vertices": total, "light_mismatched": miss,
            "light_mismatch_share": miss / max(total, 1)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}): every number of the cell's
    limits at or under its limit."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in out.values())
    return ok, out

"""The plain reference's entry points: one sample of chosen pixels of one
progressive frame, by path tracing or by SPCBPT, from the scene files and
the benchmark's state arrays alone.

A pixel's sample of subframe s is seeded by (pixel, s), as the program's
pools seed it, so the reference renders any set of pixels of a frame, one
lane each (`pt.make_pt_step`, `spcbpt.make_spcbpt_step`: the per-lane loops
the program's pools regenerate lanes around). An SPCBPT frame first traces
its light sub-paths with frame index `light_frame` and builds their
sampler with seed s, as the program's frame does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import classify, light_trace, lvc, pt, spcbpt, vec
from . import rng as rng_mod


def camera_rays(cam_uvw, width: int, height: int, pixels, subframe: int):
    """(origins, dirs, rng state) of sample `subframe` of each pixel; the
    sample of subframe 0 goes through the pixel's centre."""
    dev = pixels.device
    eye, U, V, W = [torch.as_tensor(np.asarray(x), device=dev).to(
        torch.get_default_dtype()) for x in cam_uvw]
    state = rng_mod.seed(pixels, subframe)
    jx, state = rng_mod.next_float(state)
    jy, state = rng_mod.next_float(state)
    if subframe == 0:
        jx = torch.full_like(jx, 0.5)
        jy = torch.full_like(jy, 0.5)
    fdt = torch.get_default_dtype()
    x = (pixels % width).to(fdt)
    y = (pixels // width).to(fdt)
    dx = 2.0 * (x + jx) / width - 1.0
    dy = 2.0 * (y + jy) / height - 1.0
    d = dx[:, None] * U + dy[:, None] * V + W
    d = d / torch.sqrt(vec.dot(d, d))[:, None]
    return eye.expand(d.shape), d, state


def pt_samples(ts, cam_uvw, width: int, height: int, pixels, subframe: int,
               max_depth: int):
    """(P, 3): the path-traced sample of subframe `subframe` of each pixel."""
    o, d, state = camera_rays(cam_uvw, width, height, pixels, subframe)
    return pt.make_pt_step(ts, max_depth)(o, d, state)


def light_pass(ts, ss, light_frame: int, light_paths: int,
               light_depth: int):
    """The frame's light vertices: `light_paths` sub-paths traced with
    frame index `light_frame`, (light_depth + 1, light_paths)."""
    return light_trace.trace_light_paths(ts, ss, light_paths, light_frame,
                                         max_depth=light_depth)


def spcbpt_samples(ts, ss, cam_uvw, width: int, height: int, pixels,
                   subframe: int, lv, eye_depth: int, connection_n: int):
    """(P, 3): the SPCBPT sample of subframe `subframe` of each pixel,
    connecting to the light vertices lv through a sampler built here."""
    sampler = lvc.make_builder(ss)(lv, subframe)
    o, d, state = camera_rays(cam_uvw, width, height, pixels, subframe)
    step = spcbpt.make_spcbpt_step(ts, ss, sampler, max_depth=eye_depth,
                                   connection_n=connection_n)
    return step(o, d, state)


def subspace_state(arrays: dict, device) -> classify.SubspaceState:
    """The trained-shaped subspace state from the benchmark's arrays
    (`perfbench/harness/inputs.state_arrays`), its derived tables worked
    out here: the row CMFs, the alias tables and the published pmfs."""
    fdt = torch.get_default_dtype()

    def t(name):
        return torch.as_tensor(np.asarray(arrays[name]), device=device).to(
            fdt)

    gamma = t("gamma")
    g64 = np.asarray(arrays["gamma"], np.float64)
    mixed = (g64 * (1.0 - classify.CONSERVATIVE_RATE)
             + classify.CONSERVATIVE_RATE / classify.NUM_SUBSPACE)
    aprob, aidx = classify.build_alias(mixed)
    diag2 = torch.tensor(float(arrays["diag2"]), device=device).to(fdt)
    return classify.publish_tables(classify.SubspaceState(
        eye=classify.Classifier(t("eye_pos"), t("eye_norm"), diag2),
        light=classify.Classifier(t("light_pos"), t("light_norm"), diag2),
        q=t("q"), cmf_gamma=classify.gamma_to_cmf(gamma),
        alias_prob=torch.as_tensor(aprob, device=device).to(fdt),
        alias_idx=torch.as_tensor(aidx, dtype=torch.int32, device=device),
        inv_occ=t("inv_occ"), trained=True, second_stage="mixture"))

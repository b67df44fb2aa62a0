"""Shared wavefront plumbing: camera rays, film accumulation.

Port of spcbpt_tpu/render/common.py."""
from __future__ import annotations

import torch

from ..utils import rng as rng_mod
from ..utils import vec


def camera_rays(eye, U, V, W, width: int, height: int, subframe: int,
                block: int = 0, device="cpu"):
    """Generate one primary ray per pixel (reference raygen.cu:100-113):
    lane i = pixel (x=i%W, y=i//W); subframe 0 uses the pixel center, later
    subframes jitter. Returns (origins, dirs, rng_state) with N = W*H lanes.
    Row 0 is the image bottom (d.y = -1).

    block > 0 emits lanes in block x block pixel tiles, so consecutive lane
    groups are spatially coherent."""
    n = width * height
    lane = torch.arange(n, dtype=torch.int64, device=device)
    state = rng_mod.seed(lane, int(subframe))
    jx, state = rng_mod.next_float(state)
    jy, state = rng_mod.next_float(state)
    if int(subframe) == 0:
        jx = torch.full_like(jx, 0.5)
        jy = torch.full_like(jy, 0.5)
    if block:
        bw = width // block
        bid = lane // (block * block)
        within = lane % (block * block)
        x = ((bid % bw) * block + within % block).to(torch.float32)
        y = ((bid // bw) * block + within // block).to(torch.float32)
    else:
        x = (lane % width).to(torch.float32)
        y = (lane // width).to(torch.float32)
    dx = 2.0 * (x + jx) / width - 1.0
    dy = 2.0 * (y + jy) / height - 1.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    eye, U, V, W = f32(eye), f32(U), f32(V), f32(W)
    d = dx[:, None] * U + dy[:, None] * V + W
    d = d / torch.sqrt(vec.dot(d, d))[:, None]
    o = eye.expand(d.shape)
    return o, d, state


def accumulate(accum, sample, subframe, clamp_c: float | None = None):
    """Progressive running mean (raygen.cu:158-166).

    clamp_c enables the consistent progressive firefly clamp of the JAX
    package: each subframe's per-channel radiance is capped at
    clamp_c * sqrt(subframe+1)."""
    sf = torch.as_tensor(float(subframe), dtype=torch.float32,
                         device=accum.device)
    if clamp_c is not None:
        sample = torch.minimum(sample, clamp_c * torch.sqrt(sf + 1.0))
    a = 1.0 / (sf + 1.0)
    return accum + (sample - accum) * a

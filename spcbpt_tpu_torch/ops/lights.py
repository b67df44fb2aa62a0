"""Light sampling: uniform light pick x per-light area sampling (quads).

Port of the quad part of spcbpt_tpu/ops/lights.py (reference lightSample,
src/OptiXPathTracer/cuProg.h:554-666): quad sampling is uniform over the
parallelogram with pdf 1/(area*num_lights); the sample's subspace id comes
from a divLevel x divLevel uv grid mapped to the reserved light-source block.
`trace_mode` starts the light sub-paths on the quads; environment lights are
not ported yet.
"""
from __future__ import annotations

import dataclasses

import math

import torch

from ..config import NUM_SUBSPACE
from ..utils import vec
from ..utils.rng import next_float


@dataclasses.dataclass
class LightSample:
    position: torch.Tensor     # (N, 3) point on light
    emission: torch.Tensor     # (N, 3)
    direction: torch.Tensor    # (N, 3) zero for quads
    normal: torch.Tensor       # (N, 3) quad normal
    uv: torch.Tensor           # (N, 2)
    pdf: torch.Tensor          # (N,) area pdf / num_lights
    subspace_id: torch.Tensor  # (N,) int32
    light_id: torch.Tensor     # (N,) int32
    is_env: torch.Tensor       # (N,) bool


def quad_subspace_id(ts, lid, uv):
    """uv-grid bin -> reserved light-source subspace id (cuProg.h:585-590)."""
    div = ts.lights.div_level[lid]
    xb = torch.clamp(torch.floor(uv[..., 0] * div).to(torch.int32), min=0)
    xb = torch.minimum(xb, div - 1)
    yb = torch.clamp(torch.floor(uv[..., 1] * div).to(torch.int32), min=0)
    yb = torch.minimum(yb, div - 1)
    light_space = ts.lights.ss_base[lid] + xb * div + yb
    return (NUM_SUBSPACE - light_space - 1).to(torch.int32)


def reverse_sample_quad(ts, lid, uv):
    """Reconstruct a light sample at emitter uv (cuProg.h:571-600)."""
    lid = lid.long()
    r1 = uv[..., 0]
    r2 = uv[..., 1]
    corner = ts.lights.corner[lid]
    position = (corner + r1[..., None] * ts.lights.u[lid]
                + r2[..., None] * ts.lights.v[lid])
    pdf = 1.0 / ts.lights.area[lid] / ts.num_lights
    return LightSample(position=position, emission=ts.lights.emission[lid],
                       direction=torch.zeros_like(position),
                       normal=ts.lights.normal[lid], uv=uv, pdf=pdf,
                       subspace_id=quad_subspace_id(ts, lid, uv),
                       light_id=lid.to(torch.int32),
                       is_env=torch.zeros(r1.shape, dtype=torch.bool,
                                          device=r1.device))


def sample_light(ts, state):
    """Uniform light pick + per-light position sample (cuProg.h:602-626).
    Returns (LightSample, new rng state)."""
    if ts.has_env:
        raise NotImplementedError("environment maps are not ported yet")
    r, state = next_float(state)
    lid = torch.clamp((r * ts.num_lights).to(torch.int32), 0,
                      ts.num_lights - 1)
    r1, state = next_float(state)
    r2, state = next_float(state)
    qlid = torch.clamp(lid, max=max(ts.num_quad_lights - 1, 0))
    return reverse_sample_quad(ts, qlid, torch.stack([r1, r2], dim=-1)), state


def trace_mode(ts, ls: LightSample, state):
    """Draw the sub-path start direction (cuProg.h:648-664): cosine
    hemisphere about the quad normal, dir_pdf = cos/pi. Returns (direction
    (N,3), origin (N,3), dir_pdf (N,), new state)."""
    if ts.has_env:
        raise NotImplementedError("environment maps are not ported yet")
    r1, state = next_float(state)
    r2, state = next_float(state)
    local = vec.cosine_sample_hemisphere(r1, r2)
    d_quad = vec.onb_transform(ls.normal, local)
    pdf_quad = torch.abs(vec.dot(d_quad, ls.normal)) / math.pi
    return d_quad, ls.position, pdf_quad, state

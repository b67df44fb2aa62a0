"""Light sampling: uniform light pick x per-light area/env sampling.

Port of spcbpt_tpu/ops/lights.py (reference lightSample,
src/OptiXPathTracer/cuProg.h:554-666): quad sampling is uniform over the
parallelogram with pdf 1/(area*num_lights); the sample's subspace id comes
from a divLevel x divLevel uv grid mapped to the reserved light-source block.
With a sky, the last slot of the uniform pick is the environment: its
sample inverts the pixel CMF (scene/envmap.env_sample), its position is
the far point 2r·d used as the NEE target, and `trace_mode` starts its
light sub-paths on the projected disk (pdf 1/(pi r^2)). The sky draws one
more float in `sample_light` and two more in `trace_mode` on every lane,
quad or env, in the JAX package's order, so the streams stay equal.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..config import NUM_SUBSPACE
from ..scene import envmap as env_mod
from ..utils import vec
from ..utils.rng import next_float


@dataclasses.dataclass
class LightSample:
    position: torch.Tensor     # (N, 3) point on light; env: far point 2r·d
    emission: torch.Tensor     # (N, 3)
    direction: torch.Tensor    # (N, 3) env: sampled direction; quads: zero
    normal: torch.Tensor       # (N, 3) quad normal; env: -direction
    uv: torch.Tensor           # (N, 2)
    pdf: torch.Tensor          # (N,) area (quad) or solid-angle (env) pdf,
                               # / num_lights
    subspace_id: torch.Tensor  # (N,) int32
    light_id: torch.Tensor     # (N,) int32
    is_env: torch.Tensor       # (N,) bool

    def trace_direction(self):
        """Direction a light sub-path leaves this sample (cuProg.h:644-646):
        env paths travel opposite the sampled env direction."""
        return vec.where3(self.is_env, -self.direction, self.direction)


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
    """Uniform light pick + per-light position/direction sample
    (cuProg.h:602-626). Returns (LightSample, new rng state)."""
    r, state = next_float(state)
    lid = torch.clamp((r * ts.num_lights).to(torch.int32), 0,
                      ts.num_lights - 1)
    r1, state = next_float(state)
    r2, state = next_float(state)
    qlid = torch.clamp(lid, max=max(ts.num_quad_lights - 1, 0))
    quad = reverse_sample_quad(ts, qlid, torch.stack([r1, r2], dim=-1))
    if not ts.has_env:
        return quad, state
    r3, state = next_float(state)
    d, env_pdf, env_col, env_label = env_mod.env_sample(ts.env, r1, r2, r3)
    is_env = lid >= ts.num_quad_lights
    far = 2.0 * ts.env.r * d  # displacement used for NEE visibility targets
    return LightSample(
        position=vec.where3(is_env, far, quad.position),
        emission=vec.where3(is_env, env_col, quad.emission),
        direction=vec.where3(is_env, d, quad.direction),
        normal=vec.where3(is_env, -d, quad.normal),
        uv=torch.where(is_env[..., None], env_mod.dir2uv(d), quad.uv),
        pdf=torch.where(is_env, env_pdf / ts.num_lights, quad.pdf),
        subspace_id=torch.where(is_env, env_label, quad.subspace_id),
        light_id=lid,
        is_env=is_env,
    ), state


def trace_mode(ts, ls: LightSample, state):
    """Draw the sub-path start direction/origin (cuProg.h:648-664).
    Quads: cosine hemisphere about the normal, dir_pdf = cos/pi.
    Env: origin on the projected disk, dir_pdf = 1/(pi r^2).
    Returns (direction (N,3), origin (N,3), dir_pdf (N,), new state)."""
    r1, state = next_float(state)
    r2, state = next_float(state)
    local = vec.cosine_sample_hemisphere(r1, r2)
    d_quad = vec.onb_transform(ls.normal, local)
    pdf_quad = torch.abs(vec.dot(d_quad, ls.normal)) / math.pi
    if not ts.has_env:
        return d_quad, ls.position, pdf_quad, state
    r3, state = next_float(state)
    r4, state = next_float(state)
    origin_env = env_mod.env_sample_project_pos(ts.env, ls.direction, r3, r4)
    pdf_env = env_mod.env_project_pdf(ts.env).expand(pdf_quad.shape)
    return (vec.where3(ls.is_env, ls.trace_direction(), d_quad),
            vec.where3(ls.is_env, origin_env, ls.position),
            torch.where(ls.is_env, pdf_env, pdf_quad), state)

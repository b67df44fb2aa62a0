"""Environment map: CMF build (host) + device sampling/pdf/label functions.

Port of spcbpt_tpu/scene/envmap.py. The host side is the same numpy as
the JAX package's, so its arrays are bit-equal: it replicates the
reference CMF construction (optixPathTracer.cpp:382-461): per-pixel
luminance plus a diamond 5x5 neighborhood average, a float64 cumsum, 25%
uniform mixture, directional lights baked into the raster. The device side
replicates envInfo_device (cuProg.h:125-243) as torch functions on the
map's device: lat-long dir<->uv mapping, CMF binary-search sampling,
solid-angle pdf, divLevel^2 subspace labels.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import NUM_SUBSPACE, NUM_SUBSPACE_LIGHTSOURCE
from ..utils import vec


@dataclasses.dataclass
class EnvMap:
    tex: torch.Tensor      # (H, W, 3) float32 radiance
    cmf: torch.Tensor      # (H*W,) float32 cumulative
    center: torch.Tensor   # (3,) scene aabb center
    r: torch.Tensor        # () float32 scene aabb diagonal length
    valid: torch.Tensor    # () bool

    @property
    def height(self) -> int:
        return self.tex.shape[0]

    @property
    def width(self) -> int:
        return self.tex.shape[1]

    @property
    def size(self) -> int:
        return self.tex.shape[0] * self.tex.shape[1]


ENV_DIV_LEVEL = int(np.sqrt(0.5 * NUM_SUBSPACE_LIGHTSOURCE))  # 10 (cpp:448)


def from_arrays(tex, cmf, center, r, valid, device) -> EnvMap:
    """An EnvMap on `device` from arrays read as numpy (e.g. a JAX map's)."""
    f32 = dict(dtype=torch.float32, device=device)
    return EnvMap(tex=torch.tensor(np.asarray(tex), **f32),
                  cmf=torch.tensor(np.asarray(cmf), **f32),
                  center=torch.tensor(np.asarray(center), **f32),
                  r=torch.tensor(np.float32(r), **f32),
                  valid=torch.tensor(bool(valid), device=device))


def dummy_envmap(device="cpu") -> EnvMap:
    """The placeholder of a scene without a sky (r = 1, so code that scales
    by env.r needs no branch)."""
    return from_arrays(np.zeros((1, 8, 3), np.float32),
                       np.ones((8,), np.float32), np.zeros((3,), np.float32),
                       1.0, False, device)


def build_envmap(raster: np.ndarray, scene_center, scene_diag: float,
                 dir_lights=(), env_factor: float = 1.0,
                 device="cpu") -> EnvMap:
    """raster: (H, W, 3) float32. dir_lights: [(direction, intensity rgb)]."""
    raster = np.asarray(raster, np.float32) * np.float32(env_factor)
    h, w, _ = raster.shape
    size = h * w
    # bake directional lights into the raster (optixPathTracer.cpp:451-456)
    for d, inten in dir_lights:
        d = np.asarray(d, np.float64)
        d = d / max(np.linalg.norm(d), 1e-30)
        u, v = _dir2uv_np(-d)
        x = min(int(u * w), w - 1)
        y = min(int(v * h), h - 1)
        raster[y, x] += np.asarray(inten, np.float32) * (size / (4 * np.pi))

    lum = raster.sum(axis=-1)  # float3weight
    # diamond |dx|+|dy|<=2 neighborhood mean added to own weight (cpp:385-417)
    offsets = [(dx, dy) for dx in range(-2, 3) for dy in range(-2, 3)
               if abs(dx) + abs(dy) <= 2]
    acc = np.zeros_like(lum)
    cnt = np.zeros_like(lum)
    for dx, dy in offsets:
        shifted = np.full_like(lum, np.nan)
        ys = slice(max(dy, 0), h + min(dy, 0))
        yd = slice(max(-dy, 0), h + min(-dy, 0))
        xs = slice(max(dx, 0), w + min(dx, 0))
        xd = slice(max(-dx, 0), w + min(-dx, 0))
        shifted[yd, xd] = lum[ys, xs]
        m = ~np.isnan(shifted)
        acc[m] += shifted[m]
        cnt[m] += 1
    p = lum + acc / np.maximum(cnt, 1)
    flat = p.reshape(-1).astype(np.float64)
    cmf = np.cumsum(flat)
    cmf /= max(cmf[-1], 1e-30)
    uniform_rate = 0.25
    i1 = np.arange(1, size + 1, dtype=np.float64) / size
    cmf = cmf * (1 - uniform_rate) + i1 * uniform_rate
    return from_arrays(raster, cmf.astype(np.float32),
                       np.asarray(scene_center, np.float32), scene_diag,
                       True, device)


# --- direction <-> uv (reference optixPathTracer.h:139-165) ---

def _dir2uv_np(d):
    theta = np.arctan2(d[0], d[2])
    phi = np.pi * 0.5 - np.arccos(np.clip(d[1], -1, 1))
    u = (theta + np.pi) * (0.5 / np.pi)
    v = 0.5 * (1.0 + np.sin(phi))
    return u, v


def dir2uv(d):
    theta = torch.atan2(d[..., 0], d[..., 2])
    phi = math.pi * 0.5 - torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    u = (theta + math.pi) * (0.5 / math.pi)
    v = 0.5 * (1.0 + torch.sin(phi))
    return torch.stack([u, v], dim=-1)


def uv2dir(uv):
    u, v = uv[..., 0], uv[..., 1]
    phi = torch.asin(torch.clamp(2.0 * v - 1.0, -1.0, 1.0))
    theta = u * (2.0 * math.pi) - math.pi
    y = torch.cos(math.pi * 0.5 - phi)
    x = torch.cos(phi) * torch.sin(theta)
    z = torch.cos(phi) * torch.cos(theta)
    return torch.stack([x, y, z], dim=-1)


def uv2coord(uv, h: int, w: int):
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), max=w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int32), max=h - 1)
    return x, y


def env_color(env: EnvMap, d):
    """Nearest-texel lookup (tex2D with point sampling semantics)."""
    x, y = uv2coord(dir2uv(d), env.height, env.width)
    return env.tex[y.long(), x.long()]


def env_pdf(env: EnvMap, d):
    """Solid-angle pdf of env sampling (cuProg.h:217-230)."""
    x, y = uv2coord(dir2uv(d), env.height, env.width)
    idx = (x + y * env.width).long()
    c = env.cmf[idx]
    prev = torch.where(idx > 0, env.cmf[torch.clamp(idx - 1, min=0)], 0.0)
    pmf = c - prev
    return pmf * env.size / (4.0 * math.pi)


def env_label(env: EnvMap, d):
    """Subspace label over a divLevel x divLevel uv grid (cuProg.h:200-215)."""
    uv = dir2uv(d)
    dl = ENV_DIV_LEVEL
    ud = torch.clamp(torch.floor(uv[..., 0] * dl).to(torch.int32), 0, dl - 1)
    vd = torch.clamp(torch.floor(uv[..., 1] * dl).to(torch.int32), 0, dl - 1)
    return (NUM_SUBSPACE - 1 - (ud * dl + vd)).to(torch.int32)


def env_sample(env: EnvMap, r1, r2, r3):
    """Draw a direction by CMF inversion + in-texel jitter (cuProg.h:163-185).

    r1 picks the texel by a right-sided search of the cmf; (r2, r3) jitter
    inside it. Returns (direction, pdf, color, label)."""
    idx = torch.searchsorted(env.cmf, r1, right=True)
    idx = torch.clamp(idx, 0, env.size - 1)
    w = env.width
    x = (idx % w).to(torch.float32)
    y = (idx // w).to(torch.float32)
    u = (x + r2) / env.width
    v = (y + r3) / env.height
    d = uv2dir(torch.stack([u, v], dim=-1))
    return d, env_pdf(env, d), env_color(env, d), env_label(env, d)


def env_sample_project_pos(env: EnvMap, d, r1, r2):
    """Start point for env light sub-paths: point on a disk of radius r,
    offset 10r along d from scene center (cuProg.h:186-194)."""
    local = vec.cosine_sample_hemisphere(r1, r2)
    t, b = vec.onb(d)
    return (10.0 * env.r * d + local[..., 0:1] * env.r * t
            + local[..., 1:2] * env.r * b + env.center)


def env_project_pdf(env: EnvMap):
    return 1.0 / (math.pi * env.r * env.r)

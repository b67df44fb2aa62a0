"""Vector math over SoA tensors of shape (..., 3).

The benchmark's plain reference: a frozen copy of
`spcbpt_tpu_torch/utils/vec.py` (what the rendered configurations use;
skies, textures and the close-set network left out), importing
nothing of the program. Float tensors take torch's default dtype,
so that the control runs it in bfloat16.

Port of spcbpt_tpu/utils/vec.py. Dot and cross products are written out
component by component, in the order XLA reduces them, so that the port
rounds like the JAX package.
"""
from __future__ import annotations

import math

import torch


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps: float = 1e-20):
    return a / torch.clamp(length(a), min=eps)[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def float3weight(c):
    """Sum of components; the reference's scalarization of flux values
    (BDPTVertex.h float3weight)."""
    return c[..., 0] + c[..., 1] + c[..., 2]


def onb(normal):
    """Orthonormal basis matching the reference construction (cuProg.h:81-111).

    Returns (tangent, binormal); frame vectors satisfy
    world = x*tangent + y*binormal + z*normal.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    use_x = torch.abs(nx) > torch.abs(nz)
    zero = torch.zeros_like(nx)
    bx = torch.where(use_x, -ny, zero)
    by = torch.where(use_x, nx, -nz)
    bz = torch.where(use_x, zero, ny)
    binormal = normalize(torch.stack([bx, by, bz], dim=-1))
    tangent = cross(binormal, normal)
    return tangent, binormal


def onb_transform(normal, local):
    """Local (x,y,z) -> world using the reference's Onb.inverse_transform."""
    t, b = onb(normal)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * normal


def cosine_sample_hemisphere(u1, u2):
    """Reference cosine_sample_hemisphere (cuProg.h:113-124): concentric-free
    sqrt disk + project up. Returns local-frame direction (..., 3)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def reflect(v, h):
    """Mirror direction of v about h (both pointing away from surface)."""
    return 2.0 * dot(v, h)[..., None] * h - v


def where3(mask, a, b):
    """Select over (...,3) given (...) mask."""
    return torch.where(mask[..., None], a, b)


def is_invalid_value(c, clamp: float = 1e5):
    """Reference ISINVALIDVALUE (raygen.cu:43): any component >1e5 or NaN."""
    bad = torch.isnan(c) | (c > clamp)
    return torch.any(bad, dim=-1)


def scrub(c, clamp: float = 1e5):
    """Zero out invalid contributions, replicating the reference's estimator
    guard (raygen.cu:43 usage)."""
    bad = is_invalid_value(c, clamp) | torch.any(torch.isinf(c), dim=-1)
    return torch.where(bad[..., None], torch.zeros_like(c), c)

"""Brute-force traversal of small scenes: every ray against every triangle.

Port of spcbpt_tpu/ops/pallas_trace.py (`pallas_closest` / `pallas_any`),
the traversal of the `brute` mode (at most 512 triangles on the card; the
Cornell box has 32). The result follows the port's trace API: misses keep
t=1e30, tri=-1, u=v=0, and ties go to the smallest triangle id.

The traversal runs where its tensors live:
  * CUDA tensors launch the hand-written kernel K3 of csrc/brute_trace.cu
    (kernels/brute_trace.py), or raise. tmin and tmax go to it as they
    come (the binding takes a number by value and an (n,) float32 tensor
    by its stride, and refuses anything else), so a call is that one
    launch;
  * CPU tensors run the plain version, intersect.brute_force_closest /
    brute_force_any, which is what the JAX scene calls in brute mode. The
    card checks the kernel against it (`brute_closest_plain` /
    `brute_any_plain` run it on any device).
"""
from __future__ import annotations

from ..kernels import brute_trace as kernels
from . import intersect
from .intersect import Hit
from .tile_trace import _as_lanes


def _chunk(num_tris: int) -> int:
    """The plain version's triangle chunk: one chunk up to 512 triangles."""
    return min(512, max(8, num_tris))


def brute_closest_plain(origins, dirs, tmin, tmax, tri_p0, tri_e1, tri_e2,
                        cull_backface: bool = True) -> Hit:
    """Plain version of K3's closest hit, on any device."""
    n = origins.shape[0]
    return intersect.brute_force_closest(
        origins, dirs, tri_p0, tri_e1, tri_e2,
        _as_lanes(tmin, n, origins.device),
        _as_lanes(tmax, n, origins.device),
        cull_backface, chunk=_chunk(tri_p0.shape[0]))


def brute_any_plain(origins, dirs, tmin, tmax, tri_p0, tri_e1, tri_e2):
    """Plain version of K3's any hit, on any device: bool (N,)."""
    n = origins.shape[0]
    return intersect.brute_force_any(
        origins, dirs, tri_p0, tri_e1, tri_e2,
        _as_lanes(tmin, n, origins.device),
        _as_lanes(tmax, n, origins.device),
        chunk=_chunk(tri_p0.shape[0]))


def brute_closest(origins, dirs, tmin, tmax, tri_p0, tri_e1, tri_e2,
                  cull_backface: bool = True) -> Hit:
    """Closest hit over all triangles: K3 on the card, its plain version on
    the CPU. tmin/tmax: numbers or (N,) tensors."""
    if origins.device.type == "cpu":
        return brute_closest_plain(origins, dirs, tmin, tmax, tri_p0, tri_e1,
                                   tri_e2, cull_backface)
    t, tri, u, v = kernels.closest(
        origins.contiguous(), dirs.contiguous(), tmin, tmax, tri_p0, tri_e1,
        tri_e2, cull_backface)
    return Hit(t=t, tri=tri, u=u, v=v)


def brute_any(origins, dirs, tmin, tmax, tri_p0, tri_e1, tri_e2):
    """Any hit (occlusion, never culled) over all triangles: K3 on the card,
    its plain version on the CPU. tmin/tmax: numbers or (N,) tensors.
    Returns bool (N,)."""
    if origins.device.type == "cpu":
        return brute_any_plain(origins, dirs, tmin, tmax, tri_p0, tri_e1,
                               tri_e2)
    return kernels.any_hit(origins.contiguous(), dirs.contiguous(), tmin,
                           tmax, tri_p0, tri_e1, tri_e2)

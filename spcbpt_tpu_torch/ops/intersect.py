"""Ray-triangle intersection (Moller-Trumbore) and brute-force tracing.

Port of spcbpt_tpu/ops/intersect.py, in plain torch as in the JAX package
(these functions sit outside Pallas there). They are the port's `brute`
traversal mode for small scenes and the oracle of the walk kernels.

Two ray "types" as in the reference (optixPathTracer.h:202-209): closest-hit
(optionally back-face culled) and any-hit occlusion (never culled).
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import vec

_EPS_DET = 1e-10
_BIG = 1e30


@dataclasses.dataclass
class Hit:
    t: torch.Tensor        # (N,) float32; large where miss
    tri: torch.Tensor      # (N,) int32; -1 where miss
    u: torch.Tensor        # (N,) float32 barycentric
    v: torch.Tensor        # (N,) float32

    @property
    def valid(self):
        return self.tri >= 0


def tri_test(origins, dirs, p0, e1, e2, cull_backface: bool):
    """Batched Moller-Trumbore. origins/dirs: (..., 3); p0/e1/e2 broadcastable
    to (..., 3). Returns (t, u, v, hit_mask)."""
    pvec = vec.cross(dirs, e2)
    det = vec.dot(e1, pvec)
    # front face: dot(dir, n) < 0 with n = cross(e1, e2)  <=>  det > 0
    det_ok = det > _EPS_DET if cull_backface else torch.abs(det) > _EPS_DET
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = origins - p0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(dirs, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def _chunks(tri_p0, tri_e1, tri_e2, chunk: int):
    """Yield (base, p0, e1, e2) blocks of `chunk` triangles; the last block is
    zero-padded (degenerate triangles never hit)."""
    t_total = tri_p0.shape[0]
    for base in range(0, t_total, chunk):
        blk = [a[base:base + chunk] for a in (tri_p0, tri_e1, tri_e2)]
        pad = chunk - blk[0].shape[0]
        if pad:
            z = blk[0].new_zeros((pad, 3))
            blk = [torch.cat([a, z]) for a in blk]
        yield base, blk[0], blk[1], blk[2]


def brute_force_closest(origins, dirs, tri_p0, tri_e1, tri_e2,
                        tmin, tmax, cull_backface: bool = True,
                        chunk: int = 512) -> Hit:
    """Closest hit over all triangles, streamed in chunks of `chunk`; ties
    go to the smallest triangle id."""
    n = origins.shape[0]
    dev = origins.device
    best_t = torch.full((n,), _BIG, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    o = origins[:, None, :]
    d = dirs[:, None, :]
    tri_ids = torch.arange(chunk, dtype=torch.int32, device=dev)[None, :]
    for base, p0, e1, e2 in _chunks(tri_p0, tri_e1, tri_e2, chunk):
        t, u, v, hit = tri_test(o, d, p0[None], e1[None], e2[None],
                                cull_backface)
        ok = hit & (t > tmin[:, None]) & (t < tmax[:, None]) \
            & (t < best_t[:, None])
        t = torch.where(ok, t, _BIG)
        tj = torch.amin(t, dim=1)
        at_min = t == tj[:, None]
        jid = torch.amin(torch.where(at_min, tri_ids, chunk), dim=1)
        pick = at_min & (tri_ids == jid[:, None])
        uj = torch.where(pick, u, 0.0).sum(dim=1)
        vj = torch.where(pick, v, 0.0).sum(dim=1)
        improved = tj < best_t
        best_t = torch.where(improved, tj, best_t)
        best_tri = torch.where(improved, base + jid, best_tri)
        best_u = torch.where(improved, uj, best_u)
        best_v = torch.where(improved, vj, best_v)
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def brute_force_any(origins, dirs, tri_p0, tri_e1, tri_e2,
                    tmin, tmax, chunk: int = 512):
    """Any-hit (occlusion): True where some triangle blocks [tmin, tmax]."""
    o = origins[:, None, :]
    d = dirs[:, None, :]
    occluded = torch.zeros(origins.shape[0], dtype=torch.bool,
                           device=origins.device)
    for _, p0, e1, e2 in _chunks(tri_p0, tri_e1, tri_e2, chunk):
        t, _, _, hit = tri_test(o, d, p0[None], e1[None], e2[None], False)
        ok = hit & (t > tmin[:, None]) & (t < tmax[:, None])
        occluded = occluded | ok.any(dim=1)
    return occluded

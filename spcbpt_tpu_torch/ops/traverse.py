"""Stackless skip-link BVH traversal (the `bvh` mode), in plain torch.

Port of spcbpt_tpu/ops/traverse.py, whose walk is an XLA while_loop with no
Pallas kernel. Every ray carries one node pointer. Per step a ray either
descends (node + 1) on a box hit, or jumps the skip link; a leaf's ray tests
its LEAF_SIZE triangle slots (unrolled) and jumps the skip link. A ray is
done when its pointer reaches the node count (any hit: also once occluded).

The JAX loop steps every lane until the last is done; here the running rays
are carried compacted and each finished ray's result is written out once.
The rays are independent, so the hits are the same.
"""
from __future__ import annotations

import torch

from .bvh import LEAF_SIZE
from .intersect import Hit, tri_test

_BIG = 1e30


def _inv_dirs(dirs):
    return 1.0 / torch.where(torch.abs(dirs) < 1e-12,
                             torch.where(dirs < 0, -1e-12, 1e-12), dirs)


def _aabb_hit(o, inv_d, bmin, bmax, tmin, tmax):
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=-1), tmin)
    far = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=-1), tmax)
    return near <= far


def _leaf_tests(o, d, lstart, lcount, leaf, tri_p0, tri_e1, tri_e2, cull):
    """Yield (slot ok, t, u, v, triangle id) for the LEAF_SIZE slots of the
    rays' current nodes (ok False off a leaf and past its count)."""
    last = tri_p0.shape[0] - 1
    for k in range(LEAF_SIZE):
        ti = torch.clamp(lstart + k, 0, last).long()
        t, u, v, hit = tri_test(o, d, tri_p0[ti], tri_e1[ti], tri_e2[ti],
                                cull)
        yield leaf & (k < lcount) & hit, t, u, v, ti


def bvh_closest(origins, dirs, tmin, tmax,
                bvh_min, bvh_max, bvh_skip, bvh_leaf_start, bvh_leaf_count,
                tri_p0, tri_e1, tri_e2, cull_backface: bool = True) -> Hit:
    """Closest hit; misses have t = 1e30, tri = -1, u = v = 0."""
    n, dev = origins.shape[0], origins.device
    n_nodes = bvh_min.shape[0]
    out_t = torch.full((n,), _BIG, device=dev)
    out_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((n,), device=dev)
    out_v = torch.zeros((n,), device=dev)
    lane = torch.arange(n, device=dev)
    o, d, inv_d = origins, dirs, _inv_dirs(dirs)
    tmn = tmin.expand(n)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_t = torch.clamp(tmax.expand(n), max=_BIG)
    best_tri = out_tri.clone()
    best_u, best_v = out_u.clone(), out_v.clone()
    while lane.numel():
        lstart = bvh_leaf_start[node]
        lcount = bvh_leaf_count[node]
        box_ok = _aabb_hit(o, inv_d, bvh_min[node], bvh_max[node], tmn,
                           best_t)
        is_leaf = lstart >= 0
        for ok, t, u, v, ti in _leaf_tests(o, d, lstart, lcount,
                                           box_ok & is_leaf, tri_p0, tri_e1,
                                           tri_e2, cull_backface):
            ok = ok & (t > tmn) & (t < best_t)
            best_tri = torch.where(ok, ti.to(torch.int32), best_tri)
            best_u = torch.where(ok, u, best_u)
            best_v = torch.where(ok, v, best_v)
            best_t = torch.where(ok, t, best_t)
        node = torch.where(box_ok & ~is_leaf, node + 1, bvh_skip[node].long())
        done = node >= n_nodes
        if bool(done.any()):
            at = lane[done]
            out_tri[at] = best_tri[done]
            out_t[at] = torch.where(best_tri[done] >= 0, best_t[done], _BIG)
            out_u[at] = best_u[done]
            out_v[at] = best_v[done]
            keep = ~done
            lane, node, o, d, inv_d, tmn = (lane[keep], node[keep], o[keep],
                                           d[keep], inv_d[keep], tmn[keep])
            best_t, best_tri, best_u, best_v = (best_t[keep], best_tri[keep],
                                                best_u[keep], best_v[keep])
    return Hit(t=out_t, tri=out_tri, u=out_u, v=out_v)


def bvh_any(origins, dirs, tmin, tmax,
            bvh_min, bvh_max, bvh_skip, bvh_leaf_start, bvh_leaf_count,
            tri_p0, tri_e1, tri_e2):
    """Occlusion within (tmin, tmax), no back-face culling -> bool (N,)."""
    n, dev = origins.shape[0], origins.device
    n_nodes = bvh_min.shape[0]
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    lane = torch.arange(n, device=dev)
    o, d, inv_d = origins, dirs, _inv_dirs(dirs)
    tmn, tmx = tmin.expand(n), tmax.expand(n)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    while lane.numel():
        lstart = bvh_leaf_start[node]
        box_ok = _aabb_hit(o, inv_d, bvh_min[node], bvh_max[node], tmn, tmx)
        is_leaf = lstart >= 0
        hit_any = torch.zeros_like(box_ok)
        for ok, t, _, _, _ in _leaf_tests(o, d, lstart, bvh_leaf_count[node],
                                          box_ok & is_leaf, tri_p0, tri_e1,
                                          tri_e2, False):
            hit_any = hit_any | (ok & (t > tmn) & (t < tmx))
        node = torch.where(box_ok & ~is_leaf, node + 1, bvh_skip[node].long())
        done = hit_any | (node >= n_nodes)
        if bool(done.any()):
            occluded[lane[hit_any]] = True
            keep = ~done
            lane, node, o, d, inv_d, tmn, tmx = (
                lane[keep], node[keep], o[keep], d[keep], inv_d[keep],
                tmn[keep], tmx[keep])
    return occluded

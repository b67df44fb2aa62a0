"""Row-walk traversal: exact per-ray cluster culling at 8-ray row
granularity.

Port of spcbpt_tpu/ops/ray_walk.py. The wrappers `walk_closest` /
`walk_any` keep the JAX contract: optional coherence sort (stable argsort of
ray_sort_key_live, results scattered back), padding with dead lanes
(tmax < tmin), and the miss convention t=1e30, tri=-1, u=v=0.

The walk itself runs where its tensors live:
  * CUDA tensors launch the hand-written kernels of csrc/ray_walk.cu
    (K1 closest / K2 any, kernels/ray_walk.py), or raise. The kernels take
    the cluster boxes and compute each row's entries themselves: on this
    route no (N, C) tensor is made and `row_entries` is not called;
  * CPU tensors run the plain version below: the row-union entry table
    `row_entries` in plain torch, then a lock-step torch transcription of
    the Pallas kernels (`_next_cluster`, `_mt_rows3` and the loop bodies of
    ray_walk.py:98-227) that reproduces their triangle ids. At equal t the
    closest walk keeps the triangle earlier in the scene file
    (`ClusterSet.tri_file`), as a brute force over the file does, where
    the Pallas kernels keep the earlier visited cluster's. The card checks
    the kernels against it (`walk_closest_plain` / `walk_any_plain` run it
    on any device).
A large scene's parts (ops/clusters.ClusterParts) are walked by
`walk_closest_parts` / `walk_any_parts`, as JAX's functions of those
names: one sort over the boxes of all parts and one padding, then the parts
in turn, each a K1/K2 launch on the card (`*_parts_plain` take the plain
rows).
"""
from __future__ import annotations

import torch

from ..kernels import ray_walk as kernels
from ..utils import profiling
from .clusters import SLOTS, ClusterParts, ClusterSet, log_visits
from .intersect import Hit
from .tile_trace import _as_lanes, _hit, _pad_rays, sort_rays_live, unsort

_BIG = 1e30
_EPS_DET = 1e-10
_NO_KEY = 2**31 - 1   # the file id of no triangle
# closest hit: a row also visits clusters entered this share of its stop
# bound past it (csrc/ray_walk.cu kStopSlack)
STOP_SLACK = 2.0 ** -16
ROW = 8           # rays per row
LANES = 128       # padding unit: 16 rows, two CUDA blocks of K1/K2
# calls of the plain route's passes; the kernels' route must make none
PLAIN_CALLS = {"row_entries": 0}


def row_entries(cmin, cmax, origins, dirs, tmin, tmax):
    """EXACT per-ray slab entries vs all C cluster AABBs, reduced to 8-ray
    row unions. origins (N, 3) with N a multiple of ROW. Returns (N/ROW, C):
    min over the row's rays of the exact entry distance, 1e30 where no ray
    overlaps the cluster. Builds an (N, C) intermediate. The plain route's
    pass: the kernels compute the same values per row, in shared memory."""
    PLAIN_CALLS["row_entries"] += 1
    ax_lo = None
    ax_hi = None
    for a in range(3):
        da = dirs[:, a:a + 1]
        inv = 1.0 / torch.where(torch.abs(da) < 1e-12,
                                torch.where(da < 0, -1e-12, 1e-12), da)
        lo = (cmin[None, :, a] - origins[:, a:a + 1]) * inv
        hi = (cmax[None, :, a] - origins[:, a:a + 1]) * inv
        t0 = torch.minimum(lo, hi)
        t1 = torch.maximum(lo, hi)
        ax_lo = t0 if ax_lo is None else torch.maximum(ax_lo, t0)
        ax_hi = t1 if ax_hi is None else torch.minimum(ax_hi, t1)
    ov = (ax_lo <= ax_hi) & (ax_hi >= tmin[:, None]) \
        & (ax_lo <= tmax[:, None])
    entry = torch.where(ov, ax_lo, _BIG)                 # (N, C)
    c = cmin.shape[0]
    return torch.amin(entry.reshape(-1, ROW, c), dim=1)  # (N/ROW, C)


# ---------------------------------------------------------------------------
# plain version of K1/K2 (lock-step over all rows)
# ---------------------------------------------------------------------------

def _next_cluster(entries, last_e, last_c):
    """(R, C) entries + (R,) last (entry, id) -> lexicographic next
    (entry, id), both (R,)."""
    c = entries.shape[1]
    ids = torch.arange(c, device=entries.device)[None, :]
    le, lc = last_e[:, None], last_c[:, None]
    cand = (entries > le) | ((entries == le) & (ids > lc))
    e = torch.where(cand, entries, _BIG)
    e_min = torch.amin(e, dim=1)
    at_min = (e == e_min[:, None]) & cand
    c_min = torch.amin(torch.where(at_min, ids, c), dim=1)
    return e_min, c_min


def _mt_rows3(o, d, tris, tmn, tmax_eff, cull):
    """Moller-Trumbore: o/d (R, ROW, 3), tris (R, 128, 12) the slot-major
    [p0, 0, e1, 0, e2, 0] block of each row's cluster, tmn/tmax_eff
    (R, ROW). Returns (tt, u, v) of shape (R, ROW, 128); tt = 1e30 on miss."""
    ray = lambda x: x[:, :, None]                  # (R, ROW, 1)
    tri = lambda k: tris[:, None, :, k]            # (R, 1, 128)
    ox, oy, oz = ray(o[:, :, 0]), ray(o[:, :, 1]), ray(o[:, :, 2])
    dx, dy, dz = ray(d[:, :, 0]), ray(d[:, :, 1]), ray(d[:, :, 2])
    p0x, p0y, p0z = tri(0), tri(1), tri(2)
    e1x, e1y, e1z = tri(4), tri(5), tri(6)
    e2x, e2y, e2z = tri(8), tri(9), tri(10)

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = det > _EPS_DET if cull else torch.abs(det) > _EPS_DET
    inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > tmn[:, :, None]) & (t < tmax_eff[:, :, None])
    return torch.where(hit, t, _BIG), u, v


def _stop_bound(lim):
    """(R, ROW) min(best t, tmax) of each lane -> (R,) the largest cluster
    entry the row still visits: the largest of them, widened by STOP_SLACK
    of itself, since a box's rounded entry may lie an ulp or two past the t
    of a triangle in it, which may tie the best hit."""
    b = lim.amax(dim=1)
    return b + b.abs() * STOP_SLACK


def _walk_rows_plain(cs: ClusterSet, o, d, tmn, tmx, row_e, cull, any_hit):
    """The row walk of K1 (any_hit=False) or K2 (any_hit=True) over padded
    (N,) rays. Rows run in lock step; a row that stops never restarts (its
    state no longer changes), so only the running rows are carried."""
    dev = o.device
    r_total = o.shape[0] // ROW
    o3, d3 = o.reshape(r_total, ROW, 3), d.reshape(r_total, ROW, 3)
    tmn2, tmx2 = tmn.reshape(r_total, ROW), tmx.reshape(r_total, ROW)
    best_t = torch.full((r_total, ROW), _BIG, device=dev)
    best_id = torch.full((r_total, ROW), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((r_total, ROW), device=dev)
    best_v = torch.zeros((r_total, ROW), device=dev)
    best_key = torch.full((r_total, ROW), _NO_KEY, dtype=torch.int32,
                          device=dev)
    occ = torch.zeros((r_total, ROW), dtype=torch.bool, device=dev)
    last_e = torch.full((r_total,), -_BIG, device=dev)
    last_c = torch.full((r_total,), -1, dtype=torch.int64, device=dev)
    slot = torch.arange(SLOTS, device=dev)
    rows = torch.arange(r_total, device=dev)
    while rows.numel():
        e, cid = _next_cluster(row_e[rows], last_e[rows], last_c[rows])
        if any_hit:
            tmax_eff = tmx2[rows]
            bound = torch.where(occ[rows], -_BIG, tmax_eff).amax(dim=1)
        else:
            bound = _stop_bound(torch.minimum(best_t[rows], tmx2[rows]))
            tmax_eff = torch.clamp(tmx2[rows], max=_BIG)
        run = (e < _BIG) & (e <= bound)
        rows, e, cid, tmax_eff = rows[run], e[run], cid[run], tmax_eff[run]
        if not rows.numel():
            break
        log_visits(ROW, cid)
        tt, u, v = _mt_rows3(o3[rows], d3[rows], cs.tri_slots[cid],
                             tmn2[rows], tmax_eff, cull and not any_hit)
        if any_hit:
            occ[rows] = occ[rows] | (tt < _BIG).any(dim=2)
        else:
            # the cluster's least (t, file id), kept where it lies below
            # the best so far
            t_min = torch.amin(tt, dim=2)                     # (R, ROW)
            at_min = tt == t_min[:, :, None]
            key = cs.tri_slots[cid][:, :, 3].view(torch.int32)  # (R, 128)
            k_min = torch.amin(torch.where(at_min, key[:, None], _NO_KEY),
                               dim=2)
            pick = at_min & (key[:, None] == k_min[:, :, None])
            s_pick = torch.amin(torch.where(pick, slot, SLOTS), dim=2)
            u_p = torch.where(pick, u, 0.0).sum(dim=2)
            v_p = torch.where(pick, v, 0.0).sum(dim=2)
            tri = (cs.tri_begin[cid][:, None] + s_pick).to(torch.int32)
            bt, bk = best_t[rows], best_key[rows]
            improved = (t_min < bt) | ((t_min == bt) & (t_min < _BIG)
                                       & (k_min < bk))
            best_id[rows] = torch.where(improved, tri, best_id[rows])
            best_u[rows] = torch.where(improved, u_p, best_u[rows])
            best_v[rows] = torch.where(improved, v_p, best_v[rows])
            best_t[rows] = torch.where(improved, t_min, bt)
            best_key[rows] = torch.where(improved, k_min, bk)
        last_e[rows] = e
        last_c[rows] = cid
    if any_hit:
        return occ.reshape(-1).to(torch.int32)
    return (best_t.reshape(-1), best_id.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))


def closest_rows_plain(cs, o, d, tmn, tmx, cull):
    """Plain version of K1 on prepared rays (the entry table, then the
    walk) -> (t, tri, u, v)."""
    row_e = row_entries(cs.cmin, cs.cmax, o, d, tmn, tmx)
    return _walk_rows_plain(cs, o, d, tmn, tmx, row_e, cull, any_hit=False)


def any_rows_plain(cs, o, d, tmn, tmx):
    """Plain version of K2 on prepared rays -> int32 occlusion flags."""
    row_e = row_entries(cs.cmin, cs.cmax, o, d, tmn, tmx)
    return _walk_rows_plain(cs, o, d, tmn, tmx, row_e, False, any_hit=True)


def _closest_rows(cs, o, d, tmn, tmx, cull):
    """K1 for CUDA tensors, its plain version for CPU tensors."""
    if o.device.type == "cpu":
        return closest_rows_plain(cs, o, d, tmn, tmx, cull)
    return kernels.closest(o, d, tmn, tmx, cs.cmin, cs.cmax, cs.tri_begin,
                           cs.tri_count, cs.tri_slots, cull)


def _any_rows(cs, o, d, tmn, tmx):
    """K2 for CUDA tensors, its plain version for CPU tensors."""
    if o.device.type == "cpu":
        return any_rows_plain(cs, o, d, tmn, tmx)
    return kernels.any_hit(o, d, tmn, tmx, cs.cmin, cs.cmax, cs.tri_count,
                           cs.tri_slots)


def closest_parts_rows(parts: ClusterParts, o, d, tmn, tmx, cull,
                       rows_fn=_closest_rows):
    """Closest hits over the parts in turn on prepared rays: each part's
    walk takes tmax tightened to one ulp past the best t so far, and a
    later part wins with a smaller t or, at equal t, a lower file id: the
    whole set's hits -> (t, tri, u, v)."""
    best = None
    for cs in parts.parts:
        cur = tmx if best is None else torch.where(
            best[0] < tmx, torch.nextafter(best[0], tmx), tmx)
        out = rows_fn(cs, o, d, tmn, cur, cull)
        if best is None:
            best = out
        else:
            key = lambda tri: cs.tri_file[tri.clamp(min=0)]
            better = (out[0] < best[0]) | (
                (out[0] == best[0]) & (out[0] < _BIG)
                & (key(out[1]) < key(best[1])))
            best = tuple(torch.where(better, a, b) for a, b in zip(out, best))
    return best


def any_parts_rows(parts: ClusterParts, o, d, tmn, tmx, rows_fn=_any_rows):
    """Occlusion over the parts in turn on prepared rays: rays already
    occluded walk no later part (tmax -1) -> int32 flags. The parts may
    also be tile sets, with K5 any (ops/pallas_tile) as rows_fn."""
    occ = None
    for cs in parts.parts:
        cur = tmx if occ is None else torch.where(occ > 0, -1.0, tmx)
        flags = rows_fn(cs, o, d, tmn, cur)
        occ = flags if occ is None else occ | flags
    return occ


def _closest_parts_plain(parts, o, d, tmn, tmx, cull):
    return closest_parts_rows(parts, o, d, tmn, tmx, cull, closest_rows_plain)


def _any_parts_plain(parts, o, d, tmn, tmx):
    return any_parts_rows(parts, o, d, tmn, tmx, any_rows_plain)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def prepare(cs, origins, dirs, tmin, tmax, sort_rays):
    """Sort (optional; by the boxes of `cs`, a set or all of a set's
    parts; the recorder's span `walk.sort`) and pad: the rays of the row
    walk as the wrappers give them to either route. Returns the padded
    contiguous (origins, dirs, tmin, tmax), the original count and the sort
    permutation (None without sort)."""
    n = origins.shape[0]
    tmin = _as_lanes(tmin, n, origins.device)
    tmax = _as_lanes(tmax, n, origins.device)
    perm = None
    if sort_rays:
        with profiling.span("walk.sort"):
            perm, origins, dirs, tmin, tmax = sort_rays_live(
                cs, origins, dirs, tmin, tmax)
    origins, dirs, tmin, tmax, n_orig = _pad_rays(origins, dirs, tmin, tmax,
                                                  LANES)
    return origins, dirs, tmin, tmax, n_orig, perm


def _closest(cs, origins, dirs, tmin, tmax, cull_backface, sort_rays, rows_fn):
    o, d, tmn, tmx, n, perm = prepare(cs, origins, dirs, tmin, tmax,
                                       sort_rays)
    out = [a[:n] for a in rows_fn(cs, o, d, tmn, tmx, cull_backface)]
    if perm is not None:
        out = [unsort(a, perm) for a in out]
    return _hit(*out)


def _any(cs, origins, dirs, tmin, tmax, sort_rays, rows_fn):
    o, d, tmn, tmx, n, perm = prepare(cs, origins, dirs, tmin, tmax,
                                       sort_rays)
    occ = rows_fn(cs, o, d, tmn, tmx)[:n] > 0
    return unsort(occ, perm) if perm is not None else occ


def walk_closest(cs: ClusterSet, origins, dirs, tmin, tmax,
                 cull_backface: bool = True, sort_rays: bool = False) -> Hit:
    """Closest-hit traversal: K1 on the card, its plain version on CPU."""
    return _closest(cs, origins, dirs, tmin, tmax, cull_backface, sort_rays,
                    _closest_rows)


def walk_any(cs: ClusterSet, origins, dirs, tmin, tmax,
             sort_rays: bool = False):
    """Any-hit (occlusion) traversal, no back-face culling (reference
    cuProg.h:478): K2 on the card, its plain version on CPU."""
    return _any(cs, origins, dirs, tmin, tmax, sort_rays, _any_rows)


def walk_closest_plain(cs: ClusterSet, origins, dirs, tmin, tmax,
                       cull_backface: bool = True,
                       sort_rays: bool = False) -> Hit:
    """walk_closest through the plain version on any device (the kernels'
    reference on the card)."""
    return _closest(cs, origins, dirs, tmin, tmax, cull_backface, sort_rays,
                    closest_rows_plain)


def walk_any_plain(cs: ClusterSet, origins, dirs, tmin, tmax,
                   sort_rays: bool = False):
    """walk_any through the plain version on any device."""
    return _any(cs, origins, dirs, tmin, tmax, sort_rays, any_rows_plain)


def walk_closest_parts(parts: ClusterParts, origins, dirs, tmin, tmax,
                       cull_backface: bool = True,
                       sort_rays: bool = False) -> Hit:
    """Closest-hit traversal over a large scene's parts: K1 once per part
    on the card, its plain version on CPU."""
    return _closest(parts, origins, dirs, tmin, tmax, cull_backface,
                    sort_rays, closest_parts_rows)


def walk_any_parts(parts: ClusterParts, origins, dirs, tmin, tmax,
                   sort_rays: bool = False):
    """Any-hit traversal over a large scene's parts: K2 once per part on
    the card, its plain version on CPU."""
    return _any(parts, origins, dirs, tmin, tmax, sort_rays, any_parts_rows)


def walk_closest_parts_plain(parts: ClusterParts, origins, dirs, tmin, tmax,
                             cull_backface: bool = True,
                             sort_rays: bool = False) -> Hit:
    """walk_closest_parts through the plain version on any device."""
    return _closest(parts, origins, dirs, tmin, tmax, cull_backface,
                    sort_rays, _closest_parts_plain)


def walk_any_parts_plain(parts: ClusterParts, origins, dirs, tmin, tmax,
                         sort_rays: bool = False):
    """walk_any_parts through the plain version on any device."""
    return _any(parts, origins, dirs, tmin, tmax, sort_rays,
                _any_parts_plain)

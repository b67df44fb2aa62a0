"""The tile walk's direct Moller-Trumbore forms: the per-round kernel K4 and
the fused walk K5.

Port of spcbpt_tpu/ops/pallas_tile.py:
  * `mt_round` (JAX `mt_round`, `_round_kernel`): one round of the
    host-driven tile walk of ops/tile_trace.tile_closest(use_kernel=True):
    each running tile's lanes against its cluster's (16, 128) triangle
    block, the minimum t with the smallest slot that attains it. The port's
    round stages the slots below the triangle count of cluster cid[tile]
    and reports a miss for tiles that do not run.
  * `pallas_closest` / `pallas_any` (JAX `_closest_kernel` /
    `_any_kernel`): the whole walk in one kernel, 128-ray tiles, entry
    bounds computed per tile (tile_trace.tile_entries semantics), the
    (entry, id)-lexicographic next cluster each round. Same contract as
    tile_trace.tile_closest / tile_any. Rays are padded to 1,024 lanes (8
    tiles) as in JAX.

Each runs where its tensors live: CUDA tensors launch the hand-written
kernels of csrc/tile_walk.cu (kernels/tile_walk.py), or raise; CPU tensors
run the plain versions below, torch transcriptions of `_mt_vpu`,
`_block_entries`, `_next_cluster` and the loop bodies of the Pallas
kernels. The card checks each kernel against its plain version
(`mt_round_blocks_plain`, `pallas_closest_plain`, `pallas_any_plain` run
them on any device).
"""
from __future__ import annotations

import torch

from ..kernels import tile_walk as kernels
from .clusters import SLOTS, TileClusterSet, log_visits
from .intersect import Hit
from .ray_walk import _next_cluster
from .tile_trace import (_as_lanes, _hit, _pad_rays, sort_rays_live,
                         tile_entries, unsort)

_BIG = 1e30
_EPS_DET = 1e-10
TILE = 128            # rays per tile of the fused walk
TILES_PER_BLOCK = 8   # JAX's tiles per program: the padding unit


def _mt_vpu(o, d, tris, tmn, tmx, cull):
    """Direct Moller-Trumbore: o/d (TB, R, 3), tris (TB, 16, 128) with
    [p0, e1, e2] in rows 0..8 (zero slots never hit), tmn/tmx (TB, R).
    Returns (tt, u, v) of shape (TB, R, 128); tt = t where hit else 1e30."""
    ray = lambda x: x[..., None]           # (TB, R, 1)
    tri = lambda x: x[:, None, :]          # (TB, 1, K)
    ox, oy, oz = ray(o[..., 0]), ray(o[..., 1]), ray(o[..., 2])
    dx, dy, dz = ray(d[..., 0]), ray(d[..., 1]), ray(d[..., 2])
    p0x, p0y, p0z = tri(tris[:, 0]), tri(tris[:, 1]), tri(tris[:, 2])
    e1x, e1y, e1z = tri(tris[:, 3]), tri(tris[:, 4]), tri(tris[:, 5])
    e2x, e2y, e2z = tri(tris[:, 6]), tri(tris[:, 7]), tri(tris[:, 8])

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
        & (t > tmn[..., None]) & (t < tmx[..., None])
    return torch.where(hit, t, _BIG), u, v


def _pick(tt, u, v, miss_slot):
    """Minimum t over slots, the smallest slot attaining it (`miss_slot`
    where nothing hits) and that slot's u, v."""
    slot = torch.arange(tt.shape[-1], dtype=torch.int32, device=tt.device)
    t_min = torch.amin(tt, dim=-1)
    at_min = (tt == t_min[..., None]) & (tt < _BIG)
    s_pick = torch.amin(torch.where(at_min, slot, miss_slot), dim=-1)
    pick = at_min & (slot == s_pick[..., None])
    return (t_min, torch.where(pick, u, 0.0).sum(dim=-1),
            torch.where(pick, v, 0.0).sum(dim=-1), s_pick)


# ---------------------------------------------------------------------------
# K4: one round of the host-driven walk
# ---------------------------------------------------------------------------

def mt_round_plain(origins, dirs, tris, tmn, tmax_eff, cull_backface: bool):
    """JAX's mt_round on gathered blocks: origins/dirs (NT, R, 3), tris
    (NT, 16, 128), tmn/tmax_eff (NT, R). Returns per-lane (t_min, u, v,
    ones, slot), t_min = 1e30 and slot = 128 on a miss."""
    tt, u, v = _mt_vpu(origins, dirs, tris, tmn, tmax_eff, cull_backface)
    t_min, u_p, v_p, s_pick = _pick(tt, u, v, tris.shape[2])
    return t_min, u_p, v_p, torch.ones_like(t_min), s_pick


def mt_round_blocks_plain(origins, dirs, tri_block, tri_count, cid, run,
                          tmn, tmax_eff, tri_k: int, cull_backface: bool):
    """Plain version of K4 on any device: the round of tile i against
    tri_block[cid[i]] where run[i], a miss (t 1e30, u = v = 0, slot 128)
    where not. tri_count and tri_k are the kernel's slot bounds and unused
    here (slots past them are zero and never hit, so the plain version tests
    all 128): the function takes mt_round's arguments so that it can stand
    in for it as tile_trace._round_walk's round_fn."""
    log_visits(origins.shape[1], cid[run])
    tris = tri_block[torch.where(run, cid, 0).long()]
    t_min, u, v, dn, s_pick = mt_round_plain(origins, dirs, tris, tmn,
                                             tmax_eff, cull_backface)
    r = run[:, None]
    return (torch.where(r, t_min, _BIG), torch.where(r, u, 0.0),
            torch.where(r, v, 0.0), dn, torch.where(r, s_pick, SLOTS))


def mt_round(origins, dirs, tri_block, tri_count, cid, run, tmn, tmax_eff,
             tri_k: int, cull_backface: bool):
    """One round of the tile walk: K4 on CUDA tensors, its plain version on
    CPU tensors. cid (NT,) int32 cluster per tile, run (NT,) bool; tri_count
    (C,) int32, each cluster's triangles."""
    if origins.device.type == "cpu":
        return mt_round_blocks_plain(origins, dirs, tri_block, tri_count, cid,
                                     run, tmn, tmax_eff, tri_k, cull_backface)
    return kernels.tile_round(origins, dirs, tmn, tmax_eff, cid, run,
                              tri_block, tri_count, tri_k, cull_backface)


# ---------------------------------------------------------------------------
# K5: the fused walk (plain version: lock-step over all tiles)
# ---------------------------------------------------------------------------

def _walk_tiles_plain(cs: TileClusterSet, o, d, tmn, tmx, cull, any_hit):
    """The walk of K5 closest (any_hit=False) or any (any_hit=True) over
    padded (N,) rays in 128-ray tiles. Tiles run in lock step; a tile that
    stops never restarts, so only the running tiles are carried."""
    dev = o.device
    nt = o.shape[0] // TILE
    entries = tile_entries(cs, o, d, tmn, tmx, TILE)          # (NT, C)
    o3, d3 = o.reshape(nt, TILE, 3), d.reshape(nt, TILE, 3)
    tmn2, tmx2 = tmn.reshape(nt, TILE), tmx.reshape(nt, TILE)
    best_t = torch.full((nt, TILE), _BIG, device=dev)
    best_id = torch.full((nt, TILE), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((nt, TILE), device=dev)
    best_v = torch.zeros((nt, TILE), device=dev)
    occ = torch.zeros((nt, TILE), dtype=torch.bool, device=dev)
    last_e = torch.full((nt,), -_BIG, device=dev)
    last_c = torch.full((nt,), -1, dtype=torch.int64, device=dev)
    tiles = torch.arange(nt, device=dev)
    while tiles.numel():
        e, cid = _next_cluster(entries[tiles], last_e[tiles], last_c[tiles])
        if any_hit:
            tmax_eff = tmx2[tiles]
            done = torch.all(occ[tiles] | (tmax_eff < tmn2[tiles]), dim=1)
            run = (e < _BIG) & ~done
        else:
            tmax_eff = torch.minimum(best_t[tiles], tmx2[tiles])
            run = (e < _BIG) & (e <= torch.amax(tmax_eff, dim=1))
        tiles, e, cid, tmax_eff = tiles[run], e[run], cid[run], tmax_eff[run]
        if not tiles.numel():
            break
        log_visits(TILE, cid)
        tt, u, v = _mt_vpu(o3[tiles], d3[tiles], cs.tri_block[cid],
                           tmn2[tiles], tmax_eff, cull and not any_hit)
        if any_hit:
            occ[tiles] = occ[tiles] | (tt < _BIG).any(dim=2)
        else:
            t_min, u_p, v_p, s_pick = _pick(tt, u, v, SLOTS)
            bt = best_t[tiles]
            improved = t_min < bt
            tri = (cs.tri_begin[cid][:, None] + s_pick).to(torch.int32)
            best_id[tiles] = torch.where(improved, tri, best_id[tiles])
            best_u[tiles] = torch.where(improved, u_p, best_u[tiles])
            best_v[tiles] = torch.where(improved, v_p, best_v[tiles])
            best_t[tiles] = torch.where(improved, t_min, bt)
        last_e[tiles] = e
        last_c[tiles] = cid
    if any_hit:
        return occ.reshape(-1).to(torch.int32)
    return (best_t.reshape(-1), best_id.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))


def closest_tiles_plain(cs, o, d, tmn, tmx, cull):
    """Plain version of K5 closest on padded rays -> (t, tri, u, v)."""
    return _walk_tiles_plain(cs, o, d, tmn, tmx, cull, any_hit=False)


def any_tiles_plain(cs, o, d, tmn, tmx):
    """Plain version of K5 any on padded rays -> int32 occlusion flags."""
    return _walk_tiles_plain(cs, o, d, tmn, tmx, False, any_hit=True)


def _closest_tiles(cs, o, d, tmn, tmx, cull):
    """K5 closest for CUDA tensors, its plain version for CPU tensors."""
    if o.device.type == "cpu":
        return closest_tiles_plain(cs, o, d, tmn, tmx, cull)
    return kernels.walk_closest(o, d, tmn, tmx, cs.cmin, cs.cmax,
                                cs.tri_begin, cs.tri_block, cs.tri_count,
                                cull)


def _any_tiles(cs, o, d, tmn, tmx):
    """K5 any for CUDA tensors, its plain version for CPU tensors."""
    if o.device.type == "cpu":
        return any_tiles_plain(cs, o, d, tmn, tmx)
    return kernels.walk_any(o, d, tmn, tmx, cs.cmin, cs.cmax, cs.tri_block,
                            cs.tri_count, cs.tri_k)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def prepare(cs, origins, dirs, tmin, tmax, sort_rays):
    """Sort (optional) and pad to 1,024 lanes: the fused walk's inputs as
    the wrappers give them to it. Returns the padded contiguous (origins,
    dirs, tmin, tmax), the original count and the sort permutation (None
    without sort)."""
    n = origins.shape[0]
    tmin = _as_lanes(tmin, n, origins.device)
    tmax = _as_lanes(tmax, n, origins.device)
    perm = None
    if sort_rays:
        perm, origins, dirs, tmin, tmax = sort_rays_live(cs, origins, dirs,
                                                         tmin, tmax)
    o, d, tmn, tmx, n = _pad_rays(origins, dirs, tmin, tmax,
                                  TILES_PER_BLOCK * TILE)
    return o, d, tmn, tmx, n, perm


def _closest(cs, origins, dirs, tmin, tmax, cull_backface, sort_rays, fn):
    o, d, tmn, tmx, n, perm = prepare(cs, origins, dirs, tmin, tmax,
                                      sort_rays)
    out = [a[:n] for a in fn(cs, o, d, tmn, tmx, cull_backface)]
    if perm is not None:
        out = [unsort(a, perm) for a in out]
    return _hit(*out)


def _any(cs, origins, dirs, tmin, tmax, sort_rays, fn):
    o, d, tmn, tmx, n, perm = prepare(cs, origins, dirs, tmin, tmax,
                                      sort_rays)
    occ = fn(cs, o, d, tmn, tmx)[:n] > 0
    return unsort(occ, perm) if perm is not None else occ


def pallas_closest(cs: TileClusterSet, origins, dirs, tmin, tmax,
                   cull_backface: bool = True,
                   sort_rays: bool = False) -> Hit:
    """Closest-hit traversal through the fused walk: K5 on the card, its
    plain version on the CPU. Same contract as tile_trace.tile_closest."""
    return _closest(cs, origins, dirs, tmin, tmax, cull_backface, sort_rays,
                    _closest_tiles)


def pallas_any(cs: TileClusterSet, origins, dirs, tmin, tmax,
               sort_rays: bool = False):
    """Any-hit (occlusion, never culled) traversal through the fused walk:
    K5 on the card, its plain version on the CPU. Returns bool."""
    return _any(cs, origins, dirs, tmin, tmax, sort_rays, _any_tiles)


def pallas_closest_plain(cs: TileClusterSet, origins, dirs, tmin, tmax,
                         cull_backface: bool = True,
                         sort_rays: bool = False) -> Hit:
    """pallas_closest through the plain version on any device."""
    return _closest(cs, origins, dirs, tmin, tmax, cull_backface, sort_rays,
                    closest_tiles_plain)


def pallas_any_plain(cs: TileClusterSet, origins, dirs, tmin, tmax,
                     sort_rays: bool = False):
    """pallas_any through the plain version on any device."""
    return _any(cs, origins, dirs, tmin, tmax, sort_rays, any_tiles_plain)

"""The list walk (whole-walk traversal v2): one ray tile per program over a
presorted near-to-far cluster list, kernel K6.

Port of spcbpt_tpu/ops/pallas_walk.py:
  1. `_prepare` pads the rays to a multiple of the tile with dead lanes
     (tmax = -1), computes each tile's conservative entry bound of every
     cluster (tile_trace.tile_entries, which reads only cmin/cmax, so either
     cluster set works), sorts each tile's (entry, id) pairs stably
     (near to far, equal entries in id order), counts the entries below
     1e30 and gathers bases = tri_begin[ids].
  2. The walk: each tile takes the clusters of its list in order and tests
     all 128 slots of the cluster's (16, 128) block per lane (direct
     Moller-Trumbore, `_mt_rows` order). Closest hit: a lane improves only
     on a strictly smaller t, the smallest slot among equal t; the tile stops
     when its next entry exceeds the largest min(best_t, tmax) of its lanes
     (`prune`, always on in the streamed form). Any hit (never culled): the
     tile stops when its next entry exceeds the largest tmax of its
     unoccluded lanes. Padded and dead lanes never extend a walk.

The walk runs where its tensors live: CUDA tensors launch the hand-written
kernels of csrc/list_walk.cu (kernels/list_walk.py: the resident forms read
the blocks from global memory, the streamed forms stage them through
shared-memory buffers, as JAX's VMEM-resident and DMA-streamed kernels
differ; every form walks each tile's list in groups of rays, a warp each,
each group stopping on its own bound, with the same results), or
raise; CPU tensors run the plain versions below, which advance all tiles in
lock step. The card checks each kernel against them (`walk_closest_plain` /
`walk_any_plain` run them on any device).

No render path walks this way, in JAX or here: the list walk's caller is
the traversal profiler (apps/prof_traversal.py, JAX tools/prof_traversal.py).
"""
from __future__ import annotations

import torch

from ..kernels import list_walk as kernels
from .clusters import SLOTS, log_visits
from .intersect import Hit
from .pallas_tile import _mt_vpu, _pick
from .tile_trace import (_as_lanes, _hit, _pad_rays, sort_rays_live,
                         tile_entries, unsort)

_BIG = 1e30


def _prepare(cs, origins, dirs, tmin, tmax, tile: int):
    """Pad the rays and build the per-tile walk lists. Returns the padded
    contiguous (origins, dirs, tmin, tmax), the original count, and the
    (NT, C) lists: entries (float32, sorted), ids and bases (int32), with
    the (NT,) int32 counts of entries below 1e30."""
    origins, dirs, tmin, tmax, n_orig = _pad_rays(origins, dirs, tmin, tmax,
                                                  tile)
    entries = tile_entries(cs, origins, dirs, tmin, tmax, tile)
    entries_s, ids_s = torch.sort(entries, dim=1, stable=True)
    counts = torch.sum(entries_s < _BIG, dim=1).to(torch.int32)
    bases = cs.tri_begin[ids_s]
    return (origins, dirs, tmin, tmax, n_orig, entries_s.contiguous(),
            ids_s.to(torch.int32).contiguous(), bases.contiguous(), counts)


# ---------------------------------------------------------------------------
# plain versions of K6 (lock step over all tiles)
# ---------------------------------------------------------------------------

def _walk_plain(blocks, counts, ids, bases, entries, o, d, tmn, tmx, cull,
                prune, any_hit):
    """The walk of every tile over its list; a tile that stops never
    restarts, so only the running tiles are carried."""
    dev = o.device
    nt, c = entries.shape
    tile = o.shape[0] // nt
    o3, d3 = o.reshape(nt, tile, 3), d.reshape(nt, tile, 3)
    tmn2, tmx2 = tmn.reshape(nt, tile), tmx.reshape(nt, tile)
    best_t = torch.full((nt, tile), _BIG, device=dev)
    best_id = torch.full((nt, tile), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((nt, tile), device=dev)
    best_v = torch.zeros((nt, tile), device=dev)
    occ = torch.zeros((nt, tile), dtype=torch.bool, device=dev)
    tiles = torch.nonzero(counts > 0)[:, 0]
    r = 0
    while tiles.numel():
        cid = ids[tiles, r].long()
        log_visits(tile, cid)
        if any_hit:
            tt, _, _ = _mt_vpu(o3[tiles], d3[tiles], blocks[cid], tmn2[tiles],
                               tmx2[tiles], False)
            occ[tiles] = occ[tiles] | (tt < _BIG).any(dim=2)
            bound = torch.where(occ[tiles], -_BIG, tmx2[tiles]).amax(dim=1)
        else:
            bt = best_t[tiles]
            tmax_eff = torch.minimum(bt, tmx2[tiles])
            tt, u, v = _mt_vpu(o3[tiles], d3[tiles], blocks[cid], tmn2[tiles],
                               tmax_eff, cull)
            t_min, u_p, v_p, s_pick = _pick(tt, u, v, SLOTS)
            improved = t_min < bt
            tri = bases[tiles, r][:, None] + s_pick
            best_id[tiles] = torch.where(improved, tri, best_id[tiles])
            best_u[tiles] = torch.where(improved, u_p, best_u[tiles])
            best_v[tiles] = torch.where(improved, v_p, best_v[tiles])
            best_t[tiles] = torch.where(improved, t_min, bt)
            bound = torch.minimum(best_t[tiles], tmx2[tiles]).amax(dim=1)
        r += 1
        more = r < counts[tiles]
        if prune:
            more = more & (entries[tiles, min(r, c - 1)] <= bound)
        tiles = tiles[more]
    if any_hit:
        return occ.reshape(-1).to(torch.int32)
    return (best_t.reshape(-1), best_id.reshape(-1), best_u.reshape(-1),
            best_v.reshape(-1))


def list_walk_closest_plain(blocks, counts, ids, bases, entries, o, d, tmn,
                            tmx, cull: bool, prune: bool = True):
    """Plain version of K6 closest on prepared rays -> (t, tri, u, v)."""
    return _walk_plain(blocks, counts, ids, bases, entries, o, d, tmn, tmx,
                       cull, prune, any_hit=False)


def list_walk_any_plain(blocks, counts, ids, entries, o, d, tmn, tmx):
    """Plain version of K6 any on prepared rays -> int32 occlusion flags."""
    return _walk_plain(blocks, counts, ids, None, entries, o, d, tmn, tmx,
                       False, True, any_hit=True)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def prepare(cs, origins, dirs, tmin, tmax, tile: int, sort_rays: bool):
    """Sort (optional) and `_prepare`: the walk's inputs as the wrappers give
    them to it, plus the sort permutation (None without sort)."""
    n = origins.shape[0]
    tmin = _as_lanes(tmin, n, origins.device)
    tmax = _as_lanes(tmax, n, origins.device)
    perm = None
    if sort_rays:
        perm, origins, dirs, tmin, tmax = sort_rays_live(cs, origins, dirs,
                                                         tmin, tmax)
    return _prepare(cs, origins, dirs, tmin, tmax, tile) + (perm,)


def _closest_lists(cs, prep, cull, prune, vmem_resident, plain):
    o, d, tmn, tmx, _, entries, ids, bases, counts = prep
    if plain or o.device.type == "cpu":
        return list_walk_closest_plain(cs.blocks(), counts, ids, bases,
                                       entries, o, d, tmn, tmx, cull, prune)
    return kernels.closest(cs.blocks(), cs.tri_count, counts, ids, bases,
                           entries, o, d, tmn, tmx, cull, prune,
                           stream=not vmem_resident)


def _any_lists(cs, prep, vmem_resident, plain):
    o, d, tmn, tmx, _, entries, ids, _, counts = prep
    if plain or o.device.type == "cpu":
        return list_walk_any_plain(cs.blocks(), counts, ids, entries, o, d,
                                   tmn, tmx)
    return kernels.any_hit(cs.blocks(), cs.tri_count, counts, ids, entries, o,
                           d, tmn, tmx, stream=not vmem_resident)


def _closest(cs, origins, dirs, tmin, tmax, cull_backface, tile, sort_rays,
             vmem_resident, prune, plain) -> Hit:
    if not (prune or vmem_resident):
        raise ValueError("prune=False needs vmem_resident=True: the "
                         "streamed closest walk always prunes")
    *prep, perm = prepare(cs, origins, dirs, tmin, tmax, tile, sort_rays)
    n = prep[4]
    out = [a[:n] for a in _closest_lists(cs, prep, cull_backface, prune,
                                         vmem_resident, plain)]
    if perm is not None:
        out = [unsort(a, perm) for a in out]
    return _hit(*out)


def _any(cs, origins, dirs, tmin, tmax, tile, sort_rays, vmem_resident,
         plain):
    *prep, perm = prepare(cs, origins, dirs, tmin, tmax, tile, sort_rays)
    occ = _any_lists(cs, prep, vmem_resident, plain)[:prep[4]] > 0
    return unsort(occ, perm) if perm is not None else occ


def walk_closest(cs, origins, dirs, tmin, tmax, cull_backface: bool = True,
                 tile: int = 256, sort_rays: bool = False,
                 vmem_resident: bool = True, prune: bool = True) -> Hit:
    """Closest-hit traversal over either cluster set (same contract as
    tile_trace.tile_closest): K6 on the card, its plain version on CPU
    tensors. prune=False walks every tile's whole list (resident only)."""
    return _closest(cs, origins, dirs, tmin, tmax, cull_backface, tile,
                    sort_rays, vmem_resident, prune, plain=False)


def walk_any(cs, origins, dirs, tmin, tmax, tile: int = 256,
             sort_rays: bool = False, vmem_resident: bool = True):
    """Any-hit (occlusion) traversal, no back-face culling (reference
    cuProg.h:478): K6 on the card, its plain version on CPU tensors.
    Returns bool."""
    return _any(cs, origins, dirs, tmin, tmax, tile, sort_rays,
                vmem_resident, plain=False)


def walk_closest_plain(cs, origins, dirs, tmin, tmax,
                       cull_backface: bool = True, tile: int = 256,
                       sort_rays: bool = False, prune: bool = True) -> Hit:
    """walk_closest through the plain version on any device."""
    return _closest(cs, origins, dirs, tmin, tmax, cull_backface, tile,
                    sort_rays, True, prune, plain=True)


def walk_any_plain(cs, origins, dirs, tmin, tmax, tile: int = 256,
                   sort_rays: bool = False):
    """walk_any through the plain version on any device."""
    return _any(cs, origins, dirs, tmin, tmax, tile, sort_rays, True,
                plain=True)

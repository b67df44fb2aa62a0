"""Tiled two-level traversal: per-tile near-to-far cluster walk.

Port of spcbpt_tpu/ops/tile_trace.py, the traversal of the `tile` mode over
the K=32 cluster set (ops/clusters.TileClusterSet):

1. Rays are grouped into tiles of `tile` lanes (256 in the scene's trace
   API), optionally after a coherence sort (`ray_sort_key_live`, stable).
2. `tile_entries`: a conservative interval-arithmetic slab test of each
   tile's origin and direction bounds against every cluster AABB gives a
   lower bound of the tile's entry distance per cluster (1e30 where no lane
   can reach it).
3. `_prepare`: each tile's visit order is its entries sorted stably (equal
   entries in id order); tiles are ordered busiest first and walked in the
   size-graded buckets of `_bucket_sizes`.
4. Rounds: every running tile takes its next cluster and tests its lanes
   against the cluster's K triangles. A tile stops when its next entry
   exceeds the largest min(best_t, tmax) of its lanes (closest) or when it
   has no cluster left (any).

Three formulations of the closest hit's walk:
  * the matmul walk (`use_kernel=False`, `_closest_loop` / `_any_loop`):
    ray features times coefficient blocks, hits tested on the numerators,
    u and v divided by det after the loop. It is the plain version the JAX
    tile mode runs on the CPU, and it runs only on CPU tensors: on the card
    it would go through TF32 tensor cores or cuBLAS, so a CUDA tensor
    raises.
  * the round walk on the host (`use_kernel=True` on CPU tensors, and
    `tile_closest_plain` on any device; `_round_walk`): direct
    Moller-Trumbore per round through ops/pallas_tile (K4's round, plain
    version), the busiest-first buckets of tiles walked in lock step, one
    `alive.any()` host sync per round (WALK_STATS counts rounds and syncs).
  * the round walk on the card (`use_kernel=True` on CUDA tensors): kernel
    K4 (kernels/tile_walk.round_walk) walks every tile to its end in one
    launch. Tiles are independent, so it equals the host form bit for bit;
    it makes no host sync. WALK_STATS counts its walks; each tile's round
    count goes to ROUND_LOG while a caller collects it.

Misses keep t=1e30, tri=-1, u=v=0.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import tile_walk as kernels
from .clusters import TileClusterSet, ray_features
from .intersect import Hit

_BIG = 1e30
_EPS_DET = 1e-10
# bucket divisors of the tile count, busiest tiles first
_BUCKETS = (16, 16, 8, 4, 2)
# round walks (either form), and the host form's buckets, rounds and host
# syncs
WALK_STATS = {"walks": 0, "buckets": 0, "rounds": 0, "syncs": 0}
# The card's round walks, while a caller collects them: a list of (nt,)
# int32 device tensors, each tile's rounds (visits) in one walk, or None.
# Only the collecting caller reads them (a read is a host sync).
ROUND_LOG: Optional[list] = None


def reset_walk_stats() -> None:
    for k in WALK_STATS:
        WALK_STATS[k] = 0


# ---------------------------------------------------------------------------
# wavefront coherence keys
# ---------------------------------------------------------------------------

def _morton3(q, bits: int):
    """Interleave the low `bits` of 3 int32 coords (q: (..., 3))."""
    out = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
    for b in range(bits):
        for a in range(3):
            out = out | (((q[..., a] >> b) & 1) << (3 * b + a))
    return out


def ray_sort_key(cmin, cmax, origins, dirs, bits: int = 5):
    """Wavefront coherence key: direction octant (major) then origin morton
    cell (minor). Sorting secondary-bounce wavefronts by it re-forms coherent
    rows: within a row all directions share sign per axis and origins share
    a morton cell."""
    lo = torch.amin(cmin, dim=0)
    hi = torch.amax(cmax, dim=0)
    scale = (1 << bits) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(((origins - lo) * scale).to(torch.int32), 0,
                    (1 << bits) - 1)
    morton = _morton3(q, bits)
    octant = ((dirs[..., 0] < 0).to(torch.int32)
              | ((dirs[..., 1] < 0).to(torch.int32) << 1)
              | ((dirs[..., 2] < 0).to(torch.int32) << 2))
    return (octant << (3 * bits)) | morton


def ray_sort_key_live(cmin, cmax, origins, dirs, tmin, tmax, bits: int = 5):
    """ray_sort_key with DEAD lanes (tmax < tmin, the masked-lane convention)
    sorted to the end, so that they pack into whole rows the walk kernels
    skip in one round."""
    key = ray_sort_key(cmin, cmax, origins, dirs, bits)
    dead = tmax < tmin
    return key | (dead.to(torch.int32) << 24)


# ---------------------------------------------------------------------------
# shared set-up
# ---------------------------------------------------------------------------

def _as_lanes(x, n, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n)


def sort_rays_live(cs, origins, dirs, tmin, tmax):
    """Stable coherence sort: (perm, origins, dirs, tmin, tmax) permuted."""
    key = ray_sort_key_live(cs.cmin, cs.cmax, origins, dirs, tmin, tmax)
    perm = torch.argsort(key, stable=True)
    return perm, origins[perm], dirs[perm], tmin[perm], tmax[perm]


def unsort(a, perm):
    """Scatter back to the caller's lane order."""
    out = torch.empty_like(a)
    out[perm] = a
    return out


def _pad_rays(origins, dirs, tmin, tmax, tile):
    """Pad to a multiple of `tile` with dead lanes: origin 0, direction
    (1, 0, 0), tmin 0, tmax -1. Returns the contiguous padded arrays and the
    original count."""
    n = origins.shape[0]
    pad = (-n) % tile
    origins, dirs = origins.contiguous(), dirs.contiguous()
    tmin, tmax = tmin.contiguous(), tmax.contiguous()
    if pad:
        origins = torch.cat([origins, origins.new_zeros((pad, 3))])
        x_axis = dirs.new_tensor([1.0, 0.0, 0.0]).expand(pad, 3)
        dirs = torch.cat([dirs, x_axis])
        tmin = torch.cat([tmin, tmin.new_zeros((pad,))])
        # tmax < tmin: padded lanes never hit and never extend the walk
        tmax = torch.cat([tmax, tmax.new_full((pad,), -1.0)])
    return origins, dirs, tmin, tmax, n


def tile_entries(cs: TileClusterSet, origins, dirs, tmin, tmax, tile: int):
    """Conservative per-tile cluster entry bounds, (NT, C): a lower bound on
    every lane's slab entry distance, 1e30 where NO lane can intersect the
    cluster AABB within [tmin, tmax]. Interval arithmetic over the tile's
    origin/direction bounding boxes, so it is safe for any lane grouping."""
    nt = origins.shape[0] // tile
    o = origins.reshape(nt, tile, 3)
    d = dirs.reshape(nt, tile, 3)
    olo = torch.amin(o, dim=1)[:, None, :]     # (NT, 1, 3)
    ohi = torch.amax(o, dim=1)[:, None, :]
    dlo = torch.amin(d, dim=1)[:, None, :]
    dhi = torch.amax(d, dim=1)[:, None, :]
    tmin_lb = torch.amin(tmin.reshape(nt, tile), dim=1)
    tmax_ub = torch.amax(tmax.reshape(nt, tile), dim=1)

    # inverse-direction interval per axis; sign-straddling axes give no
    # constraint (the interval of 1/d is disconnected through +-inf)
    straddle = (dlo <= 0.0) & (dhi >= 0.0)
    safe_lo = torch.where(torch.abs(dlo) < 1e-12,
                          torch.where(dlo < 0, -1e-12, 1e-12), dlo)
    safe_hi = torch.where(torch.abs(dhi) < 1e-12,
                          torch.where(dhi < 0, -1e-12, 1e-12), dhi)
    il = torch.minimum(1.0 / safe_lo, 1.0 / safe_hi)
    ih = torch.maximum(1.0 / safe_lo, 1.0 / safe_hi)

    bmin = cs.cmin[None, :, :]                 # (1, C, 3)
    bmax = cs.cmax[None, :, :]
    # interval endpoints of (b - o) for both slabs
    lo_ab = torch.minimum(bmin - ohi, bmax - ohi)
    hi_ab = torch.maximum(bmin - olo, bmax - olo)
    # conservative hull of t = (b - o) * inv_d over all endpoint products
    p1 = lo_ab * il
    p2 = lo_ab * ih
    p3 = hi_ab * il
    p4 = hi_ab * ih
    ax_lo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
    ax_hi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
    ax_lo = torch.where(straddle, -_BIG, ax_lo)
    ax_hi = torch.where(straddle, _BIG, ax_hi)
    entry_lb = torch.amax(ax_lo, dim=-1)       # (NT, C)
    exit_ub = torch.amin(ax_hi, dim=-1)
    overlap = (entry_lb <= exit_ub) & (exit_ub >= tmin_lb[:, None]) \
        & (entry_lb <= tmax_ub[:, None])
    return torch.where(overlap, entry_lb, _BIG)


def _prepare(cs, origins, dirs, tmin, tmax, tile):
    """Entries, per-tile visit order, busiest-first tile order and the
    permuted per-tile arrays. Returns (entries_s, ids_s, o_t, d_t, tmin_t,
    tmax_t, inv_order, nt); entries_s / ids_s are (NT, C), each tile's
    visit order (ascending entries, 1e30 past its reach)."""
    nt = origins.shape[0] // tile
    entries = tile_entries(cs, origins, dirs, tmin, tmax, tile)
    # stable sort keeps equal-entry clusters in id order (near-to-far walk)
    entries_s, ids_s = torch.sort(entries, dim=1, stable=True)
    count = torch.sum(entries < _BIG, dim=1)
    order = torch.argsort(-count, stable=True)
    inv_order = torch.argsort(order)
    return (entries_s[order], ids_s[order].to(torch.int32),
            origins.reshape(nt, tile, 3)[order],
            dirs.reshape(nt, tile, 3)[order],
            tmin.reshape(nt, tile)[order], tmax.reshape(nt, tile)[order],
            inv_order, nt)


def _bucket_sizes(nt: int):
    """Static split of nt tiles into busiest-first buckets."""
    sizes = []
    left = nt
    for div in _BUCKETS[:-1]:
        s = min(max(nt // div, 1) if left > 0 else 0, left)
        sizes.append(s)
        left -= s
    sizes.append(left)
    return [s for s in sizes if s > 0]


# ---------------------------------------------------------------------------
# the matmul walk (plain version, CPU tensors only)
# ---------------------------------------------------------------------------

def _split_mt(outs, k):
    outs = outs.reshape(outs.shape[0], outs.shape[1], 4, k)
    return outs[:, :, 0], outs[:, :, 1], outs[:, :, 2], outs[:, :, 3]


def _min_by_t(tt, u_num, v_num, det, k):
    """Min over slots of t, ties broken by the smaller slot, carrying that
    slot's payload (the reduce of JAX's `_min_by_t`)."""
    t_min = torch.amin(tt, dim=2)
    slot = torch.arange(k, dtype=torch.int32, device=tt.device)
    s_pick = torch.amin(torch.where(tt == t_min[..., None], slot, k), dim=2)
    idx = s_pick.long()[..., None]
    pick = lambda a: torch.gather(a, 2, idx)[..., 0]
    return t_min, pick(u_num), pick(v_num), pick(det), s_pick


def _hit_t(u_num, v_num, t_num, det, tmin, tmax, cull_backface):
    """Per-(lane, slot) hit test; returns t where hit else 1e30."""
    if cull_backface:
        det_ok = det > _EPS_DET
        s_u, s_v, s_det = u_num, v_num, det
    else:
        det_ok = torch.abs(det) > _EPS_DET
        sgn = torch.sign(det)
        s_u, s_v, s_det = u_num * sgn, v_num * sgn, torch.abs(det)
    inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    t = t_num * inv
    hit = det_ok & (s_u >= 0.0) & (s_v >= 0.0) & (s_u + s_v <= s_det) \
        & (t > tmin[..., None]) & (t < tmax[..., None])
    return torch.where(hit, t, _BIG)


def _round_block(cs, feats, e, c, r, n_cols, alive, bound):
    """The running tiles of a round and their coefficient blocks."""
    run = alive & (e < _BIG) & (r < n_cols)
    if bound is not None:
        run = run & (e <= bound)
    block = cs.coeff[torch.where(run, c, 0).long()]
    u_num, v_num, t_num, det = _split_mt(torch.bmm(feats, block), cs.tri_k)
    return run, u_num, v_num, t_num, det


def _closest_loop(cs, entries_s, ids_s, o_t, d_t, tmin_t, tmax_t,
                  cull_backface):
    """Near-to-far cluster walk over one tile subset, matmul formulation."""
    feats = ray_features(o_t, d_t)
    nt, tile = o_t.shape[:2]
    k = cs.tri_k
    n_cols = entries_s.shape[0]
    dev = o_t.device
    best_t = torch.full((nt, tile), _BIG, device=dev)
    best_id = torch.full((nt, tile), -1, dtype=torch.int32, device=dev)
    best_un = torch.zeros((nt, tile), device=dev)
    best_vn = torch.zeros((nt, tile), device=dev)
    best_dn = torch.ones((nt, tile), device=dev)
    alive = torch.ones((nt,), dtype=torch.bool, device=dev)
    r = 0
    while bool(alive.any()):
        rc = min(r, n_cols - 1)
        e, c = entries_s[rc], ids_s[rc]
        tmax_eff = torch.minimum(best_t, tmax_t)
        run, u_num, v_num, t_num, det = _round_block(
            cs, feats, e, c, r, n_cols, alive, torch.amax(tmax_eff, dim=1))
        tt = _hit_t(u_num, v_num, t_num, det, tmin_t, tmax_eff,
                    cull_backface)
        tt = torch.where(run[:, None, None], tt, _BIG)
        t_min, u_np, v_np, d_np, s_pick = _min_by_t(tt, u_num, v_num, det, k)
        improved = t_min < best_t
        tri = cs.tri_begin[c.long()][:, None] + s_pick
        best_id = torch.where(improved, tri, best_id)
        best_un = torch.where(improved, u_np, best_un)
        best_vn = torch.where(improved, v_np, best_vn)
        best_dn = torch.where(improved, d_np, best_dn)
        best_t = torch.where(improved, t_min, best_t)
        alive = alive & run
        r += 1
    inv = 1.0 / torch.where(torch.abs(best_dn) > 0, best_dn, 1.0)
    return best_t, best_id, best_un * inv, best_vn * inv


def _any_loop(cs, entries_s, ids_s, o_t, d_t, tmin_t, tmax_t):
    feats = ray_features(o_t, d_t)
    nt, tile = o_t.shape[:2]
    n_cols = entries_s.shape[0]
    occ = torch.zeros((nt, tile), dtype=torch.bool, device=o_t.device)
    alive = torch.ones((nt,), dtype=torch.bool, device=o_t.device)
    r = 0
    while bool(alive.any()):
        rc = min(r, n_cols - 1)
        e, c = entries_s[rc], ids_s[rc]
        live = alive & ~torch.all(occ | (tmax_t < tmin_t), dim=1)
        run, u_num, v_num, t_num, det = _round_block(
            cs, feats, e, c, r, n_cols, live, None)
        tt = _hit_t(u_num, v_num, t_num, det, tmin_t, tmax_t, False)
        occ = occ | (torch.any(tt < _BIG, dim=2) & run[:, None])
        alive = alive & run
        r += 1
    return occ


# ---------------------------------------------------------------------------
# the round walk on the host (K4's round, plain version)
# ---------------------------------------------------------------------------

def _round_walk(cs, entries_s, ids_s, o_t, d_t, tmin_t, tmax_t,
                cull_backface, round_fn):
    """Near-to-far cluster walk over one tile subset, one `round_fn` call
    (K4's round or its plain version) per round; the loop runs on the
    host."""
    nt, tile = o_t.shape[:2]
    n_cols = entries_s.shape[0]
    dev = o_t.device
    best_t = torch.full((nt, tile), _BIG, device=dev)
    best_id = torch.full((nt, tile), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((nt, tile), device=dev)
    best_v = torch.zeros((nt, tile), device=dev)
    alive = torch.ones((nt,), dtype=torch.bool, device=dev)
    WALK_STATS["buckets"] += 1
    for r in range(n_cols):
        WALK_STATS["syncs"] += 1
        if not bool(alive.any()):
            break
        WALK_STATS["rounds"] += 1
        e, c = entries_s[r], ids_s[r]
        tmax_eff = torch.minimum(best_t, tmax_t)
        run = alive & (e < _BIG) & (e <= torch.amax(tmax_eff, dim=1))
        t_min, u_p, v_p, _, s_pick = round_fn(
            o_t, d_t, cs.tri_block, cs.tri_count, c, run, tmin_t, tmax_eff,
            cs.tri_k, cull_backface)
        improved = (t_min < best_t) & run[:, None]
        tri = cs.tri_begin[c.long()][:, None] + s_pick
        best_id = torch.where(improved, tri, best_id)
        best_u = torch.where(improved, u_p, best_u)
        best_v = torch.where(improved, v_p, best_v)
        best_t = torch.where(improved, t_min, best_t)
        alive = alive & run
    return best_t, best_id, best_u, best_v


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _walk(cs, origins, dirs, tmin, tmax, tile, sort_rays, walk):
    """Sort (optional), pad, prepare, walk the prepared tiles with `walk`
    (-> per-tile outputs, each (NT, tile), in the busiest-first order), and
    return them per lane in the caller's lane order."""
    n = origins.shape[0]
    tmin = _as_lanes(tmin, n, origins.device)
    tmax = _as_lanes(tmax, n, origins.device)
    perm = None
    if sort_rays:
        perm, origins, dirs, tmin, tmax = sort_rays_live(cs, origins, dirs,
                                                         tmin, tmax)
    origins, dirs, tmin, tmax, n_orig = _pad_rays(origins, dirs, tmin, tmax,
                                                  tile)
    entries_s, ids_s, o_t, d_t, tmin_t, tmax_t, inv_order, _ = _prepare(
        cs, origins, dirs, tmin, tmax, tile)
    out = walk(cs, entries_s, ids_s, o_t, d_t, tmin_t, tmax_t)
    out = [a[inv_order].reshape(-1)[:n_orig] for a in out]
    if perm is not None:
        out = [unsort(a, perm) for a in out]
    return out


def _in_buckets(loop):
    """A host loop run over the busiest-first buckets of _bucket_sizes, one
    after the other, each with its visit orders as (C, tiles) so that a
    round reads one contiguous row."""
    def walk(cs, entries_s, ids_s, o_t, d_t, tmin_t, tmax_t):
        parts = []
        pos = 0
        for sz in _bucket_sizes(o_t.shape[0]):
            sl = slice(pos, pos + sz)
            out = loop(cs, entries_s[sl].T.contiguous(),
                       ids_s[sl].T.contiguous(), o_t[sl], d_t[sl],
                       tmin_t[sl], tmax_t[sl])
            parts.append(out if isinstance(out, tuple) else (out,))
            pos += sz
        return [torch.cat(p) for p in zip(*parts)]
    return walk


def _kernel_walk(cull_backface):
    """The card's round walk: every tile in one K4 launch, no host sync."""
    def walk(cs, entries_s, ids_s, o_t, d_t, tmin_t, tmax_t):
        WALK_STATS["walks"] += 1
        t, tri, u, v, rounds = kernels.round_walk(
            o_t, d_t, tmin_t, tmax_t, entries_s, ids_s, cs.tri_block,
            cs.tri_begin, cs.tri_count, cs.tri_k, cull_backface)
        if ROUND_LOG is not None:
            ROUND_LOG.append(rounds)
        return t, tri, u, v
    return walk


def _hit(best_t, best_id, best_u, best_v) -> Hit:
    found = best_id >= 0
    return Hit(t=torch.where(found, best_t, _BIG), tri=best_id,
               u=torch.where(found, best_u, 0.0),
               v=torch.where(found, best_v, 0.0))


def _round_loop(round_fn, cull_backface):
    WALK_STATS["walks"] += 1
    return _in_buckets(lambda *a: _round_walk(*a, cull_backface, round_fn))


def _require_cpu(origins, what: str) -> None:
    if origins.device.type != "cpu":
        raise ValueError(
            f"{what}: the matmul walk is the plain version for CPU tensors; "
            f"got {origins.device} (use use_kernel=True, or "
            f"pallas_tile.pallas_any, on the card)")


def tile_closest(cs: TileClusterSet, origins, dirs, tmin, tmax,
                 cull_backface: bool = True, tile: int = 64,
                 use_kernel: bool = False, sort_rays: bool = False) -> Hit:
    """Closest-hit traversal; t=1e30 / tri=-1 on a miss. use_kernel=False
    runs the matmul walk (CPU tensors only); use_kernel=True the round walk
    (K4's whole walk in one launch on CUDA tensors, the host loop over K4's
    plain round on CPU tensors). sort_rays=True re-orders the wavefront by
    ray_sort_key_live first."""
    from . import pallas_tile

    if not use_kernel:
        _require_cpu(origins, "tile_closest(use_kernel=False)")
        walk = _in_buckets(lambda *a: _closest_loop(*a, cull_backface))
    elif origins.device.type == "cpu":
        walk = _round_loop(pallas_tile.mt_round, cull_backface)
    else:
        walk = _kernel_walk(cull_backface)
    return _hit(*_walk(cs, origins, dirs, tmin, tmax, tile, sort_rays, walk))


def tile_closest_plain(cs: TileClusterSet, origins, dirs, tmin, tmax,
                       cull_backface: bool = True, tile: int = 64,
                       sort_rays: bool = False) -> Hit:
    """tile_closest(use_kernel=True) through the host loop over the plain
    round on any device (K4's reference on the card)."""
    from . import pallas_tile

    walk = _round_loop(pallas_tile.mt_round_blocks_plain, cull_backface)
    return _hit(*_walk(cs, origins, dirs, tmin, tmax, tile, sort_rays, walk))


def tile_any(cs: TileClusterSet, origins, dirs, tmin, tmax, tile: int = 64,
             sort_rays: bool = False):
    """Any-hit (occlusion) traversal, no back-face culling (reference
    cuProg.h:478): the matmul walk, CPU tensors only (on the card the tile
    mode's any hit is pallas_tile.pallas_any, kernel K5). Returns bool."""
    _require_cpu(origins, "tile_any")
    (occ,) = _walk(cs, origins, dirs, tmin, tmax, tile, sort_rays,
                   _in_buckets(_any_loop))
    return occ

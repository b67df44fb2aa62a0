"""numpy transcriptions of the tile-walk, list-walk and brute-force kernels'
designs (spcbpt_tpu_torch/csrc/tile_walk.cu, csrc/list_walk.cu,
csrc/brute_trace.cu), which run only on the card: the CPU tests hold them
bit for bit to the plain versions of ops/tile_trace, ops/pallas_tile,
ops/pallas_walk and ops/brute_trace, and their visits to
ops/clusters.VISIT_LOG or to the plain walk's rounds."""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from spcbpt_tpu_torch.kernels import build


def cuda_constant(source: str, name: str) -> int:
    """The `constexpr int name = value;` of csrc/<source>.cu, read from its
    text (nothing is built): the designs run at the sizes the kernels ship
    with."""
    with open(os.path.join(build.SRC_DIR, f"{source}.cu")) as f:
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    return int(value)


def mt_slots(o, d, blk, k, tmn, tmx, cull):
    """The kernel's branch-free slot test (`mt_test`) in numpy float32, every
    product and sum rounded on its own as the kernel (built with
    --fmad=false) rounds it: o/d (..., R, 3), blk (..., 16, 128), tmn/tmx
    (..., R), slots [0, k) -> (hit, t, u, v), each (..., R, k)."""
    f32 = np.float32
    ox, oy, oz = (o[..., a:a + 1] for a in range(3))
    dx, dy, dz = (d[..., a:a + 1] for a in range(3))
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (blk[..., j, None, :k]
                                                   for j in range(9))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = det > f32(1e-10) if cull else np.abs(det) > f32(1e-10)
    inv = f32(1.0) / np.where(det_ok, det, f32(1.0))
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = det_ok & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t > tmn[..., None]) & (t < tmx[..., None])
    return hit, t, u, v


def k4_walk(cull, rec):
    """The kernel's walk as ops/tile_trace._walk calls it: each tile alone,
    round after round over its visit order; the bound is the exact max of
    min(best_t, tmax) over the tile's lanes; the cluster's slots below
    tri_count, strict < over ascending slots, improvement on strict <. The
    visit orders it was given and each tile's round count go to `rec`."""
    def walk(cs, entries, ids, o_t, d_t, tmin_t, tmax_t):
        rec["ids"], rec["rounds"] = idn, rounds = ids.numpy(), []
        blocks, begin = cs.tri_block.numpy(), cs.tri_begin.numpy()
        count = cs.tri_count.numpy()
        ent = entries.numpy()
        o_n, d_n, tn, tx = (a.numpy() for a in (o_t, d_t, tmin_t, tmax_t))
        nt, lanes = tn.shape
        n_cols = ent.shape[1]
        out_t = np.full((nt, lanes), 1e30, np.float32)
        out_tri = np.full((nt, lanes), -1, np.int32)
        out_u = np.zeros((nt, lanes), np.float32)
        out_v = np.zeros((nt, lanes), np.float32)
        for i in range(nt):
            bt, bid, bu, bv = out_t[i], out_tri[i], out_u[i], out_v[i]
            rnd = 0
            while rnd < n_cols:
                bound = np.minimum(bt, tx[i]).max()
                e, cid = ent[i, rnd], idn[i, rnd]
                if not (e < 1e30 and e <= bound):
                    break
                tmax_eff = np.minimum(bt, tx[i])
                hit, t, u, v = mt_slots(o_n[i], d_n[i], blocks[cid],
                                        count[cid], tn[i], tmax_eff, cull)
                hit &= (tmax_eff > tn[i])[:, None]
                tt = np.where(hit, t, np.inf)
                slot = np.argmin(tt, axis=1)     # the first slot at the min
                lane = np.arange(lanes)
                cb = tt[lane, slot]
                imp = cb < bt
                bt[imp] = cb[imp]
                bid[imp] = begin[cid] + slot[imp]
                bu[imp] = u[lane, slot][imp]
                bv[imp] = v[lane, slot][imp]
                rnd += 1
            rounds.append(rnd)
        return [torch.from_numpy(a) for a in (out_t, out_tri, out_u, out_v)]
    return walk


def _group_entries(cs, o, d, tmn, tmx):
    """The conservative entry bound of one group of rays into every
    cluster, in the kernel's operation order (`hull_axis`, `hull_entry`:
    tile_trace.tile_entries for one tile): (C,) float32, 1e30 out of
    reach."""
    f32 = np.float32
    big, tiny = f32(1e30), f32(1e-12)
    cmin, cmax = cs.cmin.numpy(), cs.cmax.numpy()
    olo, ohi = o.min(axis=0), o.max(axis=0)
    dlo, dhi = d.min(axis=0), d.max(axis=0)
    straddle = (dlo <= 0) & (dhi >= 0)
    safe = lambda x: np.where(np.abs(x) < tiny, np.where(x < 0, -tiny, tiny),
                              x)
    il = np.minimum(f32(1.0) / safe(dlo), f32(1.0) / safe(dhi))
    ih = np.maximum(f32(1.0) / safe(dlo), f32(1.0) / safe(dhi))
    lo_ab = np.minimum(cmin - ohi, cmax - ohi)
    hi_ab = np.maximum(cmin - olo, cmax - olo)
    p = (lo_ab * il, lo_ab * ih, hi_ab * il, hi_ab * ih)
    ax_lo = np.minimum(np.minimum(p[0], p[1]), np.minimum(p[2], p[3]))
    ax_hi = np.maximum(np.maximum(p[0], p[1]), np.maximum(p[2], p[3]))
    ax_lo = np.where(straddle, -big, ax_lo)
    ax_hi = np.where(straddle, big, ax_hi)
    entry, exit_ = ax_lo.max(axis=1), ax_hi.min(axis=1)
    overlap = (entry <= exit_) & (exit_ >= tmn.min()) & (entry <= tmx.max())
    return np.where(overlap, entry, big)


K5_TILE = cuda_constant("tile_walk", "kTile")   # rays per tile of K5


def tile_order(cs, o, d, tmn, tmx, rec):
    """The prologue of both K5 kernels (`tile_order`) on padded numpy rays:
    each 128-ray tile computes its entries, compacts those below 1e30 in id
    order (a ballot per warp, a prefix over the warps) and sorts them near
    to far by (entry, id) once. Returns a list per tile of (ids, entries)
    in that order; each tile's candidate list (ids, entries) in id order
    goes to rec["lists"]."""
    rec["lists"], order = [], []
    for g in range(tmn.shape[0] // K5_TILE):
        sl = slice(K5_TILE * g, K5_TILE * (g + 1))
        e = _group_entries(cs, o[sl], d[sl], tmn[sl], tmx[sl])
        ids = np.nonzero(e < np.float32(1e30))[0]
        rec["lists"].append((ids, e[ids]))
        near = np.lexsort((ids, e[ids]))
        order.append((ids[near], e[ids][near]))
    return order


def any_tile_walk(cs, o, d, tmn, tmx, rec):
    """K5 any (`any_tile_kernel`) on padded rays -> int32 flags: each tile
    takes its sorted list from the prologue (tile_order) and walks it until
    each of its lanes is occluded or dead; only lanes neither occluded nor
    with tmax <= tmin test the cluster's slots below tri_count. Each tile's
    candidate list (ids, entries) and visit order go to `rec`."""
    tile = K5_TILE
    o_n, d_n, tn, tx = (a.numpy() for a in (o, d, tmn, tmx))
    blocks, count = cs.tri_block.numpy(), cs.tri_count.numpy()
    occ = np.zeros(tn.shape[0], bool)
    rec["visits"] = []
    for g, (near, _) in enumerate(tile_order(cs, o_n, d_n, tn, tx, rec)):
        sl = slice(tile * g, tile * (g + 1))
        visited = []
        dead = tx[sl] < tn[sl]
        for cid in near:
            if (occ[sl] | dead).all():
                break
            hit = mt_slots(o_n[sl], d_n[sl], blocks[cid], count[cid], tn[sl],
                           tx[sl], False)[0].any(axis=1)
            occ[sl] |= hit & ~occ[sl] & (tx[sl] > tn[sl])
            visited.append(int(cid))
        rec["visits"].append(visited)
    return torch.from_numpy(occ.astype(np.int32))


def _lex_min(t, s, u, v, ot, os_, ou, ov):
    """The shuffle step of the closest kernels: the other thread's (t, slot)
    where it is smaller, the smaller slot at an equal t."""
    take = (ot < t) | ((ot == t) & (os_ < s))
    return (np.where(take, ot, t), np.where(take, os_, s),
            np.where(take, ou, u), np.where(take, ov, v))


def split_min(hit, t, u, v, split):
    """The closest kernels' pick over a ray's slots, (..., K) each: thread
    q of `split` keeps the (t, slot)-smallest hit of its slots q, q + split,
    ... (ascending, strict <; 1e30 and slot K without one), and xor steps
    over the threads keep the smallest t, then the smallest slot ->
    (t, slot, u, v), each (...)."""
    f32, big = np.float32, np.float32(1e30)
    k = hit.shape[-1]
    shape = hit.shape[:-1] + (k // split, split)
    tq = np.where(hit, t, big).reshape(shape)
    j = np.expand_dims(np.argmin(tq, axis=-2), -2)
    any_q = hit.reshape(shape).any(axis=-2)
    pick = lambda a: np.take_along_axis(a.reshape(shape), j, -2)[..., 0, :]
    slot = np.arange(k).reshape(k // split, split)   # [j, q]
    cb = np.where(any_q, pick(tq), big)
    cs_ = np.where(any_q, slot[j[..., 0, :], np.arange(split)], k)
    cu = np.where(any_q, pick(u), f32(0))
    cv = np.where(any_q, pick(v), f32(0))
    mask = 1
    while mask < split:
        other = np.arange(split) ^ mask
        cb, cs_, cu, cv = _lex_min(cb, cs_, cu, cv, cb[..., other],
                                   cs_[..., other], cu[..., other],
                                   cv[..., other])
        mask <<= 1
    return cb[..., 0], cs_[..., 0], cu[..., 0], cv[..., 0]


def round_split(o_t, d_t, tri_block, tri_count, cid, run, tmn, tmx, cull,
                split):
    """K4's single round (`round_kernel`) on (NT, R) tiles -> (t, u, v, dn,
    slot) as torch tensors: a running tile's rays test the slots below its
    cluster's tri_count, each ray's slots on `split` threads (split_min); a
    tile that does not run, and a ray with tmax <= tmin, keep the miss
    (t 1e30, u = v = 0, slot 128); dn is 1."""
    o_n, d_n, tn, tx = (a.numpy() for a in (o_t, d_t, tmn, tmx))
    blocks, count = tri_block.numpy(), tri_count.numpy()
    c, go = cid.numpy(), run.numpy()
    hit, t, u, v = mt_slots(o_n, d_n, blocks[c], blocks.shape[-1], tn, tx,
                            cull)
    hit &= np.arange(blocks.shape[-1]) < count[c][:, None, None]
    hit &= (go[:, None] & (tx > tn))[..., None]
    out = split_min(hit, t, u, v, split)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (out[0], out[2], out[3], np.ones_like(out[0]),
             out[1].astype(np.int32))]


def closest_tile_walk(cs, o, d, tmn, tmx, cull, group, rec):
    """K5 closest (`closest_walk_kernel`) on padded rays -> (t, tri, u, v)
    as torch tensors: each 128-ray tile takes its sorted list from the
    prologue (tile_order, shared with K5 any), and its groups of `group`
    rays walk it as the list-walk kernels' groups walk theirs (group_walk:
    each stopping on its own bound, the max of min(best_t, tmax) over its
    rays, tested before every round; slots below tri_count on 32 / group
    threads a ray, split_min; improvement on strict <). Each tile's
    candidate list goes to rec["lists"], its sorted order to rec["order"],
    each group's rounds to rec["rounds"]."""
    o_n, d_n, tn, tx = (a.numpy() for a in (o, d, tmn, tmx))
    order = tile_order(cs, o_n, d_n, tn, tx, rec)
    rec["order"] = [ids for ids, _ in order]
    nt = len(order)
    width = max(1, max(len(ids) for ids, _ in order))
    counts = np.array([len(ids) for ids, _ in order], np.int32)
    lists = np.zeros((nt, width), np.int32)
    entries = np.full((nt, width), np.float32(1e30), np.float32)
    for i, (ids, e) in enumerate(order):
        lists[i, :len(ids)] = ids
        entries[i, :len(ids)] = e
    bases = cs.tri_begin.numpy()[lists]
    return group_walk(cs, *map(torch.from_numpy, (counts, lists, bases,
                                                   entries)),
                      o, d, tmn, tmx, cull, True, group, rec)


def group_walk(cs, counts, ids, bases, entries, o, d, tmn, tmx, cull, prune,
               group, rec):
    """K6 closest (`closest_kernel` of csrc/list_walk.cu) on prepared rays
    over cluster set `cs` (its blocks() and tri_count): groups of `group`
    consecutive rays (one warp each) walk their tile's list in the tile's
    order and test every cluster of it up to their stop. A group tests its
    bound, the max of min(best_t, tmax) over its rays, before every round,
    round 0 included, and stops when the next entry exceeds it (prune) or
    the list ends. A ray's slots lie on S = 32 / group threads, slot k on
    thread k % S; each thread keeps the (t, slot)-smallest hit of its slots
    below the cluster's tri_count under the round's min(best_t, tmax) (1e30
    and slot 128 without one), and xor steps over the S threads keep the
    smallest t, then the smallest slot; best improves on strict <.
    Returns (t, tri, u, v) as torch tensors; each group's rounds walked and
    slots tested, summed over its rays (each ray every slot below tri_count
    of every cluster walked), go to rec["rounds"] and rec["slots"]."""
    f32, big = np.float32, np.float32(1e30)
    blocks = cs.blocks().numpy()
    slots = blocks.shape[-1]
    count, ids, bases, entries = (
        a.numpy() for a in (cs.tri_count, ids, bases, entries))
    nt, c = entries.shape
    tile = o.shape[0] // nt
    split = 32 // group
    ng = o.shape[0] // group
    og, dg = (a.numpy().reshape(ng, group, 3) for a in (o, d))
    tn, tx = (a.numpy().reshape(ng, group) for a in (tmn, tmx))
    tile_of = np.arange(ng) * group // tile
    n = counts.numpy()[tile_of]
    best_t = np.full((ng, group), big, f32)
    best_id = np.full((ng, group), -1, np.int32)
    best_u = np.zeros((ng, group), f32)
    best_v = np.zeros((ng, group), f32)
    rounds = np.zeros(ng, np.int64)
    tested = np.zeros(ng, np.int64)
    bound = lambda g: np.minimum(best_t[g], tx[g]).max(axis=1)
    walk = n > 0
    if prune:
        walk &= entries[tile_of, 0] <= bound(slice(None))
    run = np.nonzero(walk)[0]
    r = 0
    while run.size:
        tl = tile_of[run]
        cid = ids[tl, r]
        tested[run] += group * count[cid]
        tmax_eff = np.minimum(best_t[run], tx[run])
        hit, t, u, v = mt_slots(og[run], dg[run], blocks[cid], slots,
                                tn[run], tmax_eff, cull)
        hit &= np.arange(slots) < count[cid][:, None, None]
        hit &= (tmax_eff > tn[run])[..., None]
        cb, cs_, cu, cv = split_min(hit, t, u, v, split)
        imp = cb < best_t[run]
        best_t[run] = np.where(imp, cb, best_t[run])
        best_id[run] = np.where(imp, bases[tl, r][:, None] + cs_,
                                 best_id[run])
        best_u[run] = np.where(imp, cu, best_u[run])
        best_v[run] = np.where(imp, cv, best_v[run])
        r += 1
        rounds[run] = r
        more = r < n[run]
        if prune:
            more &= entries[tl, min(r, c - 1)] <= bound(run)
        run = run[more]
    rec["rounds"], rec["slots"] = rounds, tested
    return [torch.from_numpy(a.reshape(-1))
            for a in (best_t, best_id, best_u, best_v)]


def group_walk_any(cs, counts, ids, entries, o, d, tmn, tmx, group, rec):
    """K6 any (`any_kernel` of csrc/list_walk.cu) on prepared rays over
    cluster set `cs` (its blocks() and tri_count): groups of `group`
    consecutive rays (one warp each) walk their tile's list in the tile's
    order. A group tests its bound, the max over its rays of (occluded ?
    -1e30 : tmax), before every round, round 0 included, and stops when the
    next entry exceeds it or the list ends. A ray's slots below the
    cluster's tri_count lie on S = 32 / group threads, slot k on thread
    k % S; each thread tests its slots in order and leaves at its first hit
    (t in (tmin, tmax), t < 1e30); a ray is occluded once one of its threads
    hit, and an occluded ray, or one with tmax <= tmin, tests nothing more.
    Returns the int32 flags as a torch tensor; each group's rounds walked
    and slots tested (summed over its rays) go to rec["rounds"] and
    rec["slots"]."""
    big = np.float32(1e30)
    blocks = cs.blocks().numpy()
    slots = blocks.shape[-1]
    count, ids, entries = (a.numpy() for a in (cs.tri_count, ids, entries))
    nt, c = entries.shape
    tile = o.shape[0] // nt
    split = 32 // group
    ng = o.shape[0] // group
    og, dg = (a.numpy().reshape(ng, group, 3) for a in (o, d))
    tn, tx = (a.numpy().reshape(ng, group) for a in (tmn, tmx))
    tile_of = np.arange(ng) * group // tile
    n = counts.numpy()[tile_of]
    occ = np.zeros((ng, group), bool)
    rounds = np.zeros(ng, np.int64)
    tested = np.zeros(ng, np.int64)
    bound = lambda g: np.where(occ[g], -big, tx[g]).max(axis=1)
    run = np.nonzero((n > 0) & (entries[tile_of, 0] <= bound(slice(None))))[0]
    r = 0
    while run.size:
        tl = tile_of[run]
        cid = ids[tl, r]
        cnt = count[cid][:, None, None, None]
        live = ~occ[run] & (tx[run] > tn[run])
        hit, t = mt_slots(og[run], dg[run], blocks[cid], slots, tn[run],
                          tx[run], False)[:2]
        hit &= t < big
        # thread q's slots q, q + S, ...: [group, ray, j, q]
        shape = (run.size, group, slots // split, split)
        k = np.arange(slots).reshape(slots // split, split)
        mine = (k < cnt) & live[..., None, None]
        hit = hit.reshape(shape) & mine
        first = np.where(hit.any(axis=2), np.argmax(hit, axis=2), slots)
        tested[run] += np.minimum(mine.sum(axis=2), first + 1).sum(axis=(1, 2))
        occ[run] |= hit.any(axis=(2, 3))
        r += 1
        rounds[run] = r
        more = (r < n[run]) & (entries[tl, min(r, c - 1)] <= bound(run))
        run = run[more]
    rec["rounds"], rec["slots"] = rounds, tested
    return torch.from_numpy(occ.reshape(-1).astype(np.int32))


K3_BLOCK = 256   # rays a block packs (kBlock of csrc/brute_trace.cu)


def brute_walk(o, d, tmn, tmx, p0, e1, e2, cull, query, rec=None):
    """K3 (`closest_kernel` / `any_kernel` of csrc/brute_trace.cu) in numpy
    float32 on (n,) rays against (T, 3) triangle tables, `query` "closest"
    or "any". The table is padded with zero triangles to a multiple of 4
    (the kernel's float4 rows; a zero triangle fails det). Each block of
    K3_BLOCK lanes lists its live lanes (tmax > tmin) in ascending order,
    and its first threads take them; dead lanes and lanes past n keep the
    miss.
    A live ray walks the table in order with the staged test: det ->
    reject; inv = 1/det, u -> reject outside [0, 1]; qvec, v -> reject if
    v < 0 or u + v > 1; t -> reject outside (tmin, min(tmax, best t)), each
    stage computed only for the rays still in. Closest takes a hit only on
    a strictly smaller t (the smallest id among equal t); any leaves a ray
    at its first hit. Every product and sum rounds on its own, as the
    kernel (built with --fmad=false) rounds it. Returns (t, tri, u, v) or
    the bool flags as torch tensors; `rec` (a dict) gets each block's live
    count ("live"), the warps that hold live rays ("warps"), and the pairs
    that failed at det ("det"), at u ("u"), at v ("v"), that reached t
    ("t") and that were tested ("tests")."""
    f32 = np.float32
    big, eps = f32(1e30), f32(1e-10)
    o, d = (np.asarray(a, f32) for a in (o, d))
    tmn, tmx = (np.asarray(a, f32) for a in (tmn, tmx))
    tris = [np.asarray(a, f32) for a in (p0, e1, e2)]
    t_total = tris[0].shape[0]
    pad = -t_total % 4
    tris = [np.concatenate([a, np.zeros((pad, 3), f32)]) for a in tris]
    n = o.shape[0]
    alive = tmx > tmn
    starts = np.arange(0, n, K3_BLOCK)
    live = np.concatenate([np.nonzero(alive[b:b + K3_BLOCK])[0] + b
                           for b in starts]).astype(np.int64)
    per_block = np.add.reduceat(alive, starts) if n else np.zeros(0, int)
    best_t = np.full(n, big, f32)
    best_id = np.full(n, -1, np.int32)
    best_u = np.zeros(n, f32)
    best_v = np.zeros(n, f32)
    occ = np.zeros(n, bool)
    counts = dict(det=0, u=0, v=0, t=0, tests=0)
    run = live
    for j in range(t_total + pad):
        (p0x, p0y, p0z), (e1x, e1y, e1z), (e2x, e2y, e2z) = \
            (a[j] for a in tris)
        counts["tests"] += run.size
        ox, oy, oz = o[run].T
        dx, dy, dz = d[run].T
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        ok = det > eps if cull else np.abs(det) > eps
        counts["det"] += int((~ok).sum())
        r, det, pvx, pvy, pvz = (a[ok] for a in (run, det, pvx, pvy, pvz))
        dx, dy, dz, ox, oy, oz = (a[ok] for a in (dx, dy, dz, ox, oy, oz))
        inv = f32(1.0) / det
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        ok = (u >= 0) & (u <= 1)
        counts["u"] += int((~ok).sum())
        r, u, inv, tvx, tvy, tvz, dx, dy, dz = (
            a[ok] for a in (r, u, inv, tvx, tvy, tvz, dx, dy, dz))
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        ok = (v >= 0) & (u + v <= 1)
        counts["v"] += int((~ok).sum())
        counts["t"] += int(ok.sum())
        r, u, v, inv, qvx, qvy, qvz = (
            a[ok] for a in (r, u, v, inv, qvx, qvy, qvz))
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        hi = np.minimum(tmx[r], best_t[r]) if query == "closest" else tmx[r]
        ok = (t > tmn[r]) & (t < hi)
        r, t, u, v = (a[ok] for a in (r, t, u, v))
        if query == "closest":
            best_t[r], best_id[r], best_u[r], best_v[r] = t, j, u, v
        else:
            occ[r] = True
            run = run[~occ[run]]
    if rec is not None:
        rec.update(counts, live=per_block,
                   warps=int((-(-per_block // 32)).sum()))
    if query == "closest":
        return [torch.from_numpy(a) for a in (best_t, best_id, best_u, best_v)]
    return torch.from_numpy(occ)

"""The port's row walk (plain version on CPU) against the JAX Pallas row walk
run in interpret mode, on the same rays.

Rays and triangles are made with numpy from fixed seeds and given to both
packages. The CUDA kernels themselves run only on the card (chip_smoke.py
compares them with the plain version there); here the wrappers must take
the plain version for CPU tensors and never count a launch."""
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spcbpt_tpu.ops import bvh as bvh_mod
from spcbpt_tpu.ops import clusters as jcl
from spcbpt_tpu.ops import intersect as jint
from spcbpt_tpu.ops import ray_walk as jrw
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch.kernels import ray_walk as kernels
from spcbpt_tpu_torch.ops import clusters as tcl
from spcbpt_tpu_torch.ops import intersect as tint
from spcbpt_tpu_torch.ops import ray_walk as trw
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene.scene import from_jax_scene

# the tensors here are small: one thread per xdist worker avoids
# oversubscribing the cores

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

# t/u/v: XLA's CPU compiler contracts multiply-adds of the JAX
# Moller-Trumbore into FMAs, torch rounds every product. The few-ulp
# difference grows where the sums cancel (grazing rays, hits near an edge):
# measured up to 5.5e-6 relative in t on the interior camera rays. So t is
# held to 1e-5 relative and u/v (which pass through 0) to 1e-5 absolute;
# triangle ids must be equal.
RTOL, ATOL_UV = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def synthetic():
    """The 700-triangle set of tests/test_ray_walk.py, 300 rays."""
    rng = np.random.default_rng(11)
    nt = 700
    p0 = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (nt, 3)).astype(np.float32)
    flat = bvh_mod.build_bvh(p0, e1, e2)
    order = flat.order
    p0, e1, e2 = p0[order], e1[order], e2[order]
    jcs = jcl.build_clusters(flat, p0, e1, e2, max_tris=128, with_coeff=False)
    tcs = tcl.build_clusters(flat, p0, e1, e2, max_tris=128)
    n = 300
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmn = np.full((n,), 1e-3, np.float32)
    tmx = np.full((n,), 1e16, np.float32)
    tmx[::7] = -1.0          # dead lanes
    return dict(jcs=jcs, tcs=tcs, tris=(p0, e1, e2), o=o, d=d, tmn=tmn,
                tmx=tmx)


@pytest.fixture(scope="module")
def interior_rays(tmp_path_factory):
    """scale=1 interior (2,264 triangles, 30 clusters): 256 coherent camera
    rays and 256 incoherent bounce rays from their hits, a quarter dead."""
    root = tmp_path_factory.mktemp("interior")
    jts, desc, cam = jload(interior.generate(str(root), scale=1),
                           mode="walk")
    cam.aspect = 1.0
    ts = from_jax_scene(jts, "cpu")
    o, d, _ = camera_rays(*cam.uvw(), 16, 16, 0, block=8)
    hit = tint.brute_force_closest(o, d, ts.tri_p0, ts.tri_e1, ts.tri_e2,
                                   torch.full((256,), 1e-3),
                                   torch.full((256,), 1e16), False)
    assert (hit.tri >= 0).all()
    rng = np.random.default_rng(5)
    p = (o + hit.t[:, None] * d).numpy()
    nd = rng.normal(size=(256, 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
    perm = rng.permutation(256)
    tmx = np.full((256,), 1e16, np.float32)
    tmx[rng.permutation(256)[:64]] = -1.0
    return dict(jcs=jts.clusters_walk, tcs=ts.clusters_walk,
                tris=tuple(a.numpy() for a in (ts.tri_p0, ts.tri_e1,
                                               ts.tri_e2)),
                camera=(o.numpy(), d.numpy(), np.full((256,), 1e16,
                                                      np.float32)),
                bounce=(p[perm], nd, tmx))


def _closest_pair(case, o, d, tmn, tmx, cull, sort_rays):
    ref = jrw.walk_closest(case["jcs"], jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tmn), jnp.asarray(tmx), cull,
                           sort_rays=sort_rays, interpret=True)
    got = trw.walk_closest(case["tcs"], _t(o), _t(d), _t(tmn), _t(tmx), cull,
                           sort_rays=sort_rays)
    return ref, got


def _walk_t(tris, o, d, ids):
    """t of one ray against triangles `ids` in the plain walk's own
    arithmetic (1e30 where it misses one)."""
    slots = np.zeros((1, len(ids), 12), np.float32)
    for k, a in enumerate(tris):
        slots[0, :, 4 * k:4 * k + 3] = a[ids]
    tt, _, _ = trw._mt_rows3(_t(o[None, None]), _t(d[None, None]),
                             _t(slots), torch.full((1, 1), -1e30),
                             torch.full((1, 1), 1e30), False)
    return tt[0, 0].numpy()


def _assert_same_hits(ref, got, case, o, d):
    """The port's hits against JAX's: the same triangle on every lane but
    at a closest-hit tie, where the port keeps the lower file id
    (`tri_file`) and JAX the earlier visited cluster's; there both
    triangles reach the port's t in the walk's own arithmetic."""
    tri, jtri = got.tri.numpy(), np.asarray(ref.tri)
    tie = tri != jtri
    file = case["tcs"].tri_file.numpy()
    for i in np.nonzero(tie)[0]:
        t = _walk_t(case["tris"], o[i], d[i], [tri[i], jtri[i]])
        assert t[0] == t[1] == got.t.numpy()[i], (i, tri[i], jtri[i], t)
        assert file[tri[i]] < file[jtri[i]], (i, tri[i], jtri[i])
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=RTOL)
    np.testing.assert_allclose(got.u.numpy()[~tie], np.asarray(ref.u)[~tie],
                               rtol=RTOL, atol=ATOL_UV)
    np.testing.assert_allclose(got.v.numpy()[~tie], np.asarray(ref.v)[~tie],
                               rtol=RTOL, atol=ATOL_UV)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("sort_rays", [False, True])
def test_closest_synthetic_matches_jax(synthetic, cull, sort_rays):
    s = synthetic
    ref, got = _closest_pair(s, s["o"], s["d"], s["tmn"], s["tmx"], cull,
                             sort_rays)
    _assert_same_hits(ref, got, s, s["o"], s["d"])
    assert (got.tri.numpy() >= 0).sum() > 20
    assert (got.tri.numpy()[::7] == -1).all()       # dead lanes never hit


@pytest.mark.parametrize("sort_rays", [False, True])
def test_any_synthetic_matches_jax(synthetic, sort_rays):
    s = synthetic
    tseg = np.where(s["tmx"] < 0, -1.0, 1.5).astype(np.float32)
    ref = jrw.walk_any(s["jcs"], jnp.asarray(s["o"]), jnp.asarray(s["d"]),
                       jnp.asarray(s["tmn"]), jnp.asarray(tseg),
                       sort_rays=sort_rays, interpret=True)
    got = trw.walk_any(s["tcs"], _t(s["o"]), _t(s["d"]), _t(s["tmn"]),
                       _t(tseg), sort_rays=sort_rays)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy().sum() > 10


@pytest.mark.parametrize("rays,cull,sort_rays", [
    ("camera", True, False), ("camera", False, True),
    ("bounce", False, True), ("bounce", True, False)])
def test_closest_interior_matches_jax(interior_rays, rays, cull, sort_rays):
    o, d, tmx = interior_rays[rays]
    tmn = np.full_like(tmx, 1e-3)
    ref, got = _closest_pair(interior_rays, o, d, tmn, tmx, cull, sort_rays)
    _assert_same_hits(ref, got, interior_rays, o, d)
    assert (got.tri.numpy() >= 0).mean() > 0.5


@pytest.mark.parametrize("sort_rays", [False, True])
def test_any_interior_matches_jax(interior_rays, sort_rays):
    o, d, tmx = interior_rays["bounce"]
    tmn = np.full_like(tmx, 1e-3)
    tseg = np.where(tmx < 0, -1.0, 2.0).astype(np.float32)
    ref = jrw.walk_any(interior_rays["jcs"], jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(tmn), jnp.asarray(tseg),
                       sort_rays=sort_rays, interpret=True)
    got = trw.walk_any(interior_rays["tcs"], _t(o), _t(d), _t(tmn), _t(tseg),
                       sort_rays=sort_rays)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_empty_rows(synthetic):
    """Rays that overlap nothing terminate with misses."""
    s = synthetic
    o_far = _t(s["o"] + 100.0)
    got = trw.walk_closest(s["tcs"], o_far, _t(s["d"]), _t(s["tmn"]),
                           _t(s["tmx"]), True)
    assert (got.tri.numpy() == -1).all()
    assert (got.t.numpy() == 1e30).all()
    assert (got.u.numpy() == 0).all() and (got.v.numpy() == 0).all()
    occ = trw.walk_any(s["tcs"], o_far, _t(s["d"]), _t(s["tmn"]),
                       torch.full((300,), 5.0))
    assert not occ.any()


def test_walk_matches_brute(synthetic):
    """The port's walk against the port's brute force (the oracle)."""
    s = synthetic
    p0, e1, e2 = (_t(a) for a in s["tris"])
    o, d, tmn, tmx = _t(s["o"]), _t(s["d"]), _t(s["tmn"]), _t(s["tmx"])
    ref = tint.brute_force_closest(o, d, p0, e1, e2, tmn, tmx, False,
                                   chunk=128)
    got = trw.walk_closest(s["tcs"], o, d, tmn, tmx, False, sort_rays=True)
    np.testing.assert_array_equal(got.tri.numpy(), ref.tri.numpy())
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=RTOL)
    tseg = torch.where(tmx < 0, -1.0, 1.5)
    np.testing.assert_array_equal(
        trw.walk_any(s["tcs"], o, d, tmn, tseg).numpy(),
        tint.brute_force_any(o, d, p0, e1, e2, tmn, tseg, chunk=128).numpy())


@pytest.mark.parametrize("cull", [True, False])
def test_brute_matches_jax(synthetic, cull):
    s = synthetic
    args = [s["o"], s["d"], *s["tris"], s["tmn"], s["tmx"]]
    ref = jint.brute_force_closest(*map(jnp.asarray, args), cull, chunk=128)
    got = tint.brute_force_closest(*map(_t, args), cull, chunk=128)
    _assert_same_hits(ref, got, s, s["o"], s["d"])
    tseg = np.full_like(s["tmx"], 1.5)
    args[-1] = tseg
    np.testing.assert_array_equal(
        tint.brute_force_any(*map(_t, args), chunk=128).numpy(),
        np.asarray(jint.brute_force_any(*map(jnp.asarray, args), chunk=128)))


def test_row_entries_matches_jax(synthetic):
    s = synthetic
    n = 296                                  # a multiple of the 8-ray row
    args = [s["o"][:n], s["d"][:n], s["tmn"][:n], s["tmx"][:n]]
    jcs, tcs = s["jcs"], s["tcs"]
    ref = jrw.row_entries(jcs.cmin, jcs.cmax, *map(jnp.asarray, args))
    got = trw.row_entries(tcs.cmin, tcs.cmax, *map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_tensors_take_plain_version(synthetic):
    """CPU tensors go through the plain version: no launch is counted."""
    s = synthetic
    kernels.reset_launches()
    trw.walk_closest(s["tcs"], _t(s["o"]), _t(s["d"]), _t(s["tmn"]),
                     _t(s["tmx"]), False, sort_rays=True)
    trw.walk_any(s["tcs"], _t(s["o"]), _t(s["d"]), _t(s["tmn"]),
                 _t(s["tmx"]), sort_rays=True)
    assert kernels.LAUNCHES == {"walk_closest": 0, "walk_any": 0}


def test_kernel_binding_rejects_cpu_tensors(synthetic):
    """The kernel binding itself takes only CUDA tensors: it raises before
    anything is built or launched."""
    s = synthetic
    cs = s["tcs"]
    n = 128
    o = torch.zeros((n, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.closest(o, o, o[:, 0], o[:, 0], cs.cmin, cs.cmax,
                        cs.tri_begin, cs.tri_count, cs.tri_slots, True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.any_hit(o, o, o[:, 0], o[:, 0], cs.cmin, cs.cmax,
                        cs.tri_count, cs.tri_slots)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.entries(o, o, o[:, 0], o[:, 0], cs.cmin, cs.cmax)
    assert kernels.LAUNCHES == {"walk_closest": 0, "walk_any": 0}


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel modules builds nothing (no nvcc here)."""
    code = ("import spcbpt_tpu_torch.kernels.ray_walk as k, "
            "spcbpt_tpu_torch.kernels.build as b, "
            "spcbpt_tpu_torch.ops.ray_walk; "
            "assert not b._LIBS and not b.BUILD_LOG; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_HOME": "/none",
                              "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_tri_slots_repack_keeps_slot_numbering(synthetic):
    """The kernels' slot-major table holds the same triangle in each slot as
    the JAX package's (C, 16, 128) block, and p0's fourth word the bits of
    the slot's file id (zero past the cluster's triangles)."""
    cs = synthetic["tcs"]
    blk = cs.tri_block
    slots = cs.tri_slots.numpy().reshape(cs.num_clusters, 128, 3, 4)
    np.testing.assert_array_equal(slots[..., :3].reshape(-1, 128, 9),
                                  blk[:, :9, :].transpose(0, 2, 1))
    assert (slots[:, :, 1:, 3] == 0).all()
    key = slots[:, :, 0, 3].view(np.int32)
    begin, count = cs.tri_begin.numpy(), cs.tri_count.numpy()
    file = cs.tri_file.numpy()
    assert sorted(file.tolist()) == list(range(len(file)))
    for c in range(cs.num_clusters):
        np.testing.assert_array_equal(
            key[c, :count[c]], file[begin[c]:begin[c] + count[c]])
        assert (key[c, count[c]:] == 0).all()


# ---------------------------------------------------------------------------
# The design of the CUDA kernels (csrc/ray_walk.cu), transcribed to numpy
# float32 row by row and held against the plain version on the CPU: the
# kernels themselves run only on the card.
# ---------------------------------------------------------------------------

_F = np.float32
_BIG = _F(1e30)
NO_KEY = 2**31 - 1


def _slab_entries(o, d, tmn, tmx, mn, mx):
    """(8, 3) rays against (B, 3) boxes -> the row's (B,) entries, in the
    kernel's operation order (floored reciprocal, slab, overlap, row min)."""
    tiny = _F(1e-12)
    inv = _F(1.0) / np.where(np.abs(d) < tiny, np.where(d < 0, -tiny, tiny), d)
    lo = (mn[None] - o[:, None]) * inv[:, None]
    hi = (mx[None] - o[:, None]) * inv[:, None]
    ax_lo = np.minimum(lo, hi).max(axis=2)
    ax_hi = np.maximum(lo, hi).min(axis=2)
    ov = (ax_lo <= ax_hi) & (ax_hi >= tmn[:, None]) & (ax_lo <= tmx[:, None])
    return np.where(ov, ax_lo, _BIG).min(axis=0)


def _candidate_list(cs, o, d, tmn, tmx):
    """Phase A: groups of 8 consecutive clusters first, then the clusters of
    the groups in reach -> the row's list [(entry, id)], in the kernel's
    order (4 groups a step, ballot order: group, then cluster)."""
    cmin, cmax = cs.cmin.numpy(), cs.cmax.numpy()
    c = cmin.shape[0]
    groups = -(-c // 8)
    pad = groups * 8 - c
    gmn = np.concatenate([cmin, np.full((pad, 3), np.inf, _F)]).reshape(
        groups, 8, 3).min(axis=1)
    gmx = np.concatenate([cmax, np.full((pad, 3), -np.inf, _F)]).reshape(
        groups, 8, 3).max(axis=1)
    act = np.nonzero(_slab_entries(o, d, tmn, tmx, gmn, gmx) < _BIG)[0]
    out = []
    for g in act:
        ids = np.arange(8 * g, min(8 * g + 8, c))
        e = _slab_entries(o, d, tmn, tmx, cmin[ids], cmax[ids])
        out += [(e[k], int(ids[k])) for k in range(len(ids)) if e[k] < _BIG]
    return out


def _successor(lst, last):
    """Phase B: the lexicographic (entry, id) successor of `last` in the
    unsorted list; (1e30, -1) when none is left."""
    later = [x for x in lst if x > last]
    return min(later) if later else (_BIG, -1)


def _mt(o, d, tri, tmn, tmax_eff, cull):
    """Moller-Trumbore of (8,) rays against (S, 12) slots -> hit (8, S) and
    t, u, v, in the operation order of the kernels' mt_hit."""
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    p0x, p0y, p0z, _, e1x, e1y, e1z, _, e2x, e2y, e2z, _ = (
        tri[None, :, k] for k in range(12))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = det > _F(1e-10) if cull else np.abs(det) > _F(1e-10)
    inv = _F(1.0) / np.where(det_ok, det, _F(1.0))
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = det_ok & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t > tmn[:, None]) & (t < tmax_eff[:, None])
    return hit, t, u, v


def _quarter_reduce(cb, ck, cs_, cu, cv):
    """(4, 8) per-quarter bests -> the rays' (8,) picks: two xor exchanges
    (lane masks 8 and 16) on the key (t, file id ck), smallest t, then
    file id; a quarter without a hit (t 1e30) never takes another's."""
    for m in (1, 2):                       # quarter q meets quarter q ^ m
        other = np.arange(4) ^ m
        ot, ok, os_ = cb[other], ck[other], cs_[other]
        ou, ov = cu[other], cv[other]
        take = (ot < cb) | ((ot == cb) & (ot < _BIG) & (ok < ck))
        cb, ck = np.where(take, ot, cb), np.where(take, ok, ck)
        cs_ = np.where(take, os_, cs_)
        cu, cv = np.where(take, ou, cu), np.where(take, ov, cv)
    assert all((x == x[0]).all() for x in (cb, ck, cs_, cu, cv))
    return cb[0], ck[0], cs_[0], cu[0], cv[0]


def _kernel_model(cs, o, d, tmn, tmx, cull, any_hit, all_slots=False):
    """The kernels' walk on prepared rays, row by row. Returns the outputs
    of closest_rows_plain / any_rows_plain, each row's visited clusters and
    each row's candidate list."""
    o, d, tmn, tmx = (np.asarray(a, _F) for a in (o, d, tmn, tmx))
    slots = cs.tri_slots.numpy()
    begin, count = cs.tri_begin.numpy(), cs.tri_count.numpy()
    keys = slots[:, :, 3].view(np.int32)    # p0's fourth word: the file id
    n = o.shape[0]
    best_t = np.full(n, _BIG)
    best_key = np.full(n, NO_KEY, np.int64)
    best_id = np.full(n, -1, np.int32)
    best_u, best_v = np.zeros(n, _F), np.zeros(n, _F)
    occ = np.zeros(n, bool)
    visits, lists = [], []
    for row in range(n // 8):
        s = slice(8 * row, 8 * row + 8)
        lst = _candidate_list(cs, o[s], d[s], tmn[s], tmx[s])
        lists.append(lst)
        seen, last = [], (-_BIG, -1)
        with np.errstate(all="ignore"):
            while True:
                e, cid = _successor(lst, last)
                if any_hit:
                    tmax_eff = tmx[s]
                    bound = np.where(occ[s], -_BIG, tmax_eff).max()
                    thit = tmax_eff
                else:
                    tmax_eff = np.minimum(best_t[s], tmx[s])
                    b = tmax_eff.max()
                    bound = b + np.abs(b) * _F(trw.STOP_SLACK)
                    thit = np.minimum(tmx[s], _BIG)
                if not (e < _BIG and e <= bound):
                    break
                seen.append(cid)
                cnt = 128 if all_slots else count[cid]
                live = (tmax_eff > tmn[s]) & ~occ[s]
                cb = np.full((4, 8), _BIG)
                ck = np.full((4, 8), NO_KEY, np.int64)
                cs_ = np.full((4, 8), 128)
                cu, cv = np.zeros((4, 8), _F), np.zeros((4, 8), _F)
                for q in range(4):
                    ids = np.arange(q, cnt, 4)
                    if not len(ids):
                        continue
                    hit, t, u, v = _mt(o[s], d[s], slots[cid, ids], tmn[s],
                                       thit, cull and not any_hit)
                    hit &= live[:, None] & (t < _BIG)
                    if not any_hit:
                        hit &= t <= best_t[s][:, None]
                    tt = np.where(hit, t, _BIG)
                    # the least (t, file id) of the quarter's slots
                    key = keys[cid, ids]
                    kt = np.where(tt == tt.min(axis=1, keepdims=True),
                                  key[None], NO_KEY)
                    k = kt.argmin(axis=1)
                    r = np.arange(8)
                    got = hit.any(axis=1)
                    cb[q] = tt[r, k]
                    ck[q] = np.where(got, key[k], NO_KEY)
                    cs_[q] = np.where(got, ids[k], 128)
                    cu[q] = np.where(got, u[r, k], 0)
                    cv[q] = np.where(got, v[r, k], 0)
                if any_hit:
                    occ[s] |= (cb < _BIG).any(axis=0)
                else:
                    t_, k_, s_, u_, v_ = _quarter_reduce(cb, ck, cs_, cu, cv)
                    better = (t_ < best_t[s]) | (
                        (t_ == best_t[s]) & (t_ < _BIG) & (k_ < best_key[s]))
                    best_id[s] = np.where(better, begin[cid] + s_, best_id[s])
                    best_u[s] = np.where(better, u_, best_u[s])
                    best_v[s] = np.where(better, v_, best_v[s])
                    best_t[s] = np.where(better, t_, best_t[s])
                    best_key[s] = np.where(better, k_, best_key[s])
                last = (e, cid)
        visits.append(seen)
    out = occ.astype(np.int32) if any_hit else (best_t, best_id, best_u,
                                                best_v)
    return out, visits, lists


def _plain_with_visits(cs, prepared, cull, any_hit):
    """The plain version on prepared rays with the visit log on -> (outputs,
    [cluster ids visited in round k by the rows still running])."""
    tcl.VISIT_LOG = log = []
    try:
        out = trw.any_rows_plain(cs, *prepared) if any_hit else \
            trw.closest_rows_plain(cs, *prepared, cull)
    finally:
        tcl.VISIT_LOG = None
    assert all(lanes == 8 for lanes, _ in log)
    return out, [cid.numpy() for _, cid in log]


def _assert_model_equals_plain(cs, o, d, tmn, tmx, cull, any_hit, sort_rays):
    o, d, tmn, tmx, _, _ = trw.prepare(cs, _t(o), _t(d), _t(tmn), _t(tmx),
                                       sort_rays)
    ref, rounds = _plain_with_visits(cs, (o, d, tmn, tmx), cull, any_hit)
    got, visits, lists = _kernel_model(cs, o.numpy(), d.numpy(), tmn.numpy(),
                                       tmx.numpy(), cull, any_hit)
    # results bit for bit
    if any_hit:
        np.testing.assert_array_equal(got, ref.numpy())
    else:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b.numpy())
    # visits row by row: round k of the lock-step plain walk holds, in row
    # order, the k-th visit of every row that makes more than k visits
    assert len(rounds) == max(map(len, visits))
    for k, cids in enumerate(rounds):
        np.testing.assert_array_equal(
            cids, [v[k] for v in visits if len(v) > k], err_msg=f"round {k}")
    # the candidate lists hold the row table's finite entries, all of them
    table = trw.row_entries(cs.cmin, cs.cmax, o, d, tmn, tmx).numpy()
    for row, lst in enumerate(lists):
        ids = [c for _, c in lst]
        assert ids == np.nonzero(table[row] < 1e30)[0].tolist()
        np.testing.assert_array_equal([e for e, _ in lst], table[row, ids])
    return visits, lists


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("sort_rays", [False, True])
def test_kernel_design_synthetic(synthetic, any_hit, sort_rays):
    """Synthetic set: dead lanes in every row, one all-dead row, and a ragged
    last row (300 rays pad to 384 with dead lanes)."""
    s = synthetic
    tmx = s["tmx"].copy()
    tmx[16:24] = -1.0                       # a whole row of dead lanes
    if any_hit:
        tmx = np.where(tmx < 0, -1.0, 1.5).astype(np.float32)
    visits, lists = _assert_model_equals_plain(
        s["tcs"], s["o"], s["d"], s["tmn"], tmx, True, any_hit, sort_rays)
    assert max(map(len, visits)) > 1 and min(map(len, visits)) == 0
    # the padded rows (origin 0, inside some boxes, tmax -1) may still visit:
    # a dead lane's entry of -1 or less is within the row's bound of -1
    assert len(visits) == 48 and len(lists[-1]) > 0


@pytest.mark.parametrize("rays,cull,any_hit", [
    ("camera", True, False), ("bounce", False, False), ("bounce", True, True),
    ("camera", True, True)])
def test_kernel_design_interior(interior_rays, rays, cull, any_hit):
    o, d, tmx = interior_rays[rays]
    if any_hit:
        tmx = np.where(tmx < 0, -1.0, 2.0).astype(np.float32)
    visits, lists = _assert_model_equals_plain(
        interior_rays["tcs"], o, d, np.full_like(tmx, 1e-3), tmx, cull,
        any_hit, sort_rays=True)
    # the two-level entry phase has something to skip and something to keep
    c = interior_rays["tcs"].num_clusters
    assert 0 < max(map(len, lists)) < c
    assert sum(map(len, visits)) > 0


@pytest.fixture(scope="module")
def tied_clusters():
    """Three hand-made clusters. Clusters 0 and 1 share one box (equal row
    entries: the smaller id goes first) and hold the same two triangles, in
    cluster 1 at other slots and several times (equal t across clusters and
    within a cluster across the four slot quarters: the lower file id
    wins). Cluster 2 lies behind them. No file order is given, so a
    triangle's file id is its id."""
    near = np.array([0, 0, 1, 1, 0, 0, 0, 1, 0], np.float32)     # z = 1
    far = np.array([0, 0, 2, 1, 0, 0, 0, 1, 0], np.float32)      # z = 2
    block = np.zeros((3, 16, 128), np.float32)
    block[0, :9, 0], block[0, :9, 1] = far, near
    for slot in (5, 2, 7, 12):               # quarters 1, 2, 3, 0
        block[1, :9, slot] = near
    block[1, :9, 9] = far
    block[2, :9, 0] = np.array([0, 0, 3, 1, 0, 0, 0, 1, 0], np.float32)
    cmin = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 3]], np.float32)
    cmax = np.array([[1, 1, 2], [1, 1, 2], [1, 1, 3]], np.float32)
    begin = np.array([0, 2, 15], np.int32)
    return tcl.ClusterSet.from_arrays(cmin, cmax, block, begin, 16, "cpu")


def test_kernel_design_ties(tied_clusters):
    cs = tied_clusters
    assert cs.tri_count.tolist() == [2, 13, 1]
    rng = np.random.default_rng(9)
    n = 24
    o = np.concatenate([rng.uniform(0.05, 0.45, (n, 2)),
                        np.zeros((n, 1))], axis=1).astype(np.float32)
    d = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    tmn = np.full(n, 1e-3, np.float32)
    tmx = np.full(n, 1e16, np.float32)
    for any_hit in (False, True):
        visits, lists = _assert_model_equals_plain(cs, o, d, tmn, tmx, False,
                                                   any_hit, sort_rays=False)
        # equal entries: cluster 0 before cluster 1
        assert lists[0][0][0] == lists[0][1][0]
        assert visits[0][0] == 0
    hit = trw.walk_closest(cs, _t(o), _t(d), _t(tmn), _t(tmx), False)
    assert (hit.t.numpy() == 1).all()
    assert (hit.tri.numpy() == 1).all()      # cluster 0's copy: file id 1
    # cluster 1 alone: the lowest file id of the four tied slots
    only1 = tcl.ClusterSet.from_arrays(
        cs.cmin[1:2].numpy(), cs.cmax[1:2].numpy(), cs.tri_block[1:2],
        np.zeros(1, np.int32), 13, "cpu")
    got, _, _ = _kernel_model(only1, o, d, tmn, tmx, False, False)
    ref = trw.closest_rows_plain(only1, _t(o), _t(d), _t(tmn), _t(tmx), False)
    assert (got[1] == 2).all()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b.numpy())
    # a file order in which cluster 1's copy at slot 12 (quarter 0, visited
    # second) comes first in the file: it keeps the hit, on either route
    order = np.arange(16)
    order[[1, 14]] = order[[14, 1]]
    refiled = tcl.ClusterSet.from_arrays(
        cs.cmin.numpy(), cs.cmax.numpy(), cs.tri_block, cs.tri_begin.numpy(),
        16, "cpu", order)
    visits, _ = _assert_model_equals_plain(refiled, o, d, tmn, tmx, False,
                                           False, sort_rays=False)
    assert visits[0][:2] == [0, 1]
    hit = trw.walk_closest(refiled, _t(o), _t(d), _t(tmn), _t(tmx), False)
    assert (hit.t.numpy() == 1).all() and (hit.tri.numpy() == 14).all()


def test_quarter_reduce_picks_smallest_slot_at_smallest_t():
    """The two xor exchanges over the four quarters against a plain argmin,
    on random keys with many equal t: the slot of the lowest file id at the
    smallest t."""
    rng = np.random.default_rng(4)
    for _ in range(50):
        cb = rng.integers(0, 3, (4, 8)).astype(np.float32)
        cs_ = rng.permuted(np.tile(np.arange(32).reshape(8, 4).T, 1), axis=0)
        file = rng.permutation(1000)[:32]
        ck = file[cs_]
        cu = cs_.astype(np.float32) * 0.5
        t, k, s, u, v = _quarter_reduce(cb, ck, cs_, cu, cu + 1)
        want_t = cb.min(axis=0)
        want_k = np.where(cb == want_t, ck, 1 << 20).min(axis=0)
        want_s = np.array([np.nonzero(file == x)[0][0] for x in want_k])
        np.testing.assert_array_equal(t, want_t)
        np.testing.assert_array_equal(k, want_k)
        np.testing.assert_array_equal(s, want_s)
        np.testing.assert_array_equal(u, want_s * 0.5)
        np.testing.assert_array_equal(v, want_s * 0.5 + 1)


@pytest.mark.parametrize("any_hit", [False, True])
def test_slots_below_tri_count_are_enough(synthetic, any_hit):
    """Testing only the slots below a cluster's triangle count equals testing
    all 128: the others are zeros, det = 0, a miss."""
    s = synthetic
    cs = s["tcs"]
    sizes = tcl.cluster_sizes(cs, len(s["tris"][0]))
    np.testing.assert_array_equal(cs.tri_count.numpy(), sizes.numpy())
    assert cs.tri_count.dtype == torch.int32 and (sizes < 128).any()
    assert (cs.tri_slots.numpy()[np.arange(128)[None] >=
                                 cs.tri_count.numpy()[:, None]] == 0).all()
    tmx = np.where(s["tmx"] < 0, -1.0, 1.5).astype(np.float32) if any_hit \
        else s["tmx"]
    prep = trw.prepare(cs, _t(s["o"]), _t(s["d"]), _t(s["tmn"]), _t(tmx),
                       True)[:4]
    args = [a.numpy() for a in prep]
    some, v_some, _ = _kernel_model(cs, *args, True, any_hit)
    full, v_full, _ = _kernel_model(cs, *args, True, any_hit, all_slots=True)
    assert v_some == v_full
    for a, b in zip(np.atleast_2d(some), np.atleast_2d(full)):
        np.testing.assert_array_equal(a, b)


def test_dead_lane_inside_a_box_adds_to_its_row(tied_clusters):
    """A lane with tmax < tmin whose origin lies deep inside a box passes
    the overlap test (entry <= -1 <= tmax), so its row has an entry there;
    the plain table, JAX's and the kernels' list agree. The row's bound is
    -1, so it visits the cluster when the entry is below that."""
    cs = tied_clusters
    big = tcl.ClusterSet.from_arrays(
        np.array([[-4, -4, -4]], np.float32), np.array([[4, 4, 4]], np.float32),
        cs.tri_block[:1], np.zeros(1, np.int32), 2, "cpu")
    o = np.tile(np.array([50, 50, 50], np.float32), (8, 1))
    d = np.tile(np.array([1, 0, 0], np.float32), (8, 1))
    tmn = np.zeros(8, np.float32)
    tmx = np.full(8, 1e16, np.float32)
    o[3], tmx[3] = 0.0, -1.0                 # dead, at the box's centre
    table = trw.row_entries(big.cmin, big.cmax, _t(o), _t(d), _t(tmn),
                            _t(tmx)).numpy()
    assert table.shape == (1, 1) and table[0, 0] == -4.0
    jtable = jrw.row_entries(jnp.asarray(big.cmin.numpy()),
                             jnp.asarray(big.cmax.numpy()), jnp.asarray(o),
                             jnp.asarray(d), jnp.asarray(tmn),
                             jnp.asarray(tmx))
    np.testing.assert_array_equal(np.asarray(jtable), table)
    assert _candidate_list(big, o, d, tmn, tmx) == [(-4.0, 0)]
    # without the dead lane the row reaches nothing
    tmx[3], o[3] = 1e16, 50.0
    assert _candidate_list(big, o, d, tmn, tmx) == []
    # an all-dead row inside the box: bound -1, entry -4, one visit, no hit
    o[:], tmx[:] = 0.0, -1.0
    visits, _ = _assert_model_equals_plain(big, o, d, tmn, tmx, False, False,
                                           sort_rays=False)
    assert visits[0] == [0]


def test_binding_checks_new_arguments(synthetic):
    """Wrong shapes and types of the boxes and triangle counts raise before
    anything is built."""
    cs = synthetic["tcs"]
    cpu, c = torch.device("cpu"), cs.num_clusters
    with pytest.raises(ValueError, match="tri_count: shape"):
        kernels._check_triangles(cs.tri_count[:-1], cs.tri_slots, c, cpu)
    with pytest.raises(TypeError, match="tri_count: dtype"):
        kernels._check_triangles(cs.tri_count.long(), cs.tri_slots, c, cpu)
    with pytest.raises(ValueError, match="tri_slots: shape"):
        kernels._check_triangles(cs.tri_count, cs.tri_slots[:, :64], c, cpu)
    with pytest.raises(ValueError, match="cmax: shape"):
        kernels._check("cmax", cs.cmax[:-1], torch.float32, (c, 3), cpu)
    with pytest.raises(ValueError, match="not contiguous"):
        kernels._check("cmin", cs.cmin.T.contiguous().T, torch.float32,
                       (c, 3), cpu)


def test_plain_route_counts_row_entries(synthetic):
    """The plain route builds the row table once per walk; the counter is
    what shows that the kernels' route never does."""
    s = synthetic
    trw.PLAIN_CALLS["row_entries"] = 0
    args = (s["tcs"], _t(s["o"]), _t(s["d"]), _t(s["tmn"]), _t(s["tmx"]))
    trw.walk_closest(*args, True, sort_rays=True)
    trw.walk_any(*args, sort_rays=False)
    assert trw.PLAIN_CALLS == {"row_entries": 2}


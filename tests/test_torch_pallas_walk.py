"""The port's list walk (ops/pallas_walk: kernel K6's plain versions on CPU
tensors) against the JAX package's Pallas list walk (ops/pallas_walk.py,
all four kernels in interpret mode), on random triangles and on the scale=1
interior, for both cluster sets (K=32, the tile mode's; K=128, the walk
mode's), tiles of 128 and 256 rays, with and without the ray sort, both
cull settings and prune=False, with ray counts that are not a multiple of
the tile and a fifth of the lanes dead.

Tolerances:
  * walk lists: counts and sorted entries exactly (the entry bounds are
    single products, sums and min/max, which XLA does not contract); ids
    exactly except inside runs of equal entries, where the (entry, id)
    pairs must be the same;
  * triangle ids on at least 99.9% of lanes (both run the same Moller-
    Trumbore; a rounding difference could move a tie at a shared edge);
  * t within 1e-5 relative where the ids agree, u and v within 1e-5: XLA's
    CPU compiler contracts the multiply-adds of the interpreted kernels
    into FMAs, torch rounds every product (up to 5.5e-6 relative seen in
    the row walk);
  * occlusion on at least 99.99% of lanes;
  * against the port's brute force (intersect.brute_force_*, the same
    arithmetic) on random triangles: every lane.
The numpy transcriptions of the card's closest and any forms
(tests/tile_designs.py, groups of rays that walk their tile's list and stop
on their own bound; an any-hit ray leaving at its first occluder) are held
to the plain walk bit for bit (np.array_equal), their rounds to the plain
walk's per tile.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import bvh as jbvh
from spcbpt_tpu.ops import clusters as jclusters
from spcbpt_tpu.ops import pallas_walk as jwalk
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu_torch.kernels import list_walk as kernels
from spcbpt_tpu_torch.ops import bvh as tbvh
from spcbpt_tpu_torch.ops import clusters as tclusters
from spcbpt_tpu_torch.ops import intersect as tint
from spcbpt_tpu_torch.ops import pallas_walk
from spcbpt_tpu_torch.ops.pallas_tile import _mt_vpu, _pick
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene import scene as tscene

import tile_designs
from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

N_RAYS = 700          # not a multiple of the 128- or 256-ray tile
TRI_AGREE = 0.999
OCC_AGREE = 0.9999
RTOL, ATOL = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _rays(rs, origins, dirs):
    """N_RAYS rays with tmin 1e-3, tmax 1e16, a fifth of the lanes dead
    (tmax -1), and segment ends in [0.05, 3] for the any hit."""
    tmin = np.full(N_RAYS, 1e-3, np.float32)
    tmax = np.full(N_RAYS, 1e16, np.float32)
    tmax[rs.permutation(N_RAYS)[:N_RAYS // 5]] = -1.0
    seg = np.where(tmax < 0, -1.0, rs.uniform(0.05, 3.0, N_RAYS))
    return dict(rays=(origins.astype(np.float32), dirs.astype(np.float32),
                      tmin, tmax), seg=seg.astype(np.float32))


@pytest.fixture(scope="module")
def random_case():
    """1,200 random triangles in both packages' cluster sets built from one
    BVH (the trees are equal, tests/test_torch_host_modules.py), rays from
    random origins in random directions."""
    rs = np.random.RandomState(0)
    t = 1200
    c = rs.uniform(-5, 5, (t, 3)).astype(np.float32)
    p0 = c + rs.normal(0, 0.3, (t, 3)).astype(np.float32)
    e1 = rs.normal(0, 0.4, (t, 3)).astype(np.float32)
    e2 = rs.normal(0, 0.4, (t, 3)).astype(np.float32)
    flat = tbvh.build_bvh(p0, e1, e2)
    jflat = jbvh.build_bvh(p0, e1, e2)
    np.testing.assert_array_equal(flat.order, jflat.order)
    tris = [a[flat.order] for a in (p0, e1, e2)]
    sets = {
        32: (jclusters.build_clusters(jflat, *tris, max_tris=32),
             tclusters.build_tile_clusters(flat, *tris, max_tris=32)),
        128: (jclusters.build_clusters(jflat, *tris, max_tris=128,
                                       with_coeff=False),
              tclusters.build_clusters(flat, *tris, max_tris=128)),
    }
    o = rs.uniform(-6, 6, (N_RAYS, 3))
    d = rs.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(sets=sets, tris=tuple(map(_t, tris)), **_rays(rs, o, d))


@pytest.fixture(scope="module")
def interior_case(tmp_path_factory):
    """The scale=1 interior (2,264 triangles) in both packages: the K=32 set
    of the tile mode and the K=128 set of the walk mode, one BVH; camera
    rays, then rays from their hits in random directions."""
    path = interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=1)
    jtile, _, cam = jscene.load_trace_scene(path, mode="tile")
    jwalk_ts, _, _ = jscene.load_trace_scene(path, mode="walk")
    ttile, _, _ = tscene.load_trace_scene(path, "cpu", mode="tile")
    twalk, _, _ = tscene.load_trace_scene(path, "cpu", mode="walk")
    assert torch.equal(ttile.tri_p0, twalk.tri_p0)
    cam.aspect = 1.0
    o, d, _ = camera_rays(*cam.uvw(), 24, 24, 0, block=8)
    n_cam = o.shape[0]
    hit = tint.brute_force_closest(o, d, ttile.tri_p0, ttile.tri_e1,
                                   ttile.tri_e2, torch.full((n_cam,), 1e-3),
                                   torch.full((n_cam,), 1e16), False)
    rs = np.random.RandomState(1)
    p_hit = (o + torch.clamp(hit.t, max=10.0)[:, None] * d).numpy()
    nd = rs.normal(size=(n_cam, 3))
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    origins = np.concatenate([o.numpy(), p_hit[rs.permutation(n_cam)]])
    dirs = np.concatenate([d.numpy(), nd])
    sets = {32: (jtile.clusters, ttile.clusters),
            128: (jwalk_ts.clusters_walk, twalk.clusters_walk)}
    return dict(sets=sets, **_rays(rs, origins[:N_RAYS], dirs[:N_RAYS]))


def _cases(request, name):
    return request.getfixturevalue(f"{name}_case")


def _assert_hits_match(got, ref):
    tri, rtri = got.tri.numpy(), np.asarray(ref.tri)
    assert (tri == rtri).mean() >= TRI_AGREE
    same = (tri == rtri) & (tri >= 0)
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(ref.t)[same],
                               rtol=RTOL)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[same],
                                   np.asarray(getattr(ref, f))[same],
                                   rtol=RTOL, atol=ATOL)
    miss = tri < 0
    assert (got.t.numpy()[miss] == np.float32(1e30)).all()
    assert (got.u.numpy()[miss] == 0).all() and (got.v.numpy()[miss] == 0).all()


@pytest.mark.parametrize("name", ["random", "interior"])
@pytest.mark.parametrize("k,tile", [(32, 128), (32, 256), (128, 128),
                                    (128, 256)])
def test_prepare_matches_jax(request, name, k, tile):
    """Padding, per-tile entry bounds, the stable near-to-far sort, counts
    and bases against JAX's `_prepare`."""
    case = _cases(request, name)
    jcs, tcs = case["sets"][k]
    (po, pd, ptn, ptx, n, entries, ids, bases,
     counts) = pallas_walk._prepare(tcs, *map(_t, case["rays"]), tile)
    ref = jwalk._prepare(jcs, *map(_j, case["rays"]), tile)
    jo, jd, jtn, jtx, jn, _, nt, c, jentries, jids, jcounts = ref
    assert n == jn == N_RAYS and entries.shape == (nt, c) == ids.shape
    for a, b in ((po, jo), (pd, jd), (ptn, jtn), (ptx, jtx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (ptx.numpy()[N_RAYS:] == -1).all()
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    e, je = entries.numpy(), np.asarray(jentries)
    np.testing.assert_array_equal(e, je)
    i, ji = ids.numpy(), np.asarray(jids)
    tied = np.zeros_like(e, dtype=bool)
    tied[:, 1:] |= e[:, 1:] == e[:, :-1]
    tied[:, :-1] |= e[:, :-1] == e[:, 1:]
    np.testing.assert_array_equal(i[~tied], ji[~tied])
    for row in range(nt):       # ties: the same (entry, id) pairs
        a = np.lexsort((i[row], e[row]))
        b = np.lexsort((ji[row], je[row]))
        np.testing.assert_array_equal(i[row][a], ji[row][b])
    np.testing.assert_array_equal(
        bases.numpy(), tcs.tri_begin.numpy()[i])
    assert bases.dtype == ids.dtype == counts.dtype == torch.int32
    assert 0 < counts.numpy().mean() <= c


# (k, tile, sort_rays, cull): each value of each option at least twice
_CLOSEST = [(32, 128, False, True), (32, 256, True, False),
            (128, 128, True, True), (128, 256, False, False)]


@pytest.mark.parametrize("vmem_resident", [True, False])
@pytest.mark.parametrize("k,tile,sort_rays,cull", _CLOSEST)
def test_walk_closest_matches_jax(random_case, k, tile, sort_rays, cull,
                                  vmem_resident):
    jcs, tcs = random_case["sets"][k]
    args = random_case["rays"]
    ref = jwalk.walk_closest(jcs, *map(_j, args), cull, tile=tile,
                             sort_rays=sort_rays, interpret=True,
                             vmem_resident=vmem_resident)
    got = pallas_walk.walk_closest(tcs, *map(_t, args), cull, tile=tile,
                                   sort_rays=sort_rays,
                                   vmem_resident=vmem_resident)
    _assert_hits_match(got, ref)
    tri = got.tri.numpy()
    assert (tri[args[3] < 0] == -1).all()          # dead lanes never hit
    assert 0.05 < (tri >= 0).mean() < 0.9


@pytest.mark.parametrize("k,tile,sort_rays,cull",
                         [(32, 256, False, False), (128, 128, True, True)])
def test_walk_closest_interior_matches_jax(interior_case, k, tile, sort_rays,
                                           cull):
    """The resident form on the interior, and the streamed one on the other
    set."""
    jcs, tcs = interior_case["sets"][k]
    args = interior_case["rays"]
    for resident in (k == 128, k == 32):
        ref = jwalk.walk_closest(jcs, *map(_j, args), cull, tile=tile,
                                 sort_rays=sort_rays, interpret=True,
                                 vmem_resident=resident)
        got = pallas_walk.walk_closest(tcs, *map(_t, args), cull, tile=tile,
                                       sort_rays=sort_rays,
                                       vmem_resident=resident)
        _assert_hits_match(got, ref)
    assert (got.tri.numpy() >= 0).mean() > 0.5


@pytest.mark.parametrize("name", ["random", "interior"])
def test_walk_closest_without_prune_matches_jax(request, name):
    """prune=False (resident only) walks every list to its end: JAX's
    prune=False, and the same hits as with pruning."""
    case = _cases(request, name)
    jcs, tcs = case["sets"][128]
    args = case["rays"]
    ref = jwalk.walk_closest(jcs, *map(_j, args), False, tile=128,
                             interpret=True, prune=False)
    got = pallas_walk.walk_closest(tcs, *map(_t, args), False, tile=128,
                                   prune=False)
    _assert_hits_match(got, ref)
    pruned = pallas_walk.walk_closest(tcs, *map(_t, args), False, tile=128)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(pruned, f)), f


@pytest.mark.parametrize("name", ["random", "interior"])
@pytest.mark.parametrize("k,tile,sort_rays,vmem_resident",
                         [(32, 128, False, True), (128, 256, True, False)])
def test_walk_any_matches_jax(request, name, k, tile, sort_rays,
                              vmem_resident):
    case = _cases(request, name)
    jcs, tcs = case["sets"][k]
    o, d, tmin, tmax = case["rays"]
    args = (o, d, tmin, case["seg"])
    ref = np.asarray(jwalk.walk_any(jcs, *map(_j, args), tile=tile,
                                    sort_rays=sort_rays, interpret=True,
                                    vmem_resident=vmem_resident))
    got = pallas_walk.walk_any(tcs, *map(_t, args), tile=tile,
                               sort_rays=sort_rays,
                               vmem_resident=vmem_resident)
    assert got.dtype == torch.bool
    assert (got.numpy() == ref).mean() >= OCC_AGREE
    assert not got.numpy()[tmax < 0].any()
    assert 0.05 < got.numpy().mean() < 0.8


@pytest.mark.parametrize("k", [32, 128])
def test_walks_match_brute_force(random_case, k):
    """Every lane against brute force over all triangles, and the plain
    entry points equal the wrappers on CPU tensors."""
    _, tcs = random_case["sets"][k]
    o, d, tmin, tmax = map(_t, random_case["rays"])
    seg = _t(random_case["seg"])
    tris = random_case["tris"]
    for cull in (True, False):
        ref = tint.brute_force_closest(o, d, *tris, tmin, tmax, cull)
        got = pallas_walk.walk_closest(tcs, o, d, tmin, tmax, cull,
                                       sort_rays=True)
        np.testing.assert_array_equal(got.tri.numpy(), ref.tri.numpy())
        assert torch.equal(got.t, ref.t)
        plain = pallas_walk.walk_closest_plain(tcs, o, d, tmin, tmax, cull,
                                               sort_rays=True)
        assert torch.equal(plain.tri, got.tri) and torch.equal(plain.t, got.t)
    occ = pallas_walk.walk_any(tcs, o, d, tmin, seg, tile=128)
    np.testing.assert_array_equal(
        occ.numpy(), tint.brute_force_any(o, d, *tris, tmin, seg).numpy())
    assert torch.equal(pallas_walk.walk_any_plain(tcs, o, d, tmin, seg,
                                                  tile=128), occ)


def _rounds_per_tile(blocks, prep, cull, any_hit):
    """Rounds each tile walks, one tile at a time (the plain versions run
    all tiles in lock step): the stop rules of pallas_walk.py:142-146
    (closest) and :226-229 (any)."""
    o, d, tmn, tmx, _, entries, ids, bases, counts = prep
    nt, _ = entries.shape
    tile = o.shape[0] // nt
    out = []
    for i in range(nt):
        sl = slice(i * tile, (i + 1) * tile)
        oi, di, tn, tx = o[sl][None], d[sl][None], tmn[sl][None], tmx[sl][None]
        best = torch.full((1, tile), 1e30)
        occ = torch.zeros((1, tile), dtype=torch.bool)
        r = 0
        while r < int(counts[i]):
            blk = blocks[ids[i, r].long()][None]
            if any_hit:
                tt, _, _ = _mt_vpu(oi, di, blk, tn, tx, False)
                occ |= (tt < 1e30).any(dim=2)
                bound = torch.where(occ, -1e30, tx).max()
            else:
                tt, u, v = _mt_vpu(oi, di, blk, tn, torch.minimum(best, tx),
                                   cull)
                t_min = _pick(tt, u, v, 128)[0]
                best = torch.where(t_min < best, t_min, best)
                bound = torch.minimum(best, tx).max()
            r += 1
            if r < int(counts[i]) and entries[i, r] > bound:
                break
        out.append(r)
    return np.array(out)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_stops_like_jax(interior_case, any_hit):
    """The lock-step plain walk visits, round by round, as many tiles as a
    walk of each tile alone with JAX's stop rules; pruning saves rounds."""
    _, tcs = interior_case["sets"][32]
    o, d, tmin, tmax = map(_t, interior_case["rays"])
    prep = pallas_walk._prepare(tcs, o, d, tmin, tmax, 128)
    expected = _rounds_per_tile(tcs.blocks(), prep, True, any_hit)
    counts = prep[-1].numpy()
    assert (expected <= counts).all() and (expected < counts).any()
    log = []
    tclusters.VISIT_LOG = log
    try:
        if any_hit:
            pallas_walk.walk_any(tcs, o, d, tmin, tmax, tile=128)
        else:
            pallas_walk.walk_closest(tcs, o, d, tmin, tmax, True, tile=128)
    finally:
        tclusters.VISIT_LOG = None
    running = [len(cid) for lanes, cid in log]
    assert all(lanes == 128 for lanes, _ in log)
    assert running == [int((expected > r).sum())
                       for r in range(expected.max())]


def test_cpu_tensors_take_plain_versions(random_case):
    """CPU tensors go through the plain versions: no launch is counted."""
    _, tcs = random_case["sets"][128]
    o, d, tmin, tmax = map(_t, random_case["rays"])
    kernels.reset_launches()
    for resident in (True, False):
        pallas_walk.walk_closest(tcs, o, d, tmin, tmax,
                                 vmem_resident=resident)
        pallas_walk.walk_any(tcs, o, d, tmin, tmax, vmem_resident=resident)
    assert kernels.LAUNCHES == {"list_walk_closest": 0,
                                "list_walk_closest_stream": 0,
                                "list_walk_any": 0, "list_walk_any_stream": 0}


def test_streamed_closest_always_prunes(random_case):
    _, tcs = random_case["sets"][128]
    o, d, tmin, tmax = map(_t, random_case["rays"])
    with pytest.raises(ValueError, match="prune=False"):
        pallas_walk.walk_closest(tcs, o, d, tmin, tmax, vmem_resident=False,
                                 prune=False)


def test_kernel_bindings_refuse_cpu_tensors(random_case):
    """No fallback: each binding raises on CPU tensors before anything is
    built or launched."""
    _, tcs = random_case["sets"][128]
    o, d, tmin, tmax = map(_t, random_case["rays"])
    prep = pallas_walk._prepare(tcs, o, d, tmin, tmax, 128)
    po, pd, ptn, ptx, _, entries, ids, bases, counts = prep
    for stream in (False, True):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.closest(tcs.blocks(), tcs.tri_count, counts, ids, bases,
                            entries, po, pd, ptn, ptx, True, True, stream)
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.any_hit(tcs.blocks(), tcs.tri_count, counts, ids, entries,
                            po, pd, ptn, ptx, stream)
    assert not any(kernels.LAUNCHES.values())


def _design_walks(query, cs, prep, cull, prune, group, rec):
    """`query`'s plain walk ("closest" or "any") and the transcription of its
    kernels on prepared rays -> (fields, plain outputs, transcribed outputs,
    the plain walk's hit flags whose mean the caller bounds); the
    transcription's rounds and slots go to `rec`."""
    po, pd, ptn, ptx, n, entries, ids, bases, counts = prep
    blocks = cs.blocks()
    if query == "any":
        ref = pallas_walk.list_walk_any_plain(blocks, counts, ids, entries,
                                              po, pd, ptn, ptx)
        got = tile_designs.group_walk_any(cs, counts, ids, entries, po, pd,
                                          ptn, ptx, group, rec)
        return ("occ",), [ref], [got], ref.numpy()[:n]
    ref = pallas_walk.list_walk_closest_plain(blocks, counts, ids, bases,
                                              entries, po, pd, ptn, ptx,
                                              cull, prune)
    got = tile_designs.group_walk(cs, counts, ids, bases, entries, po, pd,
                                  ptn, ptx, cull, prune, group, rec)
    return ("t", "tri", "u", "v"), ref, got, ref[1].numpy() >= 0


# (k, tile, cull, group, sort_rays, prune) of the closest query: each value
# of k, tile, cull and sort_rays at least twice, the kernels' group of 8
# rays and one ray twice, one thread a ray (32) once, prune=False once
_DESIGN = [(32, 128, True, 1, False, True), (32, 256, False, 8, True, True),
           (128, 128, False, 8, True, True),
           (128, 256, True, 1, False, True),
           (128, 128, True, 32, True, False)]
# (k, tile, group, sort_rays) of the any query (never culled, always
# pruned): each k, tile and sort twice, the any kernels' groups of 1
# (resident) and 4 (streamed) rays twice each, 8 and 32 once
_DESIGN_ANY = [(32, 128, 1, False), (32, 256, 4, True), (128, 128, 8, True),
               (128, 256, 1, False), (128, 128, 32, True),
               (128, 256, 4, False)]
_DESIGN_CASES = [pytest.param("closest", *c, id="-".join(map(str, c)))
                 for c in _DESIGN]
_DESIGN_CASES += [pytest.param("any", k, tile, False, group, sort_rays, True,
                               id=f"any-{k}-{tile}-{group}-{sort_rays}")
                  for k, tile, group, sort_rays in _DESIGN_ANY]
# the hit share of the plain walk that each case must fall in
_HIT_SHARE = {"closest": (0.05, 0.95), "any": (0.02, 0.8)}


@pytest.mark.parametrize("name", ["random", "interior"])
@pytest.mark.parametrize("query,k,tile,cull,group,sort_rays,prune",
                         _DESIGN_CASES)
def test_group_walk_design_matches_plain(request, name, query, k, tile, cull,
                                         group, sort_rays, prune):
    """The kernels' design (groups of `group` rays, 32 / group threads a
    ray, slots below tri_count, each group testing every cluster of its
    tile's list up to its stop and stopping on its own bound) returns the
    plain walk's results bit for bit: closest, its t, tri, u and v; any (a
    ray leaving at its first occluder, on the any segments), its flags. No
    group walks more rounds than its tile, and on the interior some one-ray
    groups walk fewer. A closest group's rays test the slots of every
    cluster it walked; an any group's at most those, and fewer somewhere."""
    case = _cases(request, name)
    _, tcs = case["sets"][k]
    rays = case["rays"] if query == "closest" else (*case["rays"][:3],
                                                    case["seg"])
    prep = pallas_walk.prepare(tcs, *map(_t, rays), tile, sort_rays)[:-1]
    ids, counts = prep[6], prep[8]
    rec = {}
    fields, ref, got, hits = _design_walks(query, tcs, prep, cull, prune,
                                           group, rec)
    for f, a, b in zip(fields, got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    lo, hi = _HIT_SHARE[query]
    assert lo < hits.mean() < hi
    nt = ids.shape[0]
    rounds = rec["rounds"].reshape(nt, tile // group)
    walked = np.cumsum(tcs.tri_count.numpy()[ids.numpy()], axis=1)
    walked = group * np.where(rounds > 0, np.take_along_axis(
        walked, np.maximum(rounds - 1, 0), axis=1), 0)
    slots = rec["slots"].reshape(nt, tile // group)
    if query == "closest":
        assert (slots == walked).all()
    else:
        assert (slots <= walked).all() and (slots < walked).any()
    if prune:
        per_tile = _rounds_per_tile(tcs.blocks(), prep, cull,
                                    query == "any")[:, None]
        assert (rounds <= per_tile).all()
        if name == "interior" and group == 1:
            assert (rounds < per_tile).any()
    else:
        assert (rounds == counts.numpy()[:, None]).all()


def _tie_case():
    """Two 32-ray tiles straight up onto one triangle at t = 2, held three
    times: slots 2 and 7 of cluster 0 and slot 5 of cluster 1 (triangle
    ids 0 + 2, 0 + 7 and 10 + 5); cluster 2 holds a farther triangle. Tile 0
    lists cluster 1 first, tile 1 cluster 0; both lists end at cluster 2,
    whose entry is past the hit. Returns the cluster set (blocks and
    tri_count) and the walk's inputs."""
    f32 = np.float32
    rs = np.random.RandomState(3)
    tri = np.array([[-1, -1, 2], [0, 3, 0], [3, 0, 0]], f32)  # p0, e1, e2
    blocks = np.zeros((3, 16, 128), f32)
    for c, s in ((0, 2), (0, 7), (1, 5)):
        blocks[c, :9, s] = tri.reshape(9)
    blocks[2, :9, 0] = (tri + np.array([[0, 0, 1], [0, 0, 0], [0, 0, 0]],
                                       f32)).reshape(9)
    cs = SimpleNamespace(
        blocks=lambda: _t(blocks), tri_count=_t(np.array([8, 6, 1], np.int32)))
    n = 64
    o = np.zeros((n, 3), f32)
    o[:, :2] = rs.uniform(-0.3, 0.3, (n, 2))
    d = np.tile(np.array([0, 0, 1], f32), (n, 1))
    lists = np.array([[1, 0, 2], [0, 1, 2]], np.int32)
    begin = np.array([0, 10, 20], np.int32)
    walk = dict(counts=np.array([3, 3], np.int32), ids=lists,
                bases=begin[lists],
                entries=np.tile(np.array([1.5, 1.5, 2.5], f32), (2, 1)),
                o=o, d=d, tmn=np.full(n, 1e-3, f32), tmx=np.full(n, 1e16, f32))
    return cs, [_t(a) for a in walk.values()]


@pytest.mark.parametrize("group", [1, 8, 32])
@pytest.mark.parametrize("cull", [True, False])
def test_group_walk_design_ties(group, cull):
    """Equal t bit for bit: the first-listed cluster wins across clusters,
    the smallest slot within one, in the plain walk and the transcription."""
    cs, args = _tie_case()
    ref = pallas_walk.list_walk_closest_plain(cs.blocks(), *args, cull)
    rec = {}
    got = tile_designs.group_walk(cs, *args, cull, True, group, rec)
    want = np.repeat(np.array([15, 2], np.int32), 32)
    for a in (ref, got):
        np.testing.assert_array_equal(a[1].numpy(), want)
        assert (a[0].numpy() == np.float32(2)).all()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (rec["rounds"] == 2).all()
    assert (rec["slots"] == 14 * group).all()


def _any_edge_case():
    """Two tiles of 128 lanes walking three clusters straight up (+z), the
    second tile all padding (count 0). Cluster 0 holds a triangle at z = 1
    over region A in slot 0 and five far ones (tri_count 6), cluster 1 one
    at z = 1.5 over region B, cluster 2 one at z = 3 over both; entries 0.9,
    1.5 and 2.5 bound every lane's hits from below. Tile 0's quarters of 32
    lanes: (0) region A, tmax 4: occluded at round 0; (1) region A, tmax ==
    tmin == 2: never tests a slot, its bound 2 reaches cluster 1; (2) region
    B, tmax 1.5, equal to cluster 1's entry: walks it (t = 1.5 is no hit)
    and stops at cluster 2; (3) 16 dead lanes (tmax -1), then 16 padded
    ones (origin 0, direction x, tmin 0, tmax -1). Returns the cluster set
    and the walk's inputs (counts, ids, entries, o, d, tmn, tmx)."""
    f32 = np.float32
    rs = np.random.RandomState(7)
    blocks = np.zeros((3, 16, 128), f32)

    def put(c, s, z, x0, size):       # p0, e1, e2 of a triangle at height z
        tri = np.array([[x0 - size, -size, z], [3 * size, 0, 0],
                        [0, 3 * size, 0]], f32)
        blocks[c, :9, s] = tri.reshape(9)
    put(0, 0, 1.0, 0.0, 1.0)
    for s in range(1, 6):
        put(0, s, 1.0, 100.0 + 10 * s, 1.0)
    put(1, 0, 1.5, 10.0, 1.0)
    put(2, 0, 3.0, 0.0, 20.0)
    cs = SimpleNamespace(blocks=lambda: _t(blocks),
                         tri_count=_t(np.array([6, 1, 1], np.int32)))
    n = 256
    o = np.zeros((n, 3), f32)
    o[:128, :2] = rs.uniform(-0.3, 0.3, (128, 2))
    o[64:96, 0] += 10.0
    d = np.tile(np.array([0, 0, 1], f32), (n, 1))
    d[112:] = (1, 0, 0)
    o[112:] = 0
    tmn = np.full(n, 1e-3, f32)
    tmx = np.full(n, -1.0, f32)
    tmx[:32] = 4.0
    tmn[32:64] = tmx[32:64] = 2.0
    tmx[64:96] = 1.5
    tmn[112:] = 0.0
    walk = dict(counts=np.array([3, 0], np.int32),
                ids=np.array([[0, 1, 2], [0, 1, 2]], np.int32),
                entries=np.array([[0.9, 1.5, 2.5], [1e30] * 3], f32),
                o=o, d=d, tmn=tmn, tmx=tmx)
    return cs, [_t(a) for a in walk.values()]


@pytest.mark.parametrize("group", [1, 4, 8, 32])
def test_group_walk_any_design_edges(group):
    """The any design on hand-made edges, against the plain walk: a group
    occluded at round 0 walks one position; lanes with tmax == tmin test no
    slot and are never occluded; a group continues on an entry equal to its
    bound; dead, padded and count-0 groups walk nothing. A ray's threads
    leave at their first hit: thread q of slots q, q + S, ... (S = 32 /
    group) against the occluder in slot 0 of 6 makes 6, 6, 5 and 1 tests a
    ray for groups of 1, 4, 8 and 32."""
    cs, args = _any_edge_case()
    ref = pallas_walk.list_walk_any_plain(cs.blocks(), *args)
    rec = {}
    got = tile_designs.group_walk_any(cs, *args, group, rec)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(ref.numpy(), np.repeat([1, 0, 0, 0, 0, 0,
                                                          0, 0], 32))
    lanes_rounds = np.repeat([1, 2, 2, 0, 0, 0, 0, 0], 32)
    lanes_tests = np.repeat([{1: 6, 4: 6, 8: 5, 32: 1}[group], 0, 6 + 1, 0, 0,
                             0, 0, 0], 32)
    np.testing.assert_array_equal(rec["rounds"], lanes_rounds[::group])
    np.testing.assert_array_equal(rec["slots"],
                                  lanes_tests.reshape(-1, group).sum(axis=1))


def _adversarial_case():
    """Hits at small t that round below the ray's own slab entry: 8
    clusters of 12 triangles each in one plane z = 0.5 (every third cluster
    1 ulp above it, every other tilted by 1e-3 through a line of it), so
    faces coincide across clusters and every box is flat or nearly so; 256
    rays from 1e-4 to 0.1 above the plane, grazing it at slopes from 1e-3
    to 1, each aimed at a triangle's vertex (half of them within about 1e-3
    of it). Returns the cluster set and (origins, dirs, tmin, tmax)."""
    f32 = np.float32
    rs = np.random.RandomState(5)
    n_clusters, per, n = 8, 12, 256
    blocks = np.zeros((n_clusters, 16, 128), f32)
    corners = []
    for c in range(n_clusters):
        z = np.nextafter(f32(0.5), f32(1)) if c % 3 == 1 else f32(0.5)
        cx, cy = rs.uniform(-0.6, 0.6, 2).astype(f32)
        v = np.empty((per, 3, 3), f32)
        v[..., 0] = cx + rs.uniform(-0.5, 0.5, (per, 3)).astype(f32)
        v[..., 1] = cy + rs.uniform(-0.5, 0.5, (per, 3)).astype(f32)
        v[..., 2] = z
        if c % 2:
            v[..., 2] = z + (v[..., 1] - cy) * f32(1e-3)
        blocks[c, 0:3, :per] = v[:, 0].T
        blocks[c, 3:6, :per] = (v[:, 1] - v[:, 0]).T
        blocks[c, 6:9, :per] = (v[:, 2] - v[:, 0]).T
        corners.append(v.reshape(-1, 3))
    cs = SimpleNamespace(
        blocks=lambda: _t(blocks),
        tri_count=_t(np.full(n_clusters, per, np.int32)),
        tri_begin=_t(np.arange(n_clusters, dtype=np.int32) * per),
        cmin=_t(np.stack([c.min(axis=0) for c in corners])),
        cmax=_t(np.stack([c.max(axis=0) for c in corners])))
    h = (10.0 ** rs.uniform(-4, -1, n)).astype(f32)
    target = np.concatenate(corners)[rs.randint(0, n_clusters * per * 3, n)]
    target[:n // 2, :2] += rs.normal(0, 1e-3, (n // 2, 2)).astype(f32)
    slope = (10.0 ** rs.uniform(-3, 0, n)).astype(f32)
    ang = rs.uniform(0, 2 * np.pi, n)
    horiz = np.stack([np.cos(ang), np.sin(ang)], 1).astype(f32)
    o = np.empty((n, 3), f32)
    o[:, :2] = target[:, :2] - horiz * (h / slope)[:, None]
    o[:, 2] = target[:, 2] + h
    d = np.concatenate([horiz, -slope[:, None]], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(f32)
    return cs, [_t(a) for a in (o, d, np.full(n, 1e-6, f32),
                                np.full(n, 1e16, f32))]


@pytest.mark.parametrize("group", [1, 8, 32])
@pytest.mark.parametrize("query,cull", [
    pytest.param("closest", True, id="True"),
    pytest.param("closest", False, id="False"),
    pytest.param("any", False, id="any")])
def test_group_walk_design_adversarial_hits(group, query, cull):
    """Grazing, near-vertex hits on faces shared across clusters, at small
    t: some of the plain walk's hits lie below the ray's own entry into its
    cluster's box by more than 2^-16 of t (no skip on a ray's own entry with
    such a margin would be safe), and the design, which skips no cluster
    before its stop, still returns the plain walk's results bit for bit.
    The any query runs with each lane's segment ending just past its
    (unculled) closest hit, np.nextafter(t_hit, inf): the any design keeps
    every such occluder, as the plain walk does."""
    cs, rays = _adversarial_case()
    prep = pallas_walk._prepare(cs, *rays, 128)
    po, pd, ptn, ptx, _, entries, ids, bases, counts = prep
    ref = pallas_walk.list_walk_closest_plain(cs.blocks(), counts, ids, bases,
                                              entries, po, pd, ptn, ptx, cull)
    t, tri = ref[0].numpy(), ref[1].numpy()
    lanes = np.nonzero(tri >= 0)[0]
    assert lanes.size > 128
    o, d, tn, tx = (a.numpy() for a in (po, pd, ptn, ptx))
    own = np.array([tile_designs._group_entries(
        cs, o[i:i + 1], d[i:i + 1], tn[i:i + 1], tx[i:i + 1])[tri[i] // 12]
        for i in lanes])
    assert (own - t[lanes] > t[lanes] * np.float32(2.0 ** -16)).any()
    if query == "any":
        seg = rays[3].clone()
        seg[lanes] = _t(np.nextafter(t[lanes], np.float32(np.inf)))
        prep = pallas_walk._prepare(cs, *rays[:3], seg, 128)
    fields, ref, got, hits = _design_walks(query, cs, prep, cull, True, group,
                                           {})
    assert (hits[lanes] == 1).all()
    for f, a, b in zip(fields, got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)


@pytest.mark.parametrize("name", ["random", "interior"])
def test_slots_past_tri_count_are_zero(request, name):
    """The closest kernels test only the slots below tri_count: in both
    cluster sets every slot at or past it is zero (det = 0, never a hit)."""
    case = _cases(request, name)
    for k in (32, 128):
        _, tcs = case["sets"][k]
        blk = tcs.blocks()[:, :9].numpy()
        count = tcs.tri_count.numpy()
        assert count.dtype == np.int32 and (count > 0).all()
        assert (count <= k).all()
        past = np.arange(blk.shape[-1]) >= count[:, None, None]
        assert not np.where(past, blk, 0).any()

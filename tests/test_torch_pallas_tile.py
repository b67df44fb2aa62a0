"""The port's direct Moller-Trumbore tile walks (ops/pallas_tile: the round
of kernel K4 and the fused walk of kernel K5, plain versions on CPU tensors)
against the JAX package's Pallas kernels of ops/pallas_tile.py in interpret
mode, on the scale=1 interior and on Cornell, both cull settings, with dead
lanes and ray counts that are not a multiple of the tile."""
import importlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu_torch.kernels import tile_walk as kernels
from spcbpt_tpu_torch.ops import clusters as tclusters
from spcbpt_tpu_torch.ops import intersect as tint
from spcbpt_tpu_torch.ops import pallas_tile
from spcbpt_tpu_torch.ops import tile_trace as ttt
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene import scene as tscene

import tile_designs
from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

N_RAYS = 1500        # not a multiple of the 128-ray tile or 1,024 lanes
# t/u/v: XLA's CPU compiler contracts the Moller-Trumbore multiply-adds of
# the interpreted kernels into FMAs, torch rounds every product (measured up
# to 2.7e-7 relative in t, 1e-6 in u/v on the interior); held to 1e-5,
# triangle ids, slots and occlusion exactly.
RTOL, ATOL = 1e-5, 1e-5
# Against brute force (the same arithmetic): an exact tie at an edge shared
# by two clusters goes to the earlier-visited cluster in the walk and to the
# smaller id in brute force.
TRI_AGREE = 0.999


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def pallas_interpret():
    """ops.pallas_tile reloaded with pallas_call forced to interpret mode
    (as tests/test_pallas.py runs the Pallas kernels on the CPU)."""
    from jax.experimental import pallas as pl
    import spcbpt_tpu.ops.pallas_tile as P

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        importlib.reload(P)
        yield P
    finally:
        pl.pallas_call = orig
        importlib.reload(P)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Tile-mode scenes in both packages with N_RAYS rays each: camera rays
    then incoherent rays from their hits, a fifth of the lanes dead, and
    segment ends for the any hit."""
    path = interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=1)
    out = {}
    for name, p in (("interior", path), ("cornell", default_scene_path())):
        jts, _, cam = jscene.load_trace_scene(p, mode="tile")
        cam.aspect = 1.0
        ts = tscene.from_jax_scene(jts, "cpu")
        o, d, _ = camera_rays(*cam.uvw(), 32, 32, 0, block=8)
        hit = tint.brute_force_closest(o, d, ts.tri_p0, ts.tri_e1, ts.tri_e2,
                                       torch.full((1024,), 1e-3),
                                       torch.full((1024,), 1e16), False)
        rng = np.random.default_rng(7)
        p_hit = (o + torch.clamp(hit.t, max=10.0)[:, None] * d).numpy()
        nd = rng.normal(size=(1024, 3)).astype(np.float32)
        nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
        orig = np.concatenate([o.numpy(), p_hit[rng.permutation(1024)]])
        dirs = np.concatenate([d.numpy(), nd])
        orig, dirs = orig[:N_RAYS], dirs[:N_RAYS]
        tmin = np.full(N_RAYS, 1e-3, np.float32)
        tmax = np.full(N_RAYS, 1e16, np.float32)
        tmax[rng.permutation(N_RAYS)[:N_RAYS // 5]] = -1.0
        seg = np.where(tmax < 0, -1.0, rng.uniform(0.05, 3.0, N_RAYS))
        out[name] = dict(jts=jts, ts=ts, rays=(orig, dirs, tmin, tmax),
                         seg=seg.astype(np.float32))
    return out


def _round_inputs(case, r):
    """Round r of the interior's round walk, as ops/tile_trace prepares it:
    (o_t, d_t, tmin_t, tmax_t, cid, run) over the 256-ray tiles."""
    cs = case["ts"].clusters
    o, d, tmin, tmax = map(_t, case["rays"])
    args = ttt._pad_rays(o, d, tmin, tmax, 256)[:4]
    entries_s, ids_s, o_t, d_t, tmin_t, tmax_t, _, _ = ttt._prepare(
        cs, *args, 256)
    run = entries_s[:, r] < 1e30
    return o_t, d_t, tmin_t, tmax_t, ids_s[:, r].contiguous(), run


@pytest.mark.parametrize("cull", [True, False])
def test_mt_round_matches_jax(cases, pallas_interpret, cull):
    """The plain round on gathered blocks against JAX's round kernel."""
    case = cases["interior"]
    cs = case["ts"].clusters
    o_t, d_t, tmin_t, tmax_t, cid, run = _round_inputs(case, 1)
    tris = cs.tri_block[cid.long()]
    got = pallas_tile.mt_round_plain(o_t, d_t, tris, tmin_t, tmax_t, cull)
    ref = pallas_interpret.mt_round(*map(_j, (o_t, d_t, tris, tmin_t,
                                               tmax_t)), cull)
    t, u, v, dn, slot = (a.numpy() for a in got)
    np.testing.assert_array_equal(slot, np.asarray(ref[4]))
    np.testing.assert_array_equal(dn, np.asarray(ref[3]))
    np.testing.assert_allclose(t, np.asarray(ref[0]), rtol=RTOL)
    np.testing.assert_allclose(u, np.asarray(ref[1]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v, np.asarray(ref[2]), rtol=RTOL, atol=ATOL)
    hit = slot < 128
    assert 0.05 < hit.mean() < 0.95 and (t[~hit] == np.float32(1e30)).all()


def test_round_reads_blocks_in_place(cases):
    """K4's plain version: running tiles equal the round on gathered blocks,
    tiles that do not run report a miss."""
    case = cases["interior"]
    cs = case["ts"].clusters
    o_t, d_t, tmin_t, tmax_t, cid, run = _round_inputs(case, 1)
    run[1::2] = False
    got = pallas_tile.mt_round(o_t, d_t, cs.tri_block, cs.tri_count, cid,
                               run, tmin_t, tmax_t, cs.tri_k, False)
    ref = pallas_tile.mt_round_plain(o_t, d_t, cs.tri_block[cid.long()],
                                     tmin_t, tmax_t, False)
    for a, b in zip(got, ref):
        assert torch.equal(a[run], b[run])
    t, u, v, dn, slot = got
    idle = ~run
    assert (t[idle] == 1e30).all() and (slot[idle] == 128).all()
    assert (u[idle] == 0).all() and (v[idle] == 0).all()
    assert (dn == 1).all() and (slot[run] < 128).any()


@pytest.mark.parametrize("name", ["interior", "cornell"])
@pytest.mark.parametrize("cull", [True, False])
def test_pallas_closest_matches_jax(cases, pallas_interpret, name, cull):
    case = cases[name]
    args = case["rays"]
    ref = pallas_interpret.pallas_closest(case["jts"].clusters,
                                          *map(_j, args), cull)
    got = pallas_tile.pallas_closest(case["ts"].clusters, *map(_t, args),
                                     cull)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=RTOL)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   atol=ATOL)
    tri = got.tri.numpy()
    assert (tri[args[3] < 0] == -1).all()          # dead lanes never hit
    assert (tri >= 0).mean() > 0.5


@pytest.mark.parametrize("name", ["interior", "cornell"])
def test_pallas_any_matches_jax(cases, pallas_interpret, name):
    case = cases[name]
    o, d, tmin, _ = case["rays"]
    args = (o, d, tmin, case["seg"])
    ref = pallas_interpret.pallas_any(case["jts"].clusters, *map(_j, args))
    got = pallas_tile.pallas_any(case["ts"].clusters, *map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < got.numpy().mean() < 0.6
    assert not got.numpy()[case["rays"][3] < 0].any()


@pytest.mark.parametrize("sort_rays", [False, True])
def test_pallas_walks_match_brute_force(cases, sort_rays):
    """The fused walk's plain version against the port's brute force, and
    sorted against unsorted (the any hit does not depend on lane order)."""
    case = cases["interior"]
    ts = case["ts"]
    o, d, tmin, tmax = map(_t, case["rays"])
    tris = (ts.tri_p0, ts.tri_e1, ts.tri_e2)
    ref = tint.brute_force_closest(o, d, *tris, tmin, tmax, False)
    got = pallas_tile.pallas_closest(ts.clusters, o, d, tmin, tmax, False,
                                     sort_rays=sort_rays)
    assert (got.tri.numpy() == ref.tri.numpy()).mean() >= TRI_AGREE
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-5)
    seg = _t(case["seg"])
    np.testing.assert_array_equal(
        pallas_tile.pallas_any(ts.clusters, o, d, tmin, seg,
                               sort_rays=sort_rays).numpy(),
        tint.brute_force_any(o, d, *tris, tmin, seg).numpy())


@pytest.mark.parametrize("name", ["interior", "cornell"])
@pytest.mark.parametrize("sort_rays", [False, True])
def test_any_tile_design_matches_plain(cases, name, sort_rays):
    """The transcription of K5 any's walk (tests/tile_designs.py: the set
    streamed in id order a tile-width of clusters at a time), on the rays as
    pallas_any prepares them, equals any_tiles_plain lane for lane; each
    tile's clusters in reach are exactly the finite part of its row of
    tile_trace.tile_entries, ids and entries; each tile visits some of them
    in id order and stops when every lane is occluded or dead or nothing is
    left (_check_any_visits); the plain walk's visits (clusters.VISIT_LOG)
    test whole tiles."""
    case = cases[name]
    cs = case["ts"].clusters
    o, d, tmin, _ = map(_t, case["rays"])
    qo, qd, qtn, qtx, n, _ = pallas_tile.prepare(cs, o, d, tmin,
                                                 _t(case["seg"]), sort_rays)
    rec = {}
    got = tile_designs.any_tile_walk(cs, qo, qd, qtn, qtx, rec)
    log = []
    tclusters.VISIT_LOG = log
    try:
        ref = pallas_tile.any_tiles_plain(cs, qo, qd, qtn, qtx)
    finally:
        tclusters.VISIT_LOG = None
    assert torch.equal(got, ref)
    assert 0.05 < got.numpy()[:n].mean() < 0.6
    rows = ttt.tile_entries(cs, qo, qd, qtn, qtx, pallas_tile.TILE).numpy()
    assert len(rows) == len(rec["lists"])
    for row, (ids, e) in zip(rows, rec["lists"]):
        finite = np.nonzero(row < 1e30)[0]
        np.testing.assert_array_equal(ids, finite)
        np.testing.assert_array_equal(e, row[finite])
    assert all(lanes == pallas_tile.TILE for lanes, _ in log)
    _check_any_visits(rec, got, qtn, qtx)
    assert sum(map(len, rec["visits"])) > 0


def _check_any_visits(rec, got, tmn, tmx) -> int:
    """Each tile's visits in the K5 any transcription's record: clusters in
    reach, none twice (ascending id order within a part); the tile stopped
    because every lane
    ended occluded or dead ("done") or with nothing left to visit ("end");
    its testing lanes took slots where it visited anything and not all its
    lanes are dead. Returns the tiles that stopped "done" before their
    list's end."""
    occ = got.numpy() > 0
    dead = (tmx < tmn).numpy()
    early = 0
    for g, ((ids, _), visited, stop) in enumerate(zip(
            rec["lists"], rec["visits"], rec["stops"])):
        assert set(visited) <= set(ids.tolist())
        assert len(set(visited)) == len(visited)
        sl = slice(pallas_tile.TILE * g, pallas_tile.TILE * (g + 1))
        if stop == "done":
            assert (occ[sl] | dead[sl]).all()
            early += len(visited) < len(ids)
        if rec["slots"][g]:
            assert visited and not dead[sl].all()
    return early


def test_any_tile_design_stops_when_done(cases):
    """K5 any's transcription on the interior's camera rays with their own
    tmax (1e16, a fifth dead): most rays are occluded, so tiles stop before
    the end of their lists, every lane occluded or dead; the flags still
    equal any_tiles_plain's, also with the set in 2 and 3 parts (the
    interior's 105 clusters take one), and the chunk bound and the lanes'
    own tmax keep the walk's tests below the plain walk's."""
    case = cases["interior"]
    cs = case["ts"].clusters
    o, d, tmin, tmax = map(_t, case["rays"])
    n_cam = 1024
    qo, qd, qtn, qtx, n, _ = pallas_tile.prepare(
        cs, o[:n_cam], d[:n_cam], tmin[:n_cam], tmax[:n_cam], True)
    rec = {}
    got = tile_designs.any_tile_walk(cs, qo, qd, qtn, qtx, rec)
    log = []
    tclusters.VISIT_LOG = log
    try:
        ref = pallas_tile.any_tiles_plain(cs, qo, qd, qtn, qtx)
    finally:
        tclusters.VISIT_LOG = None
    assert torch.equal(got, ref)
    assert got.numpy()[:n].mean() > 0.6
    assert _check_any_visits(rec, got, qtn, qtx) > 0
    assert tile_designs.any_parts(cs.num_clusters) == 1
    for parts in (2, 3):
        part_rec = {}
        assert torch.equal(tile_designs.any_tile_walk(
            cs, qo, qd, qtn, qtx, part_rec, parts), ref)
        _check_any_visits(part_rec, got, qtn, qtx)
    sizes = cs.tri_count.numpy()
    plain_tests = sum(lanes * int(sizes[c.numpy()].sum()) for lanes, c in log)
    assert 0 < sum(rec["slots"]) < plain_tests


# K5 closest's groups (kClosestRays of csrc/tile_walk.cu), and the other
# group size that was measured on the card
K5_GROUP = tile_designs.cuda_constant("tile_walk", "kClosestRays")


def _closest_design(cs, rays, cull, group, sort_rays):
    """The transcription of K5 closest on the rays as pallas_closest
    prepares them, and its plain version with the cluster visit log on ->
    (design outputs, plain outputs, the design's record, the plain visits
    of each round, the real lane count)."""
    qo, qd, qtn, qtx, n, _ = pallas_tile.prepare(cs, *map(_t, rays),
                                                 sort_rays)
    rec = {}
    got = tile_designs.closest_tile_walk(cs, qo, qd, qtn, qtx, cull, group,
                                         rec)
    log = []
    tclusters.VISIT_LOG = log
    try:
        ref = pallas_tile.closest_tiles_plain(cs, qo, qd, qtn, qtx, cull)
    finally:
        tclusters.VISIT_LOG = None
    rows = ttt.tile_entries(cs, qo, qd, qtn, qtx, pallas_tile.TILE).numpy()
    assert len(rows) == len(rec["lists"])
    for row, (ids, e) in zip(rows, rec["lists"]):
        finite = np.nonzero(row < 1e30)[0]
        np.testing.assert_array_equal(ids, finite)
        np.testing.assert_array_equal(e, row[finite])
    assert all(lanes == pallas_tile.TILE for lanes, _ in log)
    return got, ref, rec, [cid.tolist() for _, cid in log], n


def _group_stops(rec, group, visits):
    """Each group's rounds beside its tile's (the plain walk's visits, tile
    by tile): asserts that every group's visits are a prefix of its tile's
    plain visit order, and that the tiles' visits are those the longest
    group of each implies. Returns (group rounds, tile rounds), (tiles,
    groups a tile)."""
    order = rec["order"]
    rounds = rec["rounds"].reshape(len(order), pallas_tile.TILE // group)
    reach = rounds.max(axis=1)
    expected = [[int(order[i][r]) for i in range(len(order)) if reach[i] > r]
                for r in range(int(reach.max(initial=0)))]
    assert visits == expected
    return rounds, reach[:, None]


@pytest.mark.parametrize("name", ["interior", "cornell"])
@pytest.mark.parametrize("sort_rays", [False, True])
@pytest.mark.parametrize("cull", [True, False])
def test_closest_tile_design_matches_plain(cases, name, sort_rays, cull):
    """The transcription of K5 closest (tests/tile_designs.py: the prologue
    tile_order, groups of K5_GROUP rays stopping on their own bound,
    slots below tri_count, the lex-min over a ray's threads) equals
    closest_tiles_plain bit for bit in t, tri, u and v, dead and padded
    lanes included; its candidate lists are the finite part of
    tile_trace.tile_entries; each group's visits are a prefix of its tile's
    plain visit order."""
    case = cases[name]
    got, ref, rec, visits, n = _closest_design(case["ts"].clusters,
                                               case["rays"], cull, K5_GROUP,
                                               sort_rays)
    for f, a, b in zip(("t", "tri", "u", "v"), got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    assert 0.3 < (ref[1].numpy()[:n] >= 0).mean() < 0.95
    rounds, tile_rounds = _group_stops(rec, K5_GROUP, visits)
    assert (rounds <= tile_rounds).all()


@pytest.fixture(scope="module")
def random_case():
    """1,200 random triangles and a wall of 2 at x = 2 (y, z in [-1.5,
    1.5], facing -x), in the port's K=32 tile set; 700 rays from [-0.5,
    0.5]^3, a fifth of them dead, every direction in the +x+y+z octant (so
    the tiles' entry bounds stay finite): most run along +x into the wall,
    but the last 8 lanes of each 128-ray tile run along (1, 1, 1), over the
    wall and far into the soup. So a tile that walks on for those rays
    holds groups whose rays all hit near."""
    from spcbpt_tpu_torch.ops import bvh as tbvh
    f32 = np.float32
    rs = np.random.default_rng(5)
    t = 1200
    c = rs.uniform(-5, 5, (t, 3)).astype(f32)
    wall = (np.array([[2, -1.5, -1.5], [2, 1.5, 1.5]], f32),
            np.array([[0, 0, 3], [0, 0, -3]], f32),     # e1 x e2 along -x
            np.array([[0, 3, 0], [0, -3, 0]], f32))
    p0, e1, e2 = (np.concatenate([a, w]) for a, w in zip(
        (c + rs.normal(0, 0.3, (t, 3)).astype(f32),
         rs.normal(0, 0.4, (t, 3)).astype(f32),
         rs.normal(0, 0.4, (t, 3)).astype(f32)), wall))
    flat = tbvh.build_bvh(p0, e1, e2)
    cs = tclusters.build_tile_clusters(
        flat, *(a[flat.order] for a in (p0, e1, e2)), max_tris=32)
    n = 700
    o = rs.uniform(-0.5, 0.5, (n, 3)).astype(f32)
    d = np.ones((n, 3), f32)
    d[:, 1:] = rs.uniform(0.01, 0.15, (n, 2))
    far = np.arange(n) % pallas_tile.TILE >= pallas_tile.TILE - 8
    d[far] = rs.uniform(0.9, 1.1, (int(far.sum()), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, f32)
    tmax = np.full(n, 1e16, f32)
    tmax[rs.permutation(n)[:n // 5]] = -1.0
    return cs, (o, d, tmin, tmax)


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("cull", [True, False])
def test_closest_tile_design_groups_stop_early(random_case, group, cull):
    """On the random soup the design's groups (of 8 and of 32 rays, the two
    sizes measured on the card) still equal the plain walk bit for bit,
    and somewhere a group stops before its tile: a tile walks on for its
    rays that escape while the groups of rays that hit near are done. So
    the groups' own tests (each group's rays times the slots below
    tri_count of the positions it walked: the kernel's rounds output, from
    which chip_smoke.py takes K5 closest's bound) are fewer than the plain
    walk's."""
    cs, rays = random_case
    got, ref, rec, visits, n = _closest_design(cs, rays, cull, group, False)
    for f, a, b in zip(("t", "tri", "u", "v"), got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    assert 0.5 < (ref[1].numpy()[:n] >= 0).mean() < 0.95
    rounds, tile_rounds = _group_stops(rec, group, visits)
    assert (rounds <= tile_rounds).all() and (rounds < tile_rounds).any()
    count = cs.tri_count.numpy().astype(np.int64)
    own = [group * count[rec["order"][g * group // pallas_tile.TILE][:r]].sum()
           for g, r in enumerate(rec["rounds"])]
    np.testing.assert_array_equal(rec["slots"], own)
    plain = sum(pallas_tile.TILE * count[np.array(cids, np.int64)].sum()
                for cids in visits)
    assert rec["slots"].sum() < plain


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("cull", [True, False])
def test_round_design_matches_plain(cases, split, cull):
    """The transcription of K4's single round (slots below tri_count, a
    ray's slots on `split` threads and their lex-min; 1 ships, 2 was
    measured) equals mt_round_blocks_plain in every output, on a round
    where some tiles do not run."""
    case = cases["interior"]
    cs = case["ts"].clusters
    o_t, d_t, tmin_t, tmax_t, cid, run = _round_inputs(case, 1)
    run[::3] = False
    got = tile_designs.round_split(o_t, d_t, cs.tri_block, cs.tri_count, cid,
                                   run, tmin_t, tmax_t, cull, split)
    ref = pallas_tile.mt_round_blocks_plain(o_t, d_t, cs.tri_block,
                                            cs.tri_count, cid, run, tmin_t,
                                            tmax_t, cs.tri_k, cull)
    for f, a, b in zip(("t", "u", "v", "dn", "slot"), got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    hit = ref[4].numpy() < 128
    assert 0.05 < hit.mean() < 0.95 and not hit[~run.numpy()].any()


def test_walk_closest_refuses_too_many_clusters(cases):
    """K5 closest keeps its tile's list in shared memory: a set of more
    than MAX_CLOSEST_CLUSTERS clusters raises before anything is built."""
    c = kernels.MAX_CLOSEST_CLUSTERS + 1
    o = torch.zeros((128, 3))
    t = torch.zeros((128,))
    blocks = torch.zeros((1, 16, 128)).expand(c, 16, 128)
    boxes = torch.zeros((1, 3)).expand(c, 3)
    ints = torch.zeros((1,), dtype=torch.int32).expand(c)
    with pytest.raises(ValueError, match="clusters outside"):
        kernels.walk_closest(o, o, t, t, boxes, boxes, ints, blocks, ints,
                             True)
    assert not any(kernels.LAUNCHES.values())


def test_cpu_tensors_take_plain_versions(cases):
    """CPU tensors go through the plain versions: no launch is counted, and
    the scene's CPU route never reaches the fused walk."""
    case = cases["cornell"]
    cs = case["ts"].clusters
    o, d, tmin, tmax = map(_t, case["rays"])
    kernels.reset_launches()
    pallas_tile.pallas_closest(cs, o, d, tmin, tmax)
    pallas_tile.pallas_any(cs, o, d, tmin, _t(case["seg"]))
    ttt.tile_closest(cs, o, d, tmin, tmax, tile=256, use_kernel=True)
    assert kernels.LAUNCHES == {"tile_round_walk": 0, "tile_round": 0,
                                "tile_walk_closest": 0, "tile_walk_any": 0}


def test_kernel_bindings_refuse_cpu_tensors(cases):
    """No fallback: each binding raises on CPU tensors before anything is
    built or launched."""
    cs = cases["cornell"]["ts"].clusters
    o = torch.zeros((128, 3))
    t = torch.zeros((128,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.walk_closest(o, o, t, t, cs.cmin, cs.cmax, cs.tri_begin,
                             cs.tri_block, cs.tri_count, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.walk_any(o, o, t, t, cs.cmin, cs.cmax, cs.tri_block,
                         cs.tri_count, cs.tri_k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.tile_round(o[None], o[None], t[None], t[None],
                           torch.zeros((1,), dtype=torch.int32),
                           torch.ones((1,), dtype=torch.bool), cs.tri_block,
                           cs.tri_count, cs.tri_k, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.round_walk(o[None], o[None], t[None], t[None],
                           torch.zeros((1, cs.num_clusters)),
                           torch.zeros((1, cs.num_clusters),
                                       dtype=torch.int32),
                           cs.tri_block, cs.tri_begin, cs.tri_count,
                           cs.tri_k, True)
    assert not any(kernels.LAUNCHES.values())


def test_tile_kernel_module_imports_without_nvcc():
    """Importing the tile modules builds nothing (no nvcc here)."""
    code = ("import spcbpt_tpu_torch.kernels.tile_walk as k, "
            "spcbpt_tpu_torch.kernels.build as b, "
            "spcbpt_tpu_torch.ops.pallas_tile; "
            "assert not b._LIBS and not b.BUILD_LOG; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_HOME": "/none",
                              "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

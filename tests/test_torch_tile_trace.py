"""The port's tile mode (ops/tile_trace, the tile cluster set, the scene's
`tile` routes) against the JAX package on the same numpy-seeded rays: the
scale=1 interior (2,264 triangles, 105 clusters of at most 32) and Cornell.

The matmul walk (use_kernel=False) is the JAX tile mode's CPU path; the
round walk (use_kernel=True) runs kernel K4's plain version here, held
against JAX's Pallas round kernel in interpret mode. The CUDA kernels run
only on the card (chip_smoke.py)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import tile_trace as jtt
from spcbpt_tpu.render import pt_pool as jpool
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.parser import load_scene
from spcbpt_tpu_torch.kernels import tile_walk as kernels
from spcbpt_tpu_torch.ops import bvh as tbvh
from spcbpt_tpu_torch.ops import clusters as tclusters
from spcbpt_tpu_torch.ops import intersect as tint
from spcbpt_tpu_torch.ops import tile_trace as ttt
from spcbpt_tpu_torch.render import pt_pool as tpool
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene import scene as tscene

import tile_designs
from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

N_RAYS = 2000        # not a multiple of the 256-ray tile: padded lanes
TILE = 256           # the scene's TILE_LANES
# The matmul walk: torch's float32 batched product and XLA's agree on these
# 16-term sums; t/u/v are held to 1e-6 relative (1e-6 absolute for u/v,
# which pass through 0) and triangle ids exactly.
RTOL_MM, ATOL_MM = 1e-6, 1e-6
# The round walk: XLA's CPU compiler contracts the Moller-Trumbore
# multiply-adds of the interpreted Pallas kernel into FMAs, torch rounds
# every product: measured up to 2.7e-7 relative in t and 1e-6 in u/v here;
# held to 1e-5 (the bound of the row walk's tests), triangle ids exactly.
RTOL_MT, ATOL_MT = 1e-5, 1e-5
# Against brute force, t agrees on every lane (1e-5 relative) and triangle
# ids on a share of them. The round walk runs brute force's arithmetic: an
# exact tie at an edge shared by two clusters goes to the earlier-visited
# cluster in the walk and to the smaller id in brute force. The matmul walk
# tests edges on the numerators (another rounding), so at a shared edge or
# vertex it may take the neighbour: measured 22 of 2,000 lanes (all bounce
# rays, equal t), so its bound is 2%. Its t = t_num / det, with t_num =
# o.n - p0.n from the feature product, loses absolute precision to that
# cancellation: measured 3.4e-6 absolute on short bounce hits, held to 1e-5.
TRI_AGREE = {True: 0.999, False: 0.98}   # by use_kernel
T_ATOL = {True: 0.0, False: 1e-5}
# PT render, port against JAX on the same seeds: the same walk and the same
# estimator, so the image means agree to float rounding of the shading.
PT_MEAN_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def interior_path(tmp_path_factory):
    return interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=1)


@pytest.fixture(scope="module")
def case(interior_path):
    """The tile-mode interior in both packages and N_RAYS rays: camera rays
    and incoherent bounce rays from their hits, a fifth of the lanes dead."""
    jts, _, cam = jscene.load_trace_scene(interior_path, mode="tile")
    cam.aspect = 1.0
    ts = tscene.from_jax_scene(jts, "cpu")
    o, d, _ = camera_rays(*cam.uvw(), 32, 32, 0, block=8)
    hit = tint.brute_force_closest(o, d, ts.tri_p0, ts.tri_e1, ts.tri_e2,
                                   torch.full((1024,), 1e-3),
                                   torch.full((1024,), 1e16), False)
    rng = np.random.default_rng(5)
    p = (o + hit.t[:, None] * d).numpy()
    nd = rng.normal(size=(1024, 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
    perm = rng.permutation(1024)
    orig = np.concatenate([o.numpy(), p[perm]])[:N_RAYS]
    dirs = np.concatenate([d.numpy(), nd])[:N_RAYS]
    tmin = np.full(N_RAYS, 1e-3, np.float32)
    tmax = np.full(N_RAYS, 1e16, np.float32)
    tmax[rng.permutation(N_RAYS)[:N_RAYS // 5]] = -1.0
    seg = np.where(tmax < 0, -1.0, rng.uniform(0.05, 3.0, N_RAYS))
    return dict(jts=jts, ts=ts, uvw=cam.uvw(), rays=(orig, dirs, tmin, tmax),
                seg=seg.astype(np.float32))


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


def _assert_hits(got, ref, rtol, atol):
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=rtol)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("name", ["interior", "cornell"])
@pytest.mark.parametrize("route", ["build_scene", "from_jax_scene"])
def test_tile_set_matches_jax(interior_path, name, route):
    """The K=32 tile set equals JAX's array for array, built by the port or
    carried over."""
    path = interior_path if name == "interior" else default_scene_path()
    jts = jscene.build_scene(load_scene(path), mode="tile")
    ts = (tscene.build_scene(load_scene(path), "cpu", mode="tile")
          if route == "build_scene" else tscene.from_jax_scene(jts, "cpu"))
    assert ts.mode == "tile" and ts.clusters_walk is None
    cs, jcs = ts.clusters, jts.clusters
    assert cs.tri_k == jcs.tri_k == tscene.CLUSTER_TRI_K
    for f in ("cmin", "cmax", "tri_begin", "coeff", "tri_block"):
        np.testing.assert_array_equal(getattr(cs, f).numpy(),
                                      np.asarray(getattr(jcs, f)), err_msg=f)
    np.testing.assert_array_equal(ts.tri_p0.numpy(), np.asarray(jts.tri_p0))
    if name == "interior":
        assert cs.num_clusters == 105 and ts.num_tris == 2264


@pytest.mark.parametrize("tile", [256, 128, 64])
def test_tile_entries_matches_jax(case, tile):
    o, d, tmin, tmax = case["rays"]
    args = ttt._pad_rays(_t(o), _t(d), _t(tmin), _t(tmax), tile)[:4]
    got = ttt.tile_entries(case["ts"].clusters, *args, tile)
    ref = jtt.tile_entries(case["jts"].clusters, *map(_j, args), tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ((got < 1e30).float().mean() > 0.05) and (got == 1e30).any()


def _closest_pair(case, cull, sort_rays, use_kernel):
    o, d, tmin, tmax = case["rays"]
    ref = jtt.tile_closest(case["jts"].clusters, *map(_j, (o, d, tmin, tmax)),
                           cull, tile=TILE, use_kernel=use_kernel,
                           sort_rays=sort_rays)
    got = ttt.tile_closest(case["ts"].clusters, *map(_t, (o, d, tmin, tmax)),
                           cull, tile=TILE, use_kernel=use_kernel,
                           sort_rays=sort_rays)
    return got, ref


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("sort_rays", [False, True])
def test_closest_matmul_walk_matches_jax(case, cull, sort_rays):
    got, ref = _closest_pair(case, cull, sort_rays, use_kernel=False)
    _assert_hits(got, ref, RTOL_MM, ATOL_MM)
    tri = got.tri.numpy()
    assert 0.6 < (tri >= 0).mean() < 0.8           # a fifth dead, few misses
    assert (tri[case["rays"][3] < 0] == -1).all()  # dead lanes never hit


@pytest.mark.parametrize("cull,sort_rays", [(True, False), (False, True)])
def test_closest_round_walk_matches_jax_interpret(case, pallas_interpret,
                                                  cull, sort_rays):
    """use_kernel=True: the port's round walk through K4's plain version
    against JAX's round walk through its Pallas kernel in interpret mode."""
    got, ref = _closest_pair(case, cull, sort_rays, use_kernel=True)
    _assert_hits(got, ref, RTOL_MT, ATOL_MT)


@pytest.mark.parametrize("sort_rays", [False, True])
def test_any_matmul_walk_matches_jax(case, sort_rays):
    o, d, tmin, _ = case["rays"]
    args = (o, d, tmin, case["seg"])
    ref = jtt.tile_any(case["jts"].clusters, *map(_j, args), tile=TILE,
                       sort_rays=sort_rays)
    got = ttt.tile_any(case["ts"].clusters, *map(_t, args), tile=TILE,
                       sort_rays=sort_rays)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.1 < got.numpy().mean() < 0.5


@pytest.mark.parametrize("use_kernel", [False, True])
def test_walks_match_brute_force(case, use_kernel):
    """Both walks against the port's brute force (the oracle)."""
    ts = case["ts"]
    o, d, tmin, tmax = map(_t, case["rays"])
    tris = (ts.tri_p0, ts.tri_e1, ts.tri_e2)
    ref = tint.brute_force_closest(o, d, *tris, tmin, tmax, False)
    got = ttt.tile_closest(ts.clusters, o, d, tmin, tmax, False, tile=TILE,
                           use_kernel=use_kernel, sort_rays=True)
    same = got.tri.numpy() == ref.tri.numpy()
    assert same.mean() >= TRI_AGREE[use_kernel]
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-5,
                               atol=T_ATOL[use_kernel])
    seg = _t(case["seg"])
    np.testing.assert_array_equal(
        ttt.tile_any(ts.clusters, o, d, tmin, seg, tile=TILE).numpy(),
        tint.brute_force_any(o, d, *tris, tmin, seg).numpy())


def test_matmul_walk_refuses_other_devices(case):
    """The matmul walk is a CPU plain version: a tensor elsewhere (here the
    meta device stands in for the card) raises before any work."""
    cs = case["ts"].clusters
    o = torch.zeros((256, 3), device="meta")
    t = torch.zeros((256,), device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        ttt.tile_closest(cs, o, o, t, t, use_kernel=False)
    with pytest.raises(ValueError, match="CPU tensors"):
        ttt.tile_any(cs, o, o, t, t)


def test_scene_tile_mode_routes(case, monkeypatch):
    """On CPU tensors the tile mode's trace API goes where JAX's does: the
    matmul walk for closest and any hit, 256-ray tiles, sorted rays."""
    ts = case["ts"]
    calls = []

    def spy(name):
        fn = getattr(ttt, name)

        def wrapped(*a, **k):
            calls.append((name, k.get("tile"), k.get("use_kernel"),
                          k.get("sort_rays")))
            return fn(*a, **k)
        monkeypatch.setattr(ttt, name, wrapped)

    spy("tile_closest")
    spy("tile_any")
    o, d = (_t(a[:512]) for a in case["rays"][:2])
    hit = tscene.trace_closest(ts, o, d, 1e-3, 1e16, True)
    vis = tscene.visibility(ts, o, o + 2.0 * d)
    assert calls == [("tile_closest", TILE, False, True),
                     ("tile_any", TILE, None, True)]
    assert (hit.tri >= 0).any() and vis.dtype == torch.bool


def test_pt_pool_tile_mode_matches_jax(case):
    """A 16x16, 2 spp PT render of the tile-mode interior, port against JAX
    on the same seeds: counts exact, means within PT_MEAN_RTOL."""
    jts, ts = case["jts"], case["ts"]
    eye, U, V, W = case["uvw"]
    jf, jc = jpool.render_pool_jit(jts, eye, U, V, W, 16, 16, 2, 0,
                                   max_depth=8)
    tf, tc = tpool.render_pool(ts, (eye, U, V, W), 16, 16, 2, 0, max_depth=8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and b.mean() > 0
    assert abs(a.mean() - b.mean()) <= PT_MEAN_RTOL * b.mean()


# ---------------------------------------------------------------------------
# kernel K4's round walk (csrc/tile_walk.cu round_walk_kernel), transcribed
# in tests/tile_designs.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def random_tile_case():
    """1,200 random triangles in the port's K=32 tile set, 700 rays (padded
    to 768 lanes) from random origins in random directions, a fifth dead."""
    rs = np.random.default_rng(3)
    t = 1200
    c = rs.uniform(-5, 5, (t, 3)).astype(np.float32)
    p0 = c + rs.normal(0, 0.3, (t, 3)).astype(np.float32)
    e1 = rs.normal(0, 0.4, (t, 3)).astype(np.float32)
    e2 = rs.normal(0, 0.4, (t, 3)).astype(np.float32)
    flat = tbvh.build_bvh(p0, e1, e2)
    cs = tclusters.build_tile_clusters(
        flat, *(a[flat.order] for a in (p0, e1, e2)), max_tris=32)
    n = 700
    o = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[rs.permutation(n)[:n // 5]] = -1.0
    return cs, (o, d, tmin, tmax)


@pytest.mark.parametrize("name", ["interior", "random"])
@pytest.mark.parametrize("cull", [True, False])
def test_k4_walk_design_matches_plain(case, random_tile_case, name, cull):
    """The transcription of K4's whole walk, through the wrapper's own
    sort, pad, prepare and unsort, equals tile_closest_plain (the host loop
    over the plain round) bit for bit in t, tri, u and v, dead and padded
    lanes included; and its per-tile round counts, tile by tile, are the
    host loop's visits of clusters.VISIT_LOG, bucket by bucket."""
    if name == "interior":
        cs, rays = case["ts"].clusters, case["rays"]
    else:
        cs, rays = random_tile_case
    args = tuple(map(_t, rays))
    log = []
    tclusters.VISIT_LOG = log
    try:
        ref = ttt.tile_closest_plain(cs, *args, cull, tile=TILE,
                                     sort_rays=True)
    finally:
        tclusters.VISIT_LOG = None
    rec = {}
    got = ttt._hit(*ttt._walk(cs, *args, TILE, True,
                              tile_designs.k4_walk(cull, rec)))
    ids, rounds = rec["ids"], rec["rounds"]
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert (got.tri.numpy()[rays[3] < 0] == -1).all()
    assert 0.1 < (got.tri.numpy() >= 0).mean() < 0.95
    # the visits: round r of a bucket tests the tiles (in tile order) whose
    # walk is longer than r, against their r-th cluster
    expected, pos = [], 0
    for size in ttt._bucket_sizes(len(rounds)):
        tiles = np.arange(pos, pos + size)
        per = np.array(rounds[pos:pos + size])
        for r in range(per.max()):
            expected.append(ids[tiles[per > r], r].tolist())
        pos += size
    logged = [cid.tolist() for lanes, cid in log if len(cid)]
    assert all(lanes == TILE for lanes, _ in log)
    assert logged == expected
    assert sum(rounds) == sum(map(len, logged)) and max(rounds) > 1


def test_round_walk_binding_refuses_cpu_tensors(case):
    """No fallback: K4's walk binding raises on CPU tensors (before anything
    is built or launched), and tile_closest(use_kernel=True) takes the host
    loop over the plain round on CPU tensors: no launch is counted."""
    cs = case["ts"].clusters
    o = torch.zeros((1, TILE, 3))
    t = torch.zeros((1, TILE))
    e = torch.zeros((1, cs.num_clusters))
    i = torch.zeros((1, cs.num_clusters), dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.round_walk(o, o, t, t, e, i, cs.tri_block, cs.tri_begin,
                           cs.tri_count, cs.tri_k, True)
    o, d, tmin, tmax = map(_t, case["rays"])
    ttt.reset_walk_stats()
    ttt.tile_closest(cs, o, d, tmin, tmax, tile=TILE, use_kernel=True)
    assert not any(kernels.LAUNCHES.values())
    assert ttt.WALK_STATS["walks"] == 1 and ttt.WALK_STATS["syncs"] > 0

"""The fused tile walk (ops/pallas_tile, kernel K5's plain versions on CPU
tensors) over a tile set split into parts (ops/clusters.ClusterParts of
near-equal ranges, clusters.even_bounds),
against the JAX package's tile mode on the same numpy-seeded rays: the
scale-4 interior (32,576 triangles, 1,370 clusters of at most 32) cut into
parts of at most MAX_CLUSTERS clusters, so that a small scene takes the
route a scene above the clusters one K5 closest block holds takes on the
card (K5 any takes any set whole there; its parts route stays for a given
max_clusters and gives the whole set's flags). Where triangles of two
parts meet a ray at the same t, the parts take the hit the whole set's
walk takes (a hand-made pair of clusters against JAX's whole-set Pallas
walk in interpret mode).

JAX's references are its tile mode's own any hit, the matmul walk
(tile_trace.tile_any), and its round walk of the closest hit
(tile_trace.tile_closest with use_kernel=True, its Pallas round kernel in
interpret mode), whose direct Moller-Trumbore the fused walk shares; the
single-set fused walk is the port's route below the ceiling. The CUDA
kernels run only on the card (chip_smoke.py)."""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import clusters as jclusters
from spcbpt_tpu.ops import tile_trace as jtt
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu_torch.kernels import tile_walk as kernels
from spcbpt_tpu_torch.ops import clusters as tclusters
from spcbpt_tpu_torch.ops import intersect as tint
from spcbpt_tpu_torch.ops import pallas_tile
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene import scene as tscene

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

N_RAYS = 2000        # camera rays, then bounce rays from their hits
MAX_CLUSTERS = 64    # 22 parts of the interior's 1,370 clusters
TILE = 256           # JAX's tile mode (the scene's TILE_LANES)
# Against JAX's round walk, closest hit: the same arithmetic, but XLA's CPU
# compiler contracts the interpreted kernel's multiply-adds into FMAs, and
# an exact tie at an edge shared by two clusters goes to the earlier of
# each walk's visit orders; triangles agree on TRI_AGREE of the lanes, t
# to T_RTOL where they agree (RTOL_MT of tests/test_torch_tile_trace.py).
# Occlusion against the matmul walk: every lane.
TRI_AGREE = 0.999
T_RTOL = 1e-5
LAUNCH_RAYS = 256    # rays of the launch-count test
# the scale-14 interior's tile clusters (above MAX_CLOSEST_CLUSTERS), as a
# set of that size on the meta device
SCALE14_CLUSTERS = 17_197


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def pallas_interpret():
    """spcbpt_tpu.ops.pallas_tile reloaded with pallas_call forced to
    interpret mode (as tests/test_pallas.py runs the Pallas kernels on the
    CPU); JAX's tile_trace calls it through the module."""
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
def case(tmp_path_factory):
    """The tile-mode interior at scale 4 in both packages, N_RAYS rays (a
    32x32 camera wavefront, then incoherent rays from its hits), a fifth
    of the lanes dead, and segment ends for the any hit."""
    path = interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=4)
    jts, _, cam = jscene.load_trace_scene(path, mode="tile")
    cam.aspect = 1.0
    ts = tscene.from_jax_scene(jts, "cpu")
    o, d, _ = camera_rays(*cam.uvw(), 32, 32, 0, block=8)
    hit = tint.brute_force_closest(o, d, ts.tri_p0, ts.tri_e1, ts.tri_e2,
                                   torch.full((1024,), 1e-3),
                                   torch.full((1024,), 1e16), False)
    rng = np.random.default_rng(11)
    p = (o + torch.clamp(hit.t, max=10.0)[:, None] * d).numpy()
    nd = rng.normal(size=(1024, 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
    orig = np.concatenate([o.numpy(), p[rng.permutation(1024)]])[:N_RAYS]
    dirs = np.concatenate([d.numpy(), nd])[:N_RAYS]
    tmin = np.full(N_RAYS, 1e-3, np.float32)
    tmax = np.full(N_RAYS, 1e16, np.float32)
    tmax[rng.permutation(N_RAYS)[:N_RAYS // 5]] = -1.0
    seg = np.where(tmax < 0, -1.0, rng.uniform(0.05, 3.0, N_RAYS))
    return dict(jts=jts, ts=ts, rays=(orig, dirs, tmin, tmax),
                seg=seg.astype(np.float32))


@pytest.fixture(scope="module")
def walks(case):
    """walks(kind, cull, max_clusters): the plain fused walk of `kind`
    ("closest", or "any" on the segments) over the case's rays, sorted, as
    pallas_tile takes the set at max_clusters (None: the single set); each
    computed once for the module."""
    cs = case["ts"].clusters
    o, d, tmin, tmax = map(_t, case["rays"])
    seg = _t(case["seg"])
    memo = {}

    def run(kind, cull, max_clusters):
        key = (kind, cull, max_clusters)
        if key not in memo:
            memo[key] = (
                pallas_tile.pallas_closest_plain(
                    cs, o, d, tmin, tmax, cull, sort_rays=True,
                    max_clusters=max_clusters) if kind == "closest"
                else pallas_tile.pallas_any_plain(
                    cs, o, d, tmin, seg, sort_rays=True,
                    max_clusters=max_clusters))
        return memo[key]
    return run


@pytest.mark.parametrize("max_clusters", [1, 64, 100, 1369, 1370, 4096])
def test_split_covers_every_cluster_once(case, max_clusters):
    """The fewest near-equal contiguous ranges of at most max_clusters,
    in order, covering every cluster once; each part is a tile set whose
    arrays are views of the whole set's, tri_begin the global triangle id.
    The fused walk takes the whole set itself up to max_clusters."""
    cs = case["ts"].clusters
    c = cs.num_clusters
    parts = tclusters.ClusterParts.split(
        cs, tclusters.even_bounds(c, max_clusters))
    if c <= max_clusters:
        assert pallas_tile.split(cs, max_clusters) is cs
    else:
        assert pallas_tile.split(cs, max_clusters).bounds == parts.bounds
    sizes = [b - a for a, b in parts.bounds]
    assert len(parts.parts) == -(-c // max_clusters)
    assert parts.bounds[0][0] == 0 and parts.bounds[-1][1] == c
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(parts.bounds,
                                                    parts.bounds[1:]))
    assert max(sizes) <= max_clusters and max(sizes) - min(sizes) <= 1
    assert parts.num_clusters == c and parts.cmin is cs.cmin
    for (a, b), p in zip(parts.bounds, parts.parts):
        assert isinstance(p, tclusters.TileClusterSet)
        assert p.num_clusters == b - a and p.tri_k == cs.tri_k
        for f in ("cmin", "cmax", "coeff", "tri_block", "tri_begin",
                  "tri_count"):
            part, whole = getattr(p, f), getattr(cs, f)
            assert part.data_ptr() == whole[a:].data_ptr(), f
            assert torch.equal(part, whole[a:b]), f
    with pytest.raises(ValueError, match="max_clusters"):
        tclusters.even_bounds(c, 0)


def test_any_over_parts_matches_jax(case, walks):
    """pallas_any_plain over parts of at most MAX_CLUSTERS clusters equals
    JAX's tile_any (the tile mode's matmul walk) on every lane."""
    cs = case["ts"].clusters
    o, d, tmin, _ = case["rays"]
    args = (o, d, tmin, case["seg"])
    assert len(pallas_tile.split(cs, MAX_CLUSTERS).parts) >= 3
    got = walks("any", False, MAX_CLUSTERS)
    ref = jtt.tile_any(case["jts"].clusters, *map(_j, args), tile=TILE,
                       sort_rays=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.1 < got.numpy().mean() < 0.6
    assert not got.numpy()[case["rays"][3] < 0].any()


@pytest.mark.parametrize("cull", [True, False])
def test_closest_over_parts_matches_jax(case, walks, pallas_interpret,
                                        cull):
    """pallas_closest_plain over the same parts against JAX's tile_closest
    (its round walk): triangles on TRI_AGREE of the lanes, t to T_RTOL
    where they agree."""
    o, d, tmin, tmax = case["rays"]
    got = walks("closest", cull, MAX_CLUSTERS)
    ref = jtt.tile_closest(case["jts"].clusters, *map(_j, (o, d, tmin, tmax)),
                           cull, tile=TILE, use_kernel=True, sort_rays=True)
    ref_tri, ref_t = np.asarray(ref.tri), np.asarray(ref.t)
    same = got.tri.numpy() == ref_tri
    assert same.mean() >= TRI_AGREE, same.mean()
    np.testing.assert_allclose(got.t.numpy()[same], ref_t[same], rtol=T_RTOL)
    tri = got.tri.numpy()
    assert 0.6 < (tri >= 0).mean() < 0.8 and (tri[tmax < 0] == -1).all()


@pytest.mark.parametrize("cull", [True, False])
def test_parts_route_matches_single_set(walks, cull):
    """The parts route against the single-set route (one walk over all
    1,370 clusters, as K5 takes them below its ceiling): occlusion and the
    closest hits (t, tri, u, v) bit for bit."""
    assert torch.equal(walks("any", False, MAX_CLUSTERS),
                       walks("any", False, None))
    parts, whole = (walks("closest", cull, m) for m in (MAX_CLUSTERS, None))
    for f in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(parts, f), getattr(whole, f)), f


@pytest.mark.parametrize("max_clusters", [100, 500, 1369, 1370])
def test_any_at_every_max_clusters_gives_whole_flags(walks, case,
                                                     max_clusters):
    """pallas_any_plain over parts of at most max_clusters clusters (or
    the whole set at 1,370) gives the whole set's flags, bit for bit."""
    cs = case["ts"].clusters
    got = walks("any", False, max_clusters)
    assert torch.equal(got, walks("any", False, None))
    assert isinstance(pallas_tile.split(cs, max_clusters),
                      tclusters.ClusterParts) == (max_clusters < 1370)


def test_parts_route_launches_a_walk_per_part(case, monkeypatch):
    """pallas_closest takes the parts above max_clusters (default
    kernels.MAX_CLOSEST_CLUSTERS) and the single set at or below it: one
    walk (a K5 launch on the card, its plain version here) per part, each
    over its own clusters only. pallas_any takes the whole set in one walk
    whatever MAX_CLOSEST_CLUSTERS is, and parts only where max_clusters is
    given."""
    cs = case["ts"].clusters
    o, d, tmin, tmax = (_t(a[:LAUNCH_RAYS]) for a in case["rays"])
    seen = []

    def spy(fn):
        def wrapped(part, *a, **k):
            seen.append(part.num_clusters)
            return fn(part, *a, **k)
        return wrapped
    monkeypatch.setattr(pallas_tile, "any_tiles_plain",
                        spy(pallas_tile.any_tiles_plain))
    monkeypatch.setattr(pallas_tile, "closest_tiles_plain",
                        spy(pallas_tile.closest_tiles_plain))
    bounds = tclusters.even_bounds(cs.num_clusters, 500)
    pallas_tile.pallas_any(cs, o, d, tmin, tmax, max_clusters=500)
    pallas_tile.pallas_closest(cs, o, d, tmin, tmax, max_clusters=500)
    assert seen == [b - a for a, b in bounds] * 2 == [456, 457, 457] * 2
    seen.clear()
    pallas_tile.pallas_any(cs, o, d, tmin, tmax,
                           max_clusters=cs.num_clusters)
    assert seen == [cs.num_clusters]
    seen.clear()
    monkeypatch.setattr(kernels, "MAX_CLOSEST_CLUSTERS", 500)
    pallas_tile.pallas_any(cs, o, d, tmin, tmax)
    pallas_tile.pallas_closest(cs, o, d, tmin, tmax)
    assert seen == [cs.num_clusters, 456, 457, 457]


def _on_meta(cs, clusters=None):
    """`cs` with its tensors on the meta device (no data), with `clusters`
    clusters in place of its own where given."""
    def meta(x):
        if clusters is not None:
            x = x[:1].expand(clusters, *x.shape[1:])
        return x.to("meta")
    return dataclasses.replace(cs, **{
        f.name: meta(getattr(cs, f.name)) for f in dataclasses.fields(cs)
        if isinstance(getattr(cs, f.name), torch.Tensor)
        and getattr(cs, f.name).shape[0] == cs.num_clusters})


def test_scene_trace_any_takes_the_parts_route(case, monkeypatch):
    """trace_any of a tile-mode scene on the card's route (here the meta
    device stands in for the card, and K5 any's binding is replaced by a
    spy) launches K5 any once a trace over the whole set: the interior's
    1,370 clusters, and a set of SCALE14_CLUSTERS, above
    MAX_CLOSEST_CLUSTERS (the parts route's bound, which K5 any no longer
    takes)."""
    launched = []

    def walk_any(o, d, tmin, tmax, cmin, cmax, tri_block, tri_count, tri_k):
        assert o.device.type == "meta"
        launched.append(cmin.shape[0])
        return torch.zeros((o.shape[0],), dtype=torch.int32,
                           device=o.device)
    monkeypatch.setattr(kernels, "walk_any", walk_any)
    o = torch.zeros((N_RAYS, 3), device="meta")
    cs = case["ts"].clusters
    ts = dataclasses.replace(case["ts"], clusters=_on_meta(cs))
    vis = tscene.visibility(ts, o, o + 1.0)
    assert vis.shape == (N_RAYS,) and launched == [cs.num_clusters]
    launched.clear()
    assert SCALE14_CLUSTERS > kernels.MAX_CLOSEST_CLUSTERS
    big = dataclasses.replace(case["ts"], clusters=_on_meta(
        cs, SCALE14_CLUSTERS))
    for _ in range(2):
        occ = tscene.trace_any(big, o, o, 1e-3, 1e16)
        assert occ.shape == (N_RAYS,) and occ.dtype == torch.bool
    assert launched == [SCALE14_CLUSTERS] * 2


# ---------------------------------------------------------------------------
# equal t across parts: two clusters with the same triangle
# ---------------------------------------------------------------------------

TIE_RAYS = 300       # not a multiple of the 128-ray tile


def _tie_case():
    """Two clusters of two triangles, in both packages: the same triangle
    T (z = 5, facing the rays) in each, beside a triangle off the rays'
    path at z = 10 in cluster 0 and at z = 2 in cluster 1, so that cluster
    1's box starts nearer (its tile entry ~2, cluster 0's ~5). Rays from
    z = 0 towards +z meet both copies of T at the same t: JAX's whole-set
    walk takes cluster 1's (the earlier of its (entry, id) order), except
    in the tile padded with dead lanes of direction (1, 0, 0), whose hull
    gives both clusters the entry -1e30 (then the smaller id wins).
    Returns (JAX ClusterSet, the port's TileClusterSet, numpy rays)."""
    k = 32
    tri = lambda p0, e1, e2: np.array([p0, e1, e2], np.float64)
    t_shared = tri((-2, -2, 5), (0, 6, 0), (6, 0, 0))
    tris = np.stack([t_shared, tri((10, 0, 10), (0, 1, 0), (1, 0, 0)),
                     t_shared, tri((10, 0, 2), (0, 1, 0), (1, 0, 0))])
    p0, e1, e2 = tris[:, 0], tris[:, 1], tris[:, 2]
    corners = np.stack([p0, p0 + e1, p0 + e2], axis=1)      # (T, 3, 3)
    cmin = np.stack([corners[2 * c:2 * c + 2].reshape(-1, 3).min(0)
                     for c in range(2)]).astype(np.float32)
    cmax = np.stack([corners[2 * c:2 * c + 2].reshape(-1, 3).max(0)
                     for c in range(2)]).astype(np.float32)
    block = np.zeros((2, 16, 128), np.float32)
    for c in range(2):
        raw = np.concatenate([p0, e1, e2], axis=1)[2 * c:2 * c + 2]
        block[c, :9, :2] = raw.T
    coeff = np.zeros((2, 16, 4 * k), np.float32)
    begin = np.array([0, 2], np.int32)
    jcs = jclusters.ClusterSet(
        cmin=jnp.asarray(cmin), cmax=jnp.asarray(cmax),
        coeff=jnp.asarray(coeff), tri_block=jnp.asarray(block),
        tri_begin=jnp.asarray(begin), tri_p0=jnp.asarray(p0, jnp.float32),
        tri_e1=jnp.asarray(e1, jnp.float32),
        tri_e2=jnp.asarray(e2, jnp.float32), tri_k=k)
    tcs = tclusters.TileClusterSet.from_arrays(cmin, cmax, coeff, block,
                                               begin, k, "cpu")
    rng = np.random.default_rng(5)
    o = np.zeros((TIE_RAYS, 3), np.float32)
    o[:, :2] = rng.uniform(-0.5, 0.5, (TIE_RAYS, 2))
    d = np.concatenate([rng.uniform(-0.05, 0.05, (TIE_RAYS, 2)),
                        np.ones((TIE_RAYS, 1))], axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = np.full(TIE_RAYS, 1e-3, np.float32)
    tmax = np.full(TIE_RAYS, 1e16, np.float32)
    tmax[rng.permutation(TIE_RAYS)[:TIE_RAYS // 10]] = -1.0
    return jcs, tcs, (o, d, tmin, tmax)


@pytest.mark.parametrize("cull", [True, False])
def test_closest_parts_break_ties_as_the_whole_set(pallas_interpret, cull):
    """The two clusters of _tie_case in two parts (max_clusters 1):
    pallas_closest_plain takes, on every lane, the triangle JAX's
    pallas_closest (its Pallas walk over the whole set, interpret mode)
    takes, t to T_RTOL, and equals the port's whole-set walk bit for bit;
    the old merge (each part's tmax the best t so far, a later part
    winning only with a strictly smaller t) keeps the earlier part's copy
    instead."""
    jcs, tcs, rays = _tie_case()
    parts = pallas_tile.pallas_closest_plain(tcs, *map(_t, rays), cull,
                                             max_clusters=1)
    whole = pallas_tile.pallas_closest_plain(tcs, *map(_t, rays), cull)
    ref = pallas_interpret.pallas_closest(jcs, *map(_j, rays), cull)
    ref_tri = np.asarray(ref.tri)
    live = rays[3] > 0
    later = ref_tri == 2
    assert (ref_tri[~live] == -1).all() and (ref_tri[live] >= 0).all()
    assert later.sum() >= 200 and (later & live).sum() < live.sum()
    np.testing.assert_array_equal(parts.tri.numpy(), ref_tri)
    np.testing.assert_allclose(parts.t.numpy(), np.asarray(ref.t),
                               rtol=T_RTOL)
    for f in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(parts, f), getattr(whole, f)), f
    split = pallas_tile.split(tcs, 1)
    assert [p.num_clusters for p in split.parts] == [1, 1]
    o, d, tmn, tmx, n, _ = pallas_tile.prepare(tcs, *map(_t, rays), False)
    old = None
    for cs in split.parts:
        cur = tmx if old is None else torch.minimum(tmx, old[0])
        out = pallas_tile.closest_tiles_plain(cs, o, d, tmn, cur, cull)
        if old is None:
            old = out
        else:
            better = out[0] < old[0]
            old = tuple(torch.where(better, a, b) for a, b in zip(out, old))
    old_tri = old[1][:n].numpy()
    assert (old_tri[live] == 0).all() and (old_tri[later] != 2).all()

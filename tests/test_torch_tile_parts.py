"""The fused tile walk (ops/pallas_tile, kernel K5's plain versions on CPU
tensors) over a tile set split into parts (ops/clusters.ClusterParts of
near-equal ranges, clusters.even_bounds),
against the JAX package's tile mode on the same numpy-seeded rays: the
scale-4 interior (32,576 triangles, 1,370 clusters of at most 32) cut into
parts of at most MAX_CLUSTERS clusters, so that a small scene takes the
route a scene above the clusters one K5 block holds takes on the card.

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
# Parts against the single set, closest hit: a later part wins only with a
# strictly smaller t, so where triangles of two parts meet a ray at the
# same t the earlier part keeps it; elsewhere the hits are equal.
PARTS_TRI_AGREE = 0.9999
LAUNCH_RAYS = 256    # rays of the launch-count test


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
    1,370 clusters, as K5 takes them below its ceiling): occlusion bit for
    bit; closest hits on PARTS_TRI_AGREE of the lanes, and t, u, v equal
    wherever the triangles are."""
    assert torch.equal(walks("any", False, MAX_CLUSTERS),
                       walks("any", False, None))
    parts, whole = (walks("closest", cull, m) for m in (MAX_CLUSTERS, None))
    same = parts.tri == whole.tri
    assert same.float().mean().item() >= PARTS_TRI_AGREE
    for f in ("t", "u", "v"):
        assert torch.equal(getattr(parts, f)[same], getattr(whole, f)[same])


def test_parts_route_launches_a_walk_per_part(case, monkeypatch):
    """pallas_any / pallas_closest take the parts above max_clusters and the
    single set at or below it: one walk (a K5 launch on the card, its plain
    version here) per part, each over its own clusters only."""
    cs = case["ts"].clusters
    o, d, tmin, tmax = (_t(a[:LAUNCH_RAYS]) for a in case["rays"])
    seen = []

    def spy(fn):
        def wrapped(part, *a):
            seen.append(part.num_clusters)
            return fn(part, *a)
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


def test_scene_trace_any_takes_the_parts_route(case, monkeypatch):
    """trace_any of a tile-mode scene on the card's route (here the meta
    device stands in for the card, and K5 any's binding is replaced by a
    spy) launches K5 any once a part, each launch over at most
    MAX_ANY_CLUSTERS clusters, when that is made small; at the shipped
    ceiling the interior is one launch."""
    cs = case["ts"].clusters
    meta = dataclasses.replace(cs, **{
        f.name: getattr(cs, f.name).to("meta")
        for f in dataclasses.fields(cs)
        if isinstance(getattr(cs, f.name), torch.Tensor)})
    ts = dataclasses.replace(case["ts"], clusters=meta)
    launched = []

    def walk_any(o, d, tmin, tmax, cmin, cmax, tri_block, tri_count, tri_k):
        assert o.device.type == "meta"
        launched.append(cmin.shape[0])
        return torch.zeros((o.shape[0],), dtype=torch.int32,
                           device=o.device)
    monkeypatch.setattr(kernels, "walk_any", walk_any)
    o = torch.zeros((N_RAYS, 3), device="meta")
    vis = tscene.visibility(ts, o, o + 1.0)
    assert vis.shape == (N_RAYS,) and launched == [cs.num_clusters]
    launched.clear()
    monkeypatch.setattr(kernels, "MAX_ANY_CLUSTERS", MAX_CLUSTERS)
    occ = tscene.trace_any(ts, o, o, 1e-3, 1e16)
    assert occ.shape == (N_RAYS,) and occ.dtype == torch.bool
    bounds = tclusters.even_bounds(cs.num_clusters, MAX_CLUSTERS)
    assert launched == [b - a for a, b in bounds] and len(launched) == 22

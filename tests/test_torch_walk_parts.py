"""The port's partitioned row-walk sets (ops/clusters.build_cluster_parts,
ClusterParts) and their walks (ops/ray_walk.walk_closest_parts /
walk_any_parts, plain version on CPU tensors) against the JAX package:
the parts array for array, the walks against JAX's interpreted Pallas
walks, the scene's partitioned build and `from_jax_scene` of JAX's tuple,
and a PT render over the parts."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spcbpt_tpu.ops import bvh as jbvh
from spcbpt_tpu.ops import clusters as jclusters
from spcbpt_tpu.ops import ray_walk as jwalk
from spcbpt_tpu.render import pt_pool as jpool
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu_torch.kernels import ray_walk as kernels
from spcbpt_tpu_torch.ops import bvh as tbvh
from spcbpt_tpu_torch.ops import clusters as tclusters
from spcbpt_tpu_torch.ops import ray_walk as twalk
from spcbpt_tpu_torch.render import pt_pool as tpool
from spcbpt_tpu_torch.scene import scene as tscene

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

SOUP_RTOL = 2e-4     # XLA's CPU FMAs move JAX's t at grazing hits
PART_MAX_TRIS = 256  # tests/test_walk_parts.py's budget: several parts
_ARRAYS = ("cmin", "cmax", "tri_block")


@pytest.fixture(scope="module")
def soup():
    """tests/test_walk_parts.py's 900-triangle soup, its parts in both
    packages and 256 rays."""
    rng = np.random.default_rng(23)
    nt = 900
    p0 = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.22, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.22, (nt, 3)).astype(np.float32)
    flat = jbvh.build_bvh(p0, e1, e2)
    tflat = tbvh.build_bvh(p0, e1, e2)
    np.testing.assert_array_equal(tflat.order, flat.order)
    order = flat.order
    p0, e1, e2 = p0[order], e1[order], e2[order]
    jparts = jclusters.build_cluster_parts(flat, p0, e1, e2, max_tris=128,
                                           part_max_tris=PART_MAX_TRIS,
                                           with_coeff=False)
    tparts = tclusters.build_cluster_parts(tflat, p0, e1, e2, max_tris=128,
                                           part_max_tris=PART_MAX_TRIS)
    n = 256
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(flat=tflat, tris=(p0, e1, e2), jparts=jparts, tparts=tparts,
                o=o, d=d)


def _host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_parts_equal(tparts, jparts):
    """The port's parts equal JAX's tuple array for array, JAX's local
    tri_begin plus its tri_base."""
    assert len(tparts.parts) == len(jparts)
    for tp, jp in zip(tparts.parts, jparts):
        for f in _ARRAYS:
            np.testing.assert_array_equal(_host(getattr(tp, f)),
                                          np.asarray(getattr(jp, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(
            tp.tri_begin.numpy(), np.asarray(jp.tri_begin) + jp.tri_base)


def test_parts_match_jax(soup):
    assert len(soup["jparts"]) >= 3
    _assert_parts_equal(soup["tparts"], soup["jparts"])
    whole = soup["tparts"].whole
    assert soup["tparts"].num_clusters == whole.num_clusters == sum(
        p.num_clusters for p in soup["tparts"].parts)


def _rays(soup, tmax):
    n = soup["o"].shape[0]
    return (torch.from_numpy(soup["o"]), torch.from_numpy(soup["d"]),
            torch.full((n,), 1e-3), torch.full((n,), tmax))


def _jrays(soup, tmax):
    n = soup["o"].shape[0]
    return (jnp.asarray(soup["o"]), jnp.asarray(soup["d"]),
            jnp.full((n,), 1e-3), jnp.full((n,), tmax))


@pytest.mark.parametrize("sort_rays", [False, True])
@pytest.mark.parametrize("cull", [True, False])
def test_walk_closest_parts_matches_jax(soup, cull, sort_rays):
    ref = jwalk.walk_closest_parts(soup["jparts"], *_jrays(soup, 1e16), cull,
                                   sort_rays=sort_rays, interpret=True)
    got = twalk.walk_closest_parts(soup["tparts"], *_rays(soup, 1e16), cull,
                                   sort_rays=sort_rays)
    tri = np.asarray(ref.tri)
    np.testing.assert_array_equal(got.tri.numpy(), tri)
    assert (tri >= 0).mean() > 0.1
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t),
                               rtol=SOUP_RTOL)


@pytest.mark.parametrize("sort_rays", [False, True])
def test_walk_any_parts_matches_jax(soup, sort_rays):
    ref = np.asarray(jwalk.walk_any_parts(soup["jparts"], *_jrays(soup, 1.5),
                                          sort_rays=sort_rays,
                                          interpret=True))
    got = twalk.walk_any_parts(soup["tparts"], *_rays(soup, 1.5),
                               sort_rays=sort_rays)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.05 < ref.mean() < 0.95


def test_cluster_cap_splits_in_order(soup):
    """A cap of 2 clusters a part: the parts cover every cluster in order,
    none above the cap, and the walks over them equal the walk of the
    whole set."""
    tparts = tclusters.build_cluster_parts(soup["flat"], *soup["tris"],
                                           max_tris=128,
                                           part_max_tris=10 ** 9,
                                           max_clusters=2)
    c = tparts.whole.num_clusters
    assert tparts.bounds[0][0] == 0 and tparts.bounds[-1][1] == c
    for (a, b), (a2, _) in zip(tparts.bounds, tparts.bounds[1:]):
        assert b == a2
    assert all(0 < b - a <= 2 for a, b in tparts.bounds)
    assert len(tparts.parts) == -(-c // 2)
    np.testing.assert_array_equal(
        torch.cat([p.tri_begin for p in tparts.parts]).numpy(),
        tparts.whole.tri_begin.numpy())
    whole = tparts.whole
    got = twalk.walk_closest_parts(tparts, *_rays(soup, 1e16), True,
                                   sort_rays=True)
    ref = twalk.walk_closest(whole, *_rays(soup, 1e16), True, sort_rays=True)
    for f in ("tri", "t", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(twalk.walk_any_parts(tparts, *_rays(soup, 1.5)),
                       twalk.walk_any(whole, *_rays(soup, 1.5)))


def test_cap_is_the_kernels_shared_memory():
    """The cap is the most clusters whose block fits the shared memory the
    K1/K2 binding allows; the scale-10 and scale-12 interiors' 2,256 and
    3,386 clusters need 234,624 and 352,192 bytes, above it."""
    cap = tclusters.MAX_CLUSTERS
    assert kernels.shared_bytes(cap) <= kernels.MAX_SHARED
    assert kernels.shared_bytes(cap + 1) > kernels.MAX_SHARED
    assert kernels.shared_bytes(2256) == 234_624
    assert kernels.shared_bytes(3386) == 352_192


@pytest.fixture(scope="module")
def partitioned_interior(tmp_path_factory):
    """The scale=1 interior (2,264 triangles, 30 clusters) with
    WALK_MAX_TRIS lowered to 800 in both packages: JAX's tuple, the port's
    own build and from_jax_scene of JAX's."""
    path = interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=1)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jscene, "WALK_MAX_TRIS", 800)
        mp.setattr(tscene, "WALK_MAX_TRIS", 800)
        jts, _, cam = jscene.load_trace_scene(path, mode="walk")
        ts, _, _ = tscene.load_trace_scene(path, "cpu", mode="walk")
    finally:
        mp.undo()
    cam.aspect = 1.0
    return jts, ts, tscene.from_jax_scene(jts, "cpu"), cam.uvw()


def test_scene_builds_parts_as_jax(partitioned_interior):
    jts, ts, fts, _ = partitioned_interior
    assert isinstance(jts.clusters_walk, tuple)
    assert len(jts.clusters_walk) >= 2
    for t in (ts, fts):
        assert isinstance(t.clusters_walk, tclusters.ClusterParts)
        _assert_parts_equal(t.clusters_walk, jts.clusters_walk)
        assert t.clusters_walk.num_clusters == 30


def test_parts_pool_render_matches_jax(partitioned_interior, monkeypatch):
    """PT over JAX's parts (its Pallas walks interpreted) and over the
    port's (plain rows), same seeds: counts exact, >= 99% of pixels within
    1e-4 relative, mean within 1e-4 relative (tests/test_torch_pt.py's
    tolerance)."""
    jts, _, fts, (eye, U, V, W) = partitioned_interior
    for name in ("walk_closest_parts", "walk_any_parts"):
        monkeypatch.setattr(jwalk, name, functools.partial(
            getattr(jwalk, name), interpret=True))
    jf, jc = jpool.render_pool_jit(jts, eye, U, V, W, 16, 16, 2, 0)
    tf, tc = tpool.render_pool(fts, (eye, U, V, W), 16, 16, 2, 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    within = (np.where(a == b, 0.0, err) <= 1e-4).all(axis=-1).mean()
    assert within >= 0.99
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())

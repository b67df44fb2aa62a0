"""The port's `bvh` mode (ops/traverse.py, plain torch) against the JAX
package's skip-link walk: tests/test_traversal.py's soups, and JAX's default
CPU scene of the scale=1 interior (2,264 triangles: mode `bvh`) through
`from_jax_scene` and a PT render."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spcbpt_tpu.ops import bvh as jbvh
from spcbpt_tpu.ops import traverse as jtraverse
from spcbpt_tpu.render import pt_pool as jpool
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch.ops import traverse as ttraverse
from spcbpt_tpu_torch.render import pt_pool as tpool
from spcbpt_tpu_torch.scene.scene import from_jax_scene

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

T_RTOL = 1e-5


def _soup(n_tris, n_rays, seed):
    """tests/test_traversal.py's random triangles (reordered by the numpy
    BVH it builds) and rays."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    flat = jbvh.build_bvh_numpy(p0, e1, e2)
    order = flat.order
    o = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bvh = [np.asarray(a, dt) for a, dt in (
        (flat.bounds_min, np.float32), (flat.bounds_max, np.float32),
        (flat.skip, np.int32), (flat.leaf_start, np.int32),
        (flat.leaf_count, np.int32))]
    return bvh, [a[order] for a in (p0, e1, e2)], o, d


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("cull", [True, False])
def test_bvh_closest_matches_jax(cull):
    bvh, tris, o, d = _soup(300, 512, 0)
    (jb, tb), (jt, tt), (jr, tr) = _both(bvh), _both(tris), _both([o, d])
    n = o.shape[0]
    ref = jtraverse.bvh_closest(*jr, jnp.full(n, 1e-3), jnp.full(n, 1e30),
                                *jb, *jt, cull)
    got = ttraverse.bvh_closest(*tr, torch.full((n,), 1e-3),
                                torch.full((n,), 1e30), *tb, *tt, cull)
    tri = np.asarray(ref.tri)
    np.testing.assert_array_equal(got.tri.numpy(), tri)
    assert (tri >= 0).sum() >= 10     # the soup is sparse: ~4% hit
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=T_RTOL)
    hit = tri >= 0
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(ref, f))[hit],
                                   atol=1e-5)


def test_bvh_any_matches_jax():
    bvh, tris, o, d = _soup(200, 512, 1)
    (jb, tb), (jt, tt), (jr, tr) = _both(bvh), _both(tris), _both([o, d])
    n = o.shape[0]
    ref = np.asarray(jtraverse.bvh_any(*jr, jnp.full(n, 1e-3),
                                       jnp.full(n, 4.0), *jb, *jt))
    got = ttraverse.bvh_any(*tr, torch.full((n,), 1e-3),
                            torch.full((n,), 4.0), *tb, *tt)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 10 <= ref.sum() <= ref.size - 10


@pytest.fixture(scope="module")
def interior_bvh(tmp_path_factory):
    """JAX's default CPU scene of the scale=1 interior (above 1,024
    triangles: `bvh`) and the port's scene from it."""
    path = interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=1)
    jts, _, cam = jload(path)
    cam.aspect = 1.0
    return jts, from_jax_scene(jts, "cpu"), cam.uvw()


def test_from_jax_scene_takes_bvh(interior_bvh):
    jts, ts, _ = interior_bvh
    assert jts.mode == ts.mode == "bvh" and ts.num_tris == 2264
    assert ts.clusters is None and ts.clusters_walk is None
    for f in ("bvh_min", "bvh_max", "bvh_skip", "bvh_leaf_start",
              "bvh_leaf_count"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(jts, f)), err_msg=f)


def test_bvh_pool_render_matches_jax(interior_bvh):
    """PT 16x16, 2 spp in `bvh` mode on both sides, same seeds: counts
    exact, >= 99% of pixels within 1e-4 relative, mean within 1e-4 relative
    (tests/test_torch_pt.py's tolerance)."""
    jts, ts, (eye, U, V, W) = interior_bvh
    jf, jc = jpool.render_pool_jit(jts, eye, U, V, W, 16, 16, 2, 0)
    tf, tc = tpool.render_pool(ts, (eye, U, V, W), 16, 16, 2, 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    within = (np.where(a == b, 0.0, err) <= 1e-4).all(axis=-1).mean()
    assert within >= 0.99
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())

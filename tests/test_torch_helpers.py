"""The last helpers ported from the JAX package, held to it on seeded
numpy inputs: ops/tile_trace.block_order (the permutation, exactly),
scene/scene.wavefront_key (the keys, exactly, in every branch: walk, tile,
a walk set split into parts, and None for brute and bvh) and
utils/image.mape (1e-12 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import tile_trace as jtt
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.utils import image as jimage
from spcbpt_tpu_torch.ops import clusters as tclusters
from spcbpt_tpu_torch.ops import tile_trace as ttt
from spcbpt_tpu_torch.scene import scene as tscene
from spcbpt_tpu_torch.utils import image as timage

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

MAPE_RTOL = 1e-12
N_RAYS = 1000
PART_MAX_TRIS = 1000   # splits the scale-1 interior's walk set (2,264)


@pytest.mark.parametrize("width,height,bw,bh", [
    (64, 64, 8, 8), (512, 256, 16, 16), (96, 40, 32, 8), (8, 8, 8, 8)])
def test_block_order_matches_jax(width, height, bw, bh):
    got = ttt.block_order(width, height, bw, bh)
    ref = jtt.block_order(width, height, bw, bh)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.sort(got), np.arange(width * height))


@pytest.mark.parametrize("shape,eps", [((16, 16, 3), 1e-2), ((1000,), 0.5),
                                       ((7, 5, 3), 1e-6)])
def test_mape_matches_jax(shape, eps):
    rng = np.random.default_rng(sum(shape))
    ref = rng.gamma(2.0, 0.5, shape).astype(np.float32)
    img = (ref + rng.normal(0.0, 0.1, shape)).astype(np.float32)
    got = timage.mape(torch.from_numpy(img), ref, eps)
    want = jimage.mape(jnp.asarray(img), ref, eps)
    assert isinstance(got, float) and got > 0
    np.testing.assert_allclose(got, want, rtol=MAPE_RTOL)


@pytest.fixture(scope="module")
def interior_path(tmp_path_factory):
    return interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=1)


def _rays(ts):
    """N_RAYS seeded rays from inside the scene's bounds."""
    p = ts.tri_p0.numpy()
    rng = np.random.default_rng(41)
    o = rng.uniform(p.min(axis=0), p.max(axis=0),
                    (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("case", ["walk", "tile", "parts", "bvh",
                                  "brute"])
def test_wavefront_key_matches_jax(case, interior_path, monkeypatch):
    if case == "parts":
        monkeypatch.setattr(jscene, "WALK_MAX_TRIS", PART_MAX_TRIS)
        monkeypatch.setattr(tscene, "WALK_MAX_TRIS", PART_MAX_TRIS)
    path = default_scene_path() if case == "brute" else interior_path
    mode = "walk" if case == "parts" else case
    jts, _, _ = jscene.load_trace_scene(path, mode=mode)
    ts, _, _ = tscene.load_trace_scene(path, "cpu", mode=mode)
    assert ts.mode == jts.mode == mode
    if case == "parts":
        assert isinstance(ts.clusters_walk, tclusters.ClusterParts)
        assert isinstance(jts.clusters_walk, tuple)
        assert len(ts.clusters_walk.parts) == len(jts.clusters_walk) >= 2
    o, d = _rays(ts)
    got = tscene.wavefront_key(ts, torch.from_numpy(o), torch.from_numpy(d))
    ref = jscene.wavefront_key(jts, jnp.asarray(o), jnp.asarray(d))
    if case in ("bvh", "brute"):
        assert got is None and ref is None
        return
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy())) > 1

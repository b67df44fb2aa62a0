"""The port's scatter-free PT (render/pt_pool.render_waves) against the JAX
package's and against the port's own regeneration pool on the same seeds."""
import numpy as np
import pytest
import torch

from spcbpt_tpu.render import pt_pool as jpool
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch.render import pt_pool as tpool
from spcbpt_tpu_torch.scene.scene import from_jax_scene

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

DIM, SPP = 16, 2


def _pixels_within(a, b, rtol):
    """Share of pixels whose three channels agree to rtol (relative to b;
    exact zeros agree)."""
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return float((np.where(a == b, 0.0, err) <= rtol).all(axis=-1).mean())


@pytest.fixture(scope="module")
def cornell():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    ts = from_jax_scene(jts, "cpu")
    uvw = cam.uvw()
    film, count = tpool.render_waves(ts, uvw, DIM, DIM, SPP, 0)
    return jts, ts, uvw, film, count


def test_waves_match_jax(cornell):
    """Counts exact, >= 99% of pixels within 1e-4 relative, mean within
    1e-4 relative (tests/test_torch_pt.py's tolerance)."""
    jts, _, (eye, U, V, W), film, count = cornell
    jf, jc = jpool.render_waves_jit(jts, eye, U, V, W, DIM, DIM, SPP, 0)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    a = (film / count[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert _pixels_within(a, b, 1e-4) >= 0.99
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())


def test_waves_match_pool(cornell):
    """Sample r of pixel p is seeded by (p, r) in both loops, so per pixel
    they differ only in summation order and traversal ties."""
    _, ts, uvw, film, count = cornell
    pf, pc = tpool.render_pool(ts, uvw, DIM, DIM, SPP, 0)
    assert torch.equal(count, pc) and (count == SPP).all()
    a, b = (film / count[:, None]).numpy(), (pf / pc[:, None]).numpy()
    assert _pixels_within(a, b, 1e-4) >= 0.999
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())

"""The PT pool's loop body over its cached buffers (render/pt_pool.py), on
the CPU: two frames through one cache entry, eagerly and on the graph route
with a stand-in for the capture (tests/graph_stand_in.py), against the JAX
pool and a fresh call. The loop both pools share is tested in
tests/test_torch_pool.py."""
import numpy as np
import pytest
import torch

from spcbpt_tpu.render import pt_pool as jpool
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch.render import pt_pool
from spcbpt_tpu_torch.scene.scene import from_jax_scene

from graph_stand_in import graphed  # noqa: F401 (fixture)
from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

SIDE = 16
SPP = 2
# two frames: (subframe0, how far the eye moves along the camera's U)
FRAMES = ((3, 0.0), (7, 0.15))


@pytest.fixture(scope="module")
def cornell():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    return jts, cam.uvw()


def _moved(uvw, step: float):
    eye, U, V, W = (np.asarray(x, np.float64) for x in uvw)
    return (eye + step * U / np.linalg.norm(U), U, V, W)


def _pixels_within(a, b, rtol):
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return float((np.where(a == b, 0.0, err) <= rtol).all(axis=-1).mean())


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_two_frames_through_one_cache_entry(cornell, route, request):
    """Frame 2 (a new subframe0, the eye moved) rendered through the pool
    frame 1 made: the JAX pool's parity bounds (tests/test_torch_pt.py),
    and equal to a fresh call on a scene of its own."""
    if route == "graph":
        request.getfixturevalue("graphed")
    jts, uvw = cornell
    ts = from_jax_scene(jts, "cpu")
    outs = []
    for sub, step in FRAMES:
        outs.append(pt_pool.render_pool(ts, _moved(uvw, step), SIDE, SIDE,
                                        SPP, sub))
    assert sum(k[0] == id(ts) for k in pt_pool._POOLS.pools) == 1
    sub, step = FRAMES[1]
    tf, tc = outs[1]
    fresh = pt_pool.render_pool(from_jax_scene(jts, "cpu"),
                                _moved(uvw, step), SIDE, SIDE, SPP, sub)
    assert torch.equal(tf, fresh[0]) and torch.equal(tc, fresh[1])
    assert not torch.equal(outs[0][0], tf)

    eye, U, V, W = _moved(uvw, step)
    jf, jc = jpool.render_pool_jit(jts, eye, U, V, W, SIDE, SIDE, SPP, sub)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert _pixels_within(a, b, 1e-4) >= 0.99
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())

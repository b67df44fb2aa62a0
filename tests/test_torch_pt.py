"""The port's PT slice against the JAX package: the regeneration pool and the
fixed-depth wavefront on Cornell, the row walk inside a whole render on the
scale=1 interior, and the port's render CLI on the CPU."""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spcbpt_tpu.render import pt as jpt
from spcbpt_tpu.render import pt_pool as jpool
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch.apps import render_cli
from spcbpt_tpu_torch.render import pt as tpt
from spcbpt_tpu_torch.render import pt_pool as tpool
from spcbpt_tpu_torch.scene.scene import from_jax_scene, load_trace_scene

# the tensors here are small: one thread per xdist worker avoids
# oversubscribing the cores

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _pixels_within(a, b, rtol):
    """Share of pixels whose three channels agree to rtol (relative to the
    JAX value; exact zeros agree)."""
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return float((np.where(a == b, 0.0, err) <= rtol).all(axis=-1).mean())


@pytest.fixture(scope="module")
def cornell():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    return jts, from_jax_scene(jts, "cpu"), cam.uvw()


def test_pool_matches_jax_cornell(cornell):
    """Same seeds, same estimator: counts exact, >= 99% of pixels within
    1e-4 relative, mean within 1e-4 relative. (Paths may still part where
    XLA's and torch's last-ulp rounding sends a ray across a triangle edge.)"""
    jts, ts, (eye, U, V, W) = cornell
    jf, jc = jpool.render_pool_jit(jts, eye, U, V, W, 32, 32, 4, 0)
    tf, tc = tpool.render_pool(ts, (eye, U, V, W), 32, 32, 4, 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() == 4).all()
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert _pixels_within(a, b, 1e-4) >= 0.99
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())


def test_render_frame_matches_jax_cornell(cornell):
    jts, ts, (eye, U, V, W) = cornell
    ref = np.asarray(jpt.render_frame_jit(jts, eye, U, V, W, 16, 16, 1, 8))
    got = tpt.render_frame(ts, (eye, U, V, W), 16, 16, 1, max_depth=8)
    a = got.numpy()
    assert np.isfinite(a).all() and (a >= 0).all()
    assert _pixels_within(a, ref, 1e-4) >= 0.99
    assert abs(a.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


def test_pool_walk_matches_jax_brute_interior(tmp_path):
    """The scale=1 interior (2,264 triangles): JAX brute force against the
    port's row walk (plain version) inside a whole render. Counts exact,
    mean within 1%, >= 97% of pixels within 1e-3: at cluster edges an exact
    tie may go to another triangle, and the path then parts."""
    path = interior.generate(str(tmp_path), scale=1)
    jts, _, cam = jload(path, mode="brute")
    cam.aspect = 1.0
    ts, _, _ = load_trace_scene(path, "cpu")
    assert ts.mode == "walk"
    eye, U, V, W = cam.uvw()
    jf, jc = jpool.render_pool_jit(jts, eye, U, V, W, 16, 16, 2, 0)
    tf, tc = tpool.render_pool(ts, (eye, U, V, W), 16, 16, 2, 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert b.mean() > 0
    assert abs(a.mean() - b.mean()) <= 1e-2 * b.mean()
    assert _pixels_within(a, b, 1e-3) >= 0.97


def test_render_cli_cpu_writes_png(tmp_path):
    import imageio.v2 as imageio

    out = tmp_path / "c.png"
    stats = tmp_path / "s.json"
    hdr = tmp_path / "c.npz"
    assert render_cli.main(["--device", "cpu", "--scene", "cornell", "--alg",
                            "pt", "--spp", "1", "--dim", "16x16", "--out",
                            str(out), "--stats-json", str(stats),
                            "--hdr-out", str(hdr)]) == 0
    img = imageio.imread(out)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert img.mean() > 0
    s = json.loads(stats.read_text())
    assert s["count_min"] == s["count_max"] == 1 and s["finite"]
    rad = np.load(hdr)["radiance"]
    assert rad.shape == (16, 16, 3) and np.isfinite(rad).all()


def test_render_cli_cuda_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        render_cli.main(["--scene", "cornell", "--out",
                         str(tmp_path / "x.png")])

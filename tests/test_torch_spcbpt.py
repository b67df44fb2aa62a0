"""The port's BDPT/SPCBPT slice against the JAX package on Cornell: light
sub-path tracing (lights.trace_mode, light_trace.trace_light_paths), the
regeneration pool spcbpt_pool.render_pool for BDPT and SPCBPT on the same
light-vertex cache and state, and the render CLI on the CPU."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import lights as jlights
from spcbpt_tpu.render import light_trace as jlt
from spcbpt_tpu.render import lvc as jlvc
from spcbpt_tpu.render import spcbpt_pool as jpool
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.utils import rng as jrng
from spcbpt_tpu_torch import checkpoint
from spcbpt_tpu_torch.apps import render_cli
from spcbpt_tpu_torch.ops import lights as tlights
from spcbpt_tpu_torch.render import light_trace as tlt
from spcbpt_tpu_torch.render import lvc as tlvc
from spcbpt_tpu_torch.render import spcbpt as tsp
from spcbpt_tpu_torch.render import spcbpt_pool as tpool
from spcbpt_tpu_torch.render.vertex import from_jax_vertices
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.utils import rng as trng

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

N_PATHS = 2048
LIGHT_DEPTH = 8
SIDE = 16
# Light sub-paths: the same seeds and formulas; XLA contracts multiply-adds
# into FMAs and torch does not, and the ulps compound bounce after bounce
# (a grazing cosine or a short segment amplifies them): floats on valid
# vertices within 1e-2 relative, 99% of them within 1e-4. Validity, depth
# and ids exact; a subspace label may flip where two centroids tie.
PATH_RTOL = 1e-2
PATH_RTOL_TIGHT = 1e-4
PATH_MIN_CLOSE = 0.99
LABEL_AGREE = 0.999
# Renders on the same LVC, state and seeds: counts exact, mean within 1e-4
# relative, >= 98% of pixels within 1e-3 (a path parts where the ulps send
# a ray across an edge or flip a label; measured 100% at 16x16).
MEAN_RTOL = 1e-4
PIXEL_RTOL = 1e-3
PIXEL_SHARE = 0.98


@pytest.fixture(scope="module")
def cornell():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    jss = jcls.synthetic_trained_state(jts, seed=0)
    return jts, from_jax_scene(jts, "cpu"), cam.uvw(), jss, \
        tcls.from_jax_state(jss, "cpu")


@pytest.fixture(scope="module")
def light_paths(cornell):
    """The JAX light trace under the synthetic trained state and under the
    untrained state (BDPT)."""
    jts, _, _, jss, _ = cornell
    trace = lambda ss: jax.jit(lambda: jlt.trace_light_paths(
        jts, ss, N_PATHS, 7919, max_depth=LIGHT_DEPTH))()
    return {"spcbpt": trace(jss), "bdpt": trace(jcls.untrained_state())}


def test_trace_mode_matches_jax(cornell):
    jts, ts, _, _, _ = cornell
    lane = np.arange(4096, dtype=np.uint32)
    js = jrng.seed(jnp.asarray(lane), jnp.uint32(17))
    tstate = trng.seed(torch.from_numpy(lane.astype(np.int64)), 17)
    jls, js = jlights.sample_light(jts, js)
    tls, tstate = tlights.sample_light(ts, tstate)
    jd, jo, jp, js = jlights.trace_mode(jts, jls, js)
    td, to, tp, tstate = tlights.trace_mode(ts, tls, tstate)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # cos/sin of the hemisphere sample may differ in the last ulp
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    assert (tp.numpy() > 0).all()


def test_trace_light_paths_matches_jax(cornell, light_paths):
    _, ts, _, _, tss = cornell
    jlv = light_paths["spcbpt"]
    tlv = tlt.trace_light_paths(ts, tss, N_PATHS, 7919,
                                max_depth=LIGHT_DEPTH)
    valid = tlv.valid.numpy()
    assert tlv.valid.shape == (LIGHT_DEPTH + 1, N_PATHS)
    np.testing.assert_array_equal(valid, np.asarray(jlv.valid))
    assert valid[0].all() and valid[2].mean() > 0.2
    for f in dataclasses.fields(tlv):
        got = getattr(tlv, f.name).numpy()[valid]
        ref = np.asarray(getattr(jlv, f.name))[valid]
        if f.name in ("subspace_id", "eye_label", "last_zone_id"):
            assert (got == ref).mean() >= LABEL_AGREE, f.name
        elif got.dtype in (np.int32, np.bool_):
            np.testing.assert_array_equal(got, ref, err_msg=f.name)
        else:
            ok = np.isfinite(ref)
            scale = max(np.abs(ref[ok]).max(), 1e-30)
            np.testing.assert_allclose(got[ok], ref[ok], rtol=PATH_RTOL,
                                       atol=1e-6 * scale, err_msg=f.name)
            tight = np.abs(got[ok] - ref[ok]) <= (
                PATH_RTOL_TIGHT * np.abs(ref[ok]) + 1e-7 * scale)
            assert tight.mean() >= PATH_MIN_CLOSE, f.name


@pytest.mark.parametrize("alg", ["bdpt", "spcbpt"])
def test_render_pool_matches_jax(cornell, light_paths, alg):
    """One frame at 16x16, 1 spp: the JAX LVC carried over, samplers built
    by each package from it, the same state and seeds."""
    jts, ts, (eye, U, V, W), jss, tss = cornell
    uniform = alg == "bdpt"
    if uniform:
        jss, tss = jcls.untrained_state(), tcls.untrained_state()
    jlv = light_paths[alg]
    jsampler = jlvc.make_builder(None if uniform else jss)(jlv, 0)
    tsampler = tlvc.make_builder(None if uniform else tss)(
        from_jax_vertices(jlv, "cpu"), 0)
    jf, jc = jpool.render_pool_jit(jts, jss, jsampler, eye, U, V, W, SIDE,
                                   SIDE, 1, 0, uniform=uniform)
    tf, tc = tpool.render_pool(ts, tss, tsampler, (eye, U, V, W), SIDE,
                               SIDE, 1, 0, uniform=uniform)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() == 1).all()
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert abs(a.mean() - b.mean()) <= MEAN_RTOL * abs(b.mean())
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    close = (np.where(a == b, 0.0, err) <= PIXEL_RTOL).all(axis=-1).mean()
    assert close >= PIXEL_SHARE, close


def test_render_frame_equals_one_spp_pool(cornell):
    """make_spcbpt_step's fixed-depth wavefront (render_frame) and the
    regeneration pool draw the same seeds for one sample per pixel, so
    their images are equal; this holds the wavefront's loop, connections
    included, to the pool tested against JAX above."""
    _, ts, uvw, _, tss = cornell
    lv = tlt.trace_light_paths(ts, tss, 500, 3, max_depth=4)
    sampler = tlvc.make_builder(tss)(lv, 1)
    frame = tsp.render_frame(ts, tss, sampler, uvw, 8, 8, 2, max_depth=16)
    film, count = tpool.render_pool(ts, tss, sampler, uvw, 8, 8, 1, 2)
    assert (count == 1).all() and frame.abs().sum() > 0
    assert torch.equal(frame, film)


def test_render_cli_spcbpt_resume_writes_png(cornell, tmp_path):
    import imageio.v2 as imageio

    _, ts, _, _, _ = cornell
    state = tmp_path / "state.npz"
    checkpoint.save_subspace_state(str(state),
                                   tcls.synthetic_trained_state(ts, seed=2))
    out, stats = tmp_path / "s.png", tmp_path / "s.json"
    assert render_cli.main([
        "--device", "cpu", "--scene", "cornell", "--alg", "spcbpt",
        "--resume", str(state), "--dim", "16x16", "--spp", "2",
        "--light-paths", "1000", "--light-depth", "4", "--out", str(out),
        "--stats-json", str(stats)]) == 0
    img = imageio.imread(out)
    assert img.shape == (16, 16, 3) and img.mean() > 0
    s = json.loads(stats.read_text())
    assert s["alg"] == "spcbpt" and s["finite"]
    assert s["count_min"] == s["count_max"] == 2
    assert len(s["frames"]) == 2
    assert all(f["light_ms"] > 0 and f["eye_ms"] > 0 for f in s["frames"])


def test_render_cli_spcbpt_needs_resume(cornell, tmp_path):
    """Without --resume, --alg spcbpt trains its state (with --classifier
    nn, the close-set network too); with --resume the whole state, the
    network included, comes from the checkpoint and nothing is trained."""
    from spcbpt_tpu_torch.train import nn_classifier as tnn

    _, ts, _, _, tss = cornell
    nt = tnn.tables_from_state(
        tnn.init_params(np.random.default_rng(1), tss.gamma_pmf.numpy()),
        -np.ones(3), 2 * np.ones(3))
    state = tmp_path / "nn.npz"
    checkpoint.save_subspace_state(str(state), tss.replace(nn=nt))
    stats = tmp_path / "s.json"
    assert render_cli.main([
        "--device", "cpu", "--alg", "spcbpt", "--classifier", "nn",
        "--resume", str(state), "--dim", "8x8", "--spp", "1",
        "--light-paths", "500", "--out", str(tmp_path / "x.png"),
        "--stats-json", str(stats)]) == 0
    s = json.loads(stats.read_text())
    assert s["finite"] and s["mean_radiance"] > 0
    assert "train" not in s and "preprocess" not in s["phases"]
    assert checkpoint.load_subspace_state(str(state)).nn.blend == 0.5

"""The port's sky-lit path against the JAX package on the sky-lit floor
scene (tests/sky_scene.py, the scene of tests/test_env_scene.py with a
`Direction` light added): light sampling with the sky's extra draws, PT
(wavefront and pool) with env NEE and escape radiance, the light trace from
env start vertices, BDPT/SPCBPT pools with env connections and the escape
weight, one pretrace launch, and the render CLI training SPCBPT from the
scene. Tolerances are those of the non-env twins in test_torch_pt.py,
test_torch_spcbpt.py and test_torch_train.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import lights as jlights
from spcbpt_tpu.render import light_trace as jlt
from spcbpt_tpu.render import lvc as jlvc
from spcbpt_tpu.render import pt as jpt
from spcbpt_tpu.render import pt_pool as jptpool
from spcbpt_tpu.render import spcbpt_pool as jsppool
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.train import pretrace as jpre
from spcbpt_tpu.utils import rng as jrng
from spcbpt_tpu_torch.apps import render_cli
from spcbpt_tpu_torch.ops import lights as tlights
from spcbpt_tpu_torch.render import light_trace as tlt
from spcbpt_tpu_torch.render import lvc as tlvc
from spcbpt_tpu_torch.render import pt as tpt
from spcbpt_tpu_torch.render import pt_pool as tptpool
from spcbpt_tpu_torch.render import spcbpt_pool as tsppool
from spcbpt_tpu_torch.render.vertex import from_jax_vertices
from spcbpt_tpu_torch.scene.scene import from_jax_scene, load_trace_scene
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.train import pretrace as tpre
from spcbpt_tpu_torch.utils import rng as trng

from jax_native import native_jax_route  # noqa: F401 (autouse)
from sky_scene import write_sky_floor

torch.set_num_threads(1)

SIDE = 16
N_PATHS = 2048
LIGHT_DEPTH = 6
# as test_torch_pt.py / test_torch_spcbpt.py
MEAN_RTOL = 1e-4
PT_PIXEL_RTOL, PT_PIXEL_SHARE = 1e-4, 0.99
SP_PIXEL_RTOL, SP_PIXEL_SHARE = 1e-3, 0.98
PATH_RTOL, PATH_RTOL_TIGHT, PATH_MIN_CLOSE = 1e-2, 1e-4, 0.99
LABEL_AGREE = 0.999
PRETRACE_LANES = 512
PRETRACE_AGREE = 0.99


def _pixels_within(a, b, rtol):
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return float((np.where(a == b, 0.0, err) <= rtol).all(axis=-1).mean())


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    path = write_sky_floor(str(tmp_path_factory.mktemp("sky")),
                           direction=True)
    jts, _, cam = jload(path, mode="brute")
    assert jts.has_env and jts.num_lights == 2
    jss = jcls.synthetic_trained_state(jts, seed=0)
    return dict(path=path, jts=jts, ts=from_jax_scene(jts, "cpu"),
                uvw=cam.uvw(), jss=jss, tss=tcls.from_jax_state(jss, "cpu"))


def test_sample_light_and_trace_mode_match_jax(sky):
    """The sky draws one more float in sample_light and two more in
    trace_mode on every lane: the streams stay equal bit for bit."""
    jts, ts = sky["jts"], sky["ts"]
    lane = np.arange(4096, dtype=np.uint32)
    js = jrng.seed(jnp.asarray(lane), jnp.uint32(17))
    tstate = trng.seed(torch.from_numpy(lane.astype(np.int64)), 17)
    jls, js = jlights.sample_light(jts, js)
    tls, tstate = tlights.sample_light(ts, tstate)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(js))
    is_env = tls.is_env.numpy()
    np.testing.assert_array_equal(is_env, np.asarray(jls.is_env))
    assert 0.3 < is_env.mean() < 0.7
    for f in dataclasses.fields(tls):
        got = getattr(tls, f.name).numpy()
        ref = np.asarray(getattr(jls, f.name))
        if got.dtype in (np.int32, np.int64, np.bool_):
            assert (got == ref).mean() >= LABEL_AGREE, f.name
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                       err_msg=f.name)
    jd, jo, jp, js = jlights.trace_mode(jts, jls, js)
    td, to, tp, tstate = tlights.trace_mode(ts, tls, tstate)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(js))
    for got, ref in ((td, jd), (to, jo), (tp, jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    assert (tp.numpy() > 0).all()


def test_pt_render_frame_matches_jax(sky):
    jts, ts, (eye, U, V, W) = sky["jts"], sky["ts"], sky["uvw"]
    ref = np.asarray(jpt.render_frame_jit(jts, eye, U, V, W, SIDE, SIDE, 1,
                                          8))
    got = tpt.render_frame(ts, (eye, U, V, W), SIDE, SIDE, 1,
                           max_depth=8).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert _pixels_within(got, ref, PT_PIXEL_RTOL) >= PT_PIXEL_SHARE
    assert abs(got.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())


def test_pt_pool_matches_jax(sky):
    jts, ts, (eye, U, V, W) = sky["jts"], sky["ts"], sky["uvw"]
    jf, jc = jptpool.render_pool_jit(jts, eye, U, V, W, SIDE, SIDE, 4, 0)
    tf, tc = tptpool.render_pool(ts, (eye, U, V, W), SIDE, SIDE, 4, 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.05
    assert _pixels_within(a, b, PT_PIXEL_RTOL) >= PT_PIXEL_SHARE
    assert abs(a.mean() - b.mean()) <= MEAN_RTOL * abs(b.mean())


def test_sky_lights_the_pt_render(sky, tmp_path):
    """Without the sky (its raster zeroed by env_lum 0) PT sees only the
    quad: the sky's escape radiance and env NEE must raise the mean."""
    ts, uvw = sky["ts"], sky["uvw"]
    dark, _, _ = load_trace_scene(
        write_sky_floor(str(tmp_path), direction=True, env_lum=0.0), "cpu")
    assert dark.has_env and float(dark.env.tex.abs().max()) > 0  # the sun
    lit = tpt.render_frame(ts, uvw, SIDE, SIDE, 1, max_depth=8).mean()
    # env_lum scales the raster, not the baked Direction light
    off = tpt.render_frame(dark, uvw, SIDE, SIDE, 1, max_depth=8).mean()
    assert lit >= 1.1 * off, (float(lit), float(off))


@pytest.fixture(scope="module")
def light_paths(sky):
    jts, jss = sky["jts"], sky["jss"]
    trace = lambda ss: jax.jit(lambda: jlt.trace_light_paths(
        jts, ss, N_PATHS, 7919, max_depth=LIGHT_DEPTH))()
    return {"spcbpt": trace(jss), "bdpt": trace(jcls.untrained_state())}


def test_trace_light_paths_matches_jax(sky, light_paths):
    """Env start vertices (is_env, disk origins, no 1/t^2 on their first
    segment) and the vertices after them."""
    ts, tss = sky["ts"], sky["tss"]
    jlv = light_paths["spcbpt"]
    tlv = tlt.trace_light_paths(ts, tss, N_PATHS, 7919,
                                max_depth=LIGHT_DEPTH)
    valid = tlv.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jlv.valid))
    is_env = tlv.is_env.numpy()[0]
    np.testing.assert_array_equal(is_env, np.asarray(jlv.is_env)[0])
    assert 0.3 < is_env.mean() < 0.7
    # env sub-paths that reach the floor carry is_ll_direction
    assert tlv.is_ll_direction.numpy()[1][valid[1]].any()
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
def test_render_pool_matches_jax(sky, light_paths, alg):
    """One frame at 16x16, 1 spp on the JAX LVC carried over: env
    connections (targets 10r out) and the escape weight."""
    jts, ts, (eye, U, V, W) = sky["jts"], sky["ts"], sky["uvw"]
    jss, tss = sky["jss"], sky["tss"]
    uniform = alg == "bdpt"
    if uniform:
        jss, tss = jcls.untrained_state(), tcls.untrained_state()
    jlv = light_paths[alg]
    jsampler = jlvc.make_builder(None if uniform else jss)(jlv, 0)
    tsampler = tlvc.make_builder(None if uniform else tss)(
        from_jax_vertices(jlv, "cpu"), 0)
    jf, jc = jsppool.render_pool_jit(jts, jss, jsampler, eye, U, V, W, SIDE,
                                     SIDE, 1, 0, uniform=uniform)
    tf, tc = tsppool.render_pool(ts, tss, tsampler, (eye, U, V, W), SIDE,
                                 SIDE, 1, 0, uniform=uniform)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.05
    assert abs(a.mean() - b.mean()) <= MEAN_RTOL * abs(b.mean())
    assert _pixels_within(a, b, SP_PIXEL_RTOL) >= SP_PIXEL_SHARE


def test_pretrace_launch_matches_jax(sky):
    """One launch: env NEE records (is_dir, targets 10r out) and their
    projected-disk pdf in the backward walk."""
    jts, ts, uvw = sky["jts"], sky["ts"], sky["uvw"]
    jb = jax.jit(jpre.make_pretracer(uvw, PRETRACE_LANES))(jts, 0)
    tb = tpre.to_host(tpre.make_pretracer(uvw, PRETRACE_LANES)(ts, 0))
    jvalid, jn = np.asarray(jb.valid), np.asarray(jb.n_conns)
    agree = ((tb.valid == jvalid) & (tb.n_conns == jn)).mean()
    assert agree >= PRETRACE_AGREE, agree
    assert tb.valid.mean() > 0.2
    # some accepted paths end on the sky, whose records are directions
    ls = tb.light_source & tb.conn_valid
    env_src = ls & (tb.label_b >= 1000 - 100)
    assert env_src.any()
    both = tb.valid & jvalid & (tb.n_conns == jn)
    np.testing.assert_allclose(tb.contri[both], np.asarray(jb.contri)[both],
                               rtol=PATH_RTOL, atol=1e-6)


def test_render_cli_trains_spcbpt_from_the_sky(tmp_path):
    """The floor alone gives every pretraced path one surface vertex, and
    the light classifier no vertex to learn from (in either package): the
    back wall makes paths bounce."""
    import json

    path = write_sky_floor(str(tmp_path), direction=True, wall=True)
    stats_path = tmp_path / "s.json"
    assert render_cli.main([
        "--device", "cpu", "--scene", path, "--alg", "spcbpt",
        "--train-samples", "2000", "--q-samples", "4000", "--light-paths",
        "2000", "--dim", "16x16", "--spp", "1", "--out",
        str(tmp_path / "s.png"), "--stats-json", str(stats_path)]) == 0
    s = json.loads(stats_path.read_text())
    assert s["finite"] and s["mean_radiance"] > 0.05
    assert s["train"]["n_paths"] >= 2000 and s["train"]["q_paths"] >= 4000

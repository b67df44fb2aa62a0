"""The port's recursive-MIS connection math (render/rmis.py and the
connection evaluators of render/spcbpt.py) against the JAX package on the
same vertex batch, under every second-stage calibration, plus the eye
sub-path tracer trace_eye_paths.

The eye and light sub-paths are traced once by the port on Cornell under
the synthetic trained state; both packages then evaluate the same vertices
(carried to JAX as numpy arrays) with the same state (carried to the port
with from_jax_state)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.render import rmis as jrmis
from spcbpt_tpu.render import spcbpt as jsp
from spcbpt_tpu.render import vertex as jvertex
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu_torch.render import light_trace as tlt
from spcbpt_tpu_torch.render import rmis as trmis
from spcbpt_tpu_torch.render import spcbpt as tsp
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify as tcls

torch.set_num_threads(1)

N_LANES = 400
MAX_EYE = 3
MAX_LIGHT = 3
CALIBRATIONS = ["weighted", "uniform", "mixture"]
# The same float32 formulas in both packages; XLA's CPU compiler contracts
# multiply-adds into FMAs and torch does not, and the BSDF's pow/sqrt/exp
# may differ in the last ulp. Chains of ~100 operations then agree to
# ~1e-6 relative; divisions by small pdfs amplify that on a few lanes.
RTOL = 1e-4
MIN_CLOSE = 0.999    # share of lanes within RTOL_TIGHT
RTOL_TIGHT = 1e-5
# Traced sub-paths compound those ulps bounce after bounce, and a grazing
# cosine or a short segment amplifies them: 1e-2 on every lane, 1e-4 on
# 99% of them.
PATH_RTOL = 1e-2
PATH_RTOL_TIGHT = 1e-4
PATH_MIN_CLOSE = 0.99


@pytest.fixture(scope="module")
def setup():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    ts = from_jax_scene(jts, "cpu")
    jss = jcls.synthetic_trained_state(jts, seed=7)
    tss = tcls.from_jax_state(jss, "cpu")
    eye, U, V, W = cam.uvw()
    o, d, state = camera_rays(eye, U, V, W, 21, 21, 3)
    o, d, state = o[:N_LANES], d[:N_LANES], state[:N_LANES]
    rec = tsp.trace_eye_paths(ts, tss, o, d, state, MAX_EYE)
    lvs = tlt.trace_light_paths(ts, tss, N_LANES, 0, max_depth=MAX_LIGHT)
    return jts, ts, jss, tss, (o, d, state), rec, lvs


def _states(setup, calibration):
    _, _, jss, tss, _, _, _ = setup
    return (jss.replace(second_stage=calibration),
            tss.replace(second_stage=calibration))


def _to_jax(record, cls):
    return cls(**{f.name: jnp.asarray(getattr(record, f.name).numpy())
                  for f in dataclasses.fields(record)})


def _at(record, i):
    return type(record)(**{f.name: getattr(record, f.name)[i]
                           for f in dataclasses.fields(record)})


def _close(got, ref, valid, rtol=RTOL, rtol_tight=RTOL_TIGHT,
           min_close=MIN_CLOSE, min_lanes=20):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    ok = np.asarray(valid)
    if got.ndim > ok.ndim:
        ok = ok[..., None] & np.ones(got.shape, bool)
    ok = ok & np.isfinite(ref)
    assert ok.sum() >= min_lanes
    g, r = got[ok], ref[ok]
    scale = max(np.abs(r).max(), 1e-30)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=1e-6 * scale)
    tight = np.abs(g - r) <= rtol_tight * np.abs(r) + 1e-7 * scale
    assert tight.mean() >= min_close, tight.mean()


def _eye(setup, m):
    rec = setup[5]
    v = _at(rec["v"], m - 1)
    valid = rec["valid"][:m].all(dim=0)
    return v, valid


@pytest.mark.parametrize("calibration", CALIBRATIONS)
@pytest.mark.parametrize("m,l", [(1, 0), (2, 0), (1, 1), (2, 2), (3, 1)])
def test_connect_vertex_fused_matches_jax(setup, calibration, m, l):
    jts, ts, _, _, _, _, lvs = setup
    jss, tss = _states(setup, calibration)
    eye_v, valid = _eye(setup, m)
    light_v = _at(lvs, l)
    valid = valid & light_v.valid
    ratio = torch.from_numpy(
        np.random.default_rng(m + 3 * l).uniform(0.2, 2.0, (N_LANES, 3))
        .astype(np.float32))
    teye = tsp._ConnEye(eye_v, ratio)
    jeye = jsp._ConnEye(_to_jax(eye_v, jrmis.EyeVertices),
                        jnp.asarray(ratio.numpy()))
    jlight = _to_jax(light_v, jvertex.LightVertices)

    got = tsp.connect_vertex_fused(ts, tss, teye, light_v)
    ref = jsp.connect_vertex_fused(jts, jss, jeye, jlight)
    _close(got, ref, valid)
    got = tsp.connect_vertex(ts, tss, teye, light_v)
    ref = jsp.connect_vertex(jts, jss, jeye, jlight)
    _close(got, ref, valid)

    # the precomputed-argument route the renderer takes
    pmf1 = tcls.gamma_block(tss, eye_v.subspace_id, light_v.subspace_id)
    parts = trmis.tracing_weight_eye_parts(ts, tss, eye_v, eye_v.position)
    wb = trmis.tracing_weight_light(ts, tss, light_v, eye_v.position)
    got = tsp.connect_vertex_fused(ts, tss, teye, light_v, pmf1=pmf1,
                                   eye_parts=parts, weight_b=wb)
    jv = jeye._v
    ref = jsp.connect_vertex_fused(
        jts, jss, jeye, jlight,
        pmf1=jcls.gamma_block(jss, jv.subspace_id, jlight.subspace_id),
        eye_parts=jrmis.tracing_weight_eye_parts(jts, jss, jv, jv.position),
        weight_b=jrmis.tracing_weight_light(jts, jss, jlight, jv.position))
    _close(got, ref, valid)


@pytest.mark.parametrize("calibration", CALIBRATIONS)
@pytest.mark.parametrize("m", [1, 2, 3])
def test_tracing_update_and_light_hit_cached_match_jax(setup, calibration, m):
    """tracing_update_eye, light_hit_cached (fed as the renderers feed it)
    and the from-scratch light_hit, toward the light source's origin
    vertices."""
    jts, ts, _, _, _, _, lvs = setup
    jss, tss = _states(setup, calibration)
    eye_v, valid = _eye(setup, m)
    jeye = _to_jax(eye_v, jrmis.EyeVertices)
    lv0 = _at(lvs, 0)
    flux = lv0.ratio * lv0.single_pdf[..., None]
    conn = lv0.position - eye_v.position
    in_dir = conn / torch.linalg.norm(conn, dim=-1, keepdim=True)
    cos_last = torch.abs((eye_v.normal * in_dir).sum(-1))
    inv_t2 = 1.0 / torch.clamp((conn * conn).sum(-1), min=1e-20)
    lb = eye_v.last_position - eye_v.position
    lb = lb / torch.clamp(torch.linalg.norm(lb, dim=-1, keepdim=True),
                          min=1e-20)
    pending = trmis._pdf_at(ts, eye_v, lb, in_dir) * trmis._rr(eye_v)
    j = lambda x: jnp.asarray(x.numpy())

    r3, ru = trmis.tracing_update_eye(ts, tss, eye_v, lv0.position,
                                      torch.zeros_like(lv0.valid),
                                      in_dir=in_dir)
    jr3, jru = jrmis.tracing_update_eye(jts, jss, jeye, j(lv0.position),
                                        j(torch.zeros_like(lv0.valid)),
                                        in_dir=j(in_dir))
    _close(r3, jr3, valid)
    _close(ru, jru, valid)

    args = (cos_last, inv_t2, pending, lv0.normal, flux, lv0.single_pdf,
            lv0.subspace_id)
    got = trmis.light_hit_cached(tss, eye_v, r3, ru, in_dir, *args)
    ref = jrmis.light_hit_cached(jss, jeye, jr3, jru, j(in_dir),
                                 *(j(a) for a in args))
    _close(got, ref, valid)
    got = trmis.light_hit(ts, tss, eye_v, lv0.position, lv0.normal, flux,
                          lv0.single_pdf, lv0.subspace_id)
    ref = jrmis.light_hit(jts, jss, jeye, j(lv0.position), j(lv0.normal),
                          j(flux), j(lv0.single_pdf), j(lv0.subspace_id))
    _close(got, ref, valid)


def test_connect_rate_and_mix_coeffs_match_jax(setup):
    _, _, jss, tss, _, _, _ = setup
    rng = np.random.default_rng(1)
    e = rng.integers(0, 1000, 2048).astype(np.int32)
    l = rng.integers(0, 1000, 2048).astype(np.int32)
    lum = rng.uniform(0.1, 5.0, 2048).astype(np.float32)
    for calibration in CALIBRATIONS + ["untrained"]:
        if calibration == "untrained":
            js, ts_ = jcls.untrained_state(), tcls.untrained_state()
        else:
            js, ts_ = _states(setup, calibration)
        assert trmis.mix_coeffs(ts_) == jrmis.mix_coeffs(js)
        got = trmis.connect_rate(ts_, torch.from_numpy(e), torch.from_numpy(l),
                                 torch.from_numpy(lum))
        ref = jrmis.connect_rate(js, jnp.asarray(e), jnp.asarray(l),
                                 jnp.asarray(lum))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_env_combiners_raise(setup):
    _, ts, _, tss, _, rec, _ = setup
    with pytest.raises(NotImplementedError, match="environment"):
        trmis.light_hit_env_cached(ts, tss, None, None, None, None, None,
                                   None, None, None, None)
    with pytest.raises(NotImplementedError, match="environment"):
        trmis.light_hit_env(ts, tss, None, None, None, None, None)


def test_trace_eye_paths_matches_jax(setup):
    """The port's eye sub-paths (the renderer's loop body without
    connections) against JAX's on the same camera rays and seeds: validity
    and labels exact, floats on valid lanes within RTOL."""
    jts, ts, jss, tss, (o, d, state), rec, _ = setup
    jrec = jax.jit(lambda o, d, s: jsp.trace_eye_paths(
        jts, jss, o, d, s, MAX_EYE))(jnp.asarray(o.numpy()),
                                     jnp.asarray(d.numpy()),
                                     jnp.asarray(state.numpy(), jnp.uint32))
    valid = rec["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jrec["valid"]))
    tol = dict(rtol=PATH_RTOL, rtol_tight=PATH_RTOL_TIGHT,
               min_close=PATH_MIN_CLOSE)
    assert valid[0].mean() > 0.5
    for f in dataclasses.fields(rec["v"]):
        got = getattr(rec["v"], f.name).numpy()
        ref = np.asarray(getattr(jrec["v"], f.name))
        if got.dtype in (np.int32, np.bool_):
            np.testing.assert_array_equal(got[valid], ref[valid],
                                          err_msg=f.name)
        else:
            _close(torch.from_numpy(got), ref, valid, **tol)
    _close(rec["ratio"], jrec["ratio"], valid, **tol)

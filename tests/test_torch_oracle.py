"""The port's full-path MIS oracle (render/oracle.py) against JAX's, and the
port's cached recursive-MIS weights (render/rmis.py, render/spcbpt.py)
against the port's oracle: the checks of tests/test_rmis_oracle.py, held
against the port's own modules, on Cornell under one second-stage
calibration (weighted).

Eye and light sub-paths are traced by the port under the synthetic trained
state; complete paths are assembled for every (eye length, light length)
combination, and the O(1) cached combiners must agree with the oracle's
recomputation of every strategy's weight, within the JAX file's gates. A
perturbed cache must fall outside them."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.render import oracle as joracle
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu_torch.render import light_trace as tlt
from spcbpt_tpu_torch.render import oracle
from spcbpt_tpu_torch.render import rmis
from spcbpt_tpu_torch.render import spcbpt
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify as tcls

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

MAX_EYE = 3    # surface vertices on the eye chain
MAX_LIGHT = 3  # bounces on the light chain (depth index)
N_LANES = 400
GATE_MAX, GATE_MEAN = 0.05, 0.01      # as tests/test_rmis_oracle.py
PARITY_RTOL, PARITY_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def setup():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    ts = from_jax_scene(jts, "cpu")
    jss = jcls.synthetic_trained_state(jts, seed=7).replace(
        second_stage="weighted")
    ss = tcls.from_jax_state(jss, "cpu")
    assert ss.trained and ss.inv_occ is not None
    eye, U, V, W = cam.uvw()
    o, d, state = camera_rays(eye, U, V, W, 21, 21, 3)
    o, d, state = o[:N_LANES], d[:N_LANES], state[:N_LANES]
    rec = spcbpt.trace_eye_paths(ts, ss, o, d, state, MAX_EYE)
    lvs = tlt.trace_light_paths(ts, ss, N_LANES, 0, max_depth=MAX_LIGHT)
    return jts, ts, jss, ss, (o, d), rec, lvs


def _at(record, i):
    return type(record)(**{f.name: getattr(record, f.name)[i]
                           for f in dataclasses.fields(record)})


def _build_path(od, rec, lvs, m, l):
    """Complete path SoA for eye chain length m (surface hits) + light chain
    suffix of depth l. Vertex 0 = camera; vertex size-1 = light origin."""
    o, d = od
    n = o.shape[0]
    size = m + l + 2
    eye = [_at(rec["v"], i) for i in range(m)]
    light = [_at(lvs, j) for j in range(l, -1, -1)]
    verts = eye + light
    lv0 = _at(lvs, 0)
    valid = rec["valid"][:m].all(dim=0)
    for j in range(1, l + 1):
        valid = valid & lvs.valid[j]
    path = dict(
        position=torch.stack([o] + [v.position for v in verts], dim=1),
        normal=torch.stack([d] + [v.normal for v in verts], dim=1),
        color=torch.stack([torch.ones_like(o)] + [v.color for v in verts],
                          dim=1),
        mat_id=torch.stack([torch.zeros((n,), dtype=torch.int32)]
                           + [v.mat_id for v in verts], dim=1),
        size=torch.full((n,), size, dtype=torch.int32),
        # origin vertices: cumulative pdf == single_pdf, so the raw emission
        # is ratio * single_pdf
        light_flux=lv0.ratio * lv0.single_pdf[..., None],
        light_pdf=lv0.single_pdf,
        light_subspace=lv0.subspace_id,
    )
    return path, valid, size


def _oracle_ratio(ts, ss, path, strategy, size):
    num = oracle.mis_weight_spcbpt(ts, ss, path, strategy, size)
    den = torch.zeros_like(num)
    for i in range(2, size + 1):
        den = den + oracle.mis_weight_spcbpt(ts, ss, path, i, size)
    return num / torch.clamp(den, min=1e-30)


def _compare(cached, expect, valid, floor=1e-3):
    cached, expect, valid = (x.numpy() for x in (cached, expect, valid))
    ok = valid & np.isfinite(cached) & np.isfinite(expect) & (expect > floor)
    assert ok.sum() >= 20, f"too few valid lanes: {ok.sum()}"
    rel = np.abs(cached[ok] - expect[ok]) / np.maximum(expect[ok], floor)
    return rel, ok


def _gates(rel, ok, what):
    assert rel.max() < GATE_MAX, (
        f"{what}: max rel err {rel.max():.4f} over {ok.sum()} lanes")
    assert rel.mean() < GATE_MEAN, f"{what}: mean rel err {rel.mean():.5f}"


# ---- (a) the port's oracle equals JAX's on the same paths ----

@pytest.mark.parametrize("m,l", [(1, 0), (2, 1), (1, 2), (3, 1)])
def test_oracle_matches_jax(setup, m, l):
    jts, ts, jss, ss, od, rec, lvs = setup
    path, valid, size = _build_path(od, rec, lvs, m, l)
    jpath = {k: jnp.asarray(v.numpy()) for k, v in path.items()}
    ok = valid.numpy()
    assert ok.sum() >= 20

    def same(got, ref, what):
        got, ref = got.numpy()[ok], np.asarray(ref)[ok]
        np.testing.assert_allclose(got, ref, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL, err_msg=what)

    # JAX runs op by op here: eval_path, which recomputes every strategy's
    # weight, is compared at the connection strategy alone
    full = lambda s: jnp.full_like(jpath["size"], s)
    same(oracle.contri_compute(ts, path, size),
         joracle.contri_compute(jts, jpath, size), "contri")
    for s in range(1, size + 1):
        same(oracle.pdf_compute(ts, path, s, size),
             joracle.pdf_compute(jts, jpath, full(s), size), f"pdf s={s}")
        same(oracle.suffix_value(ts, path, s, size),
             joracle.suffix_value(jts, jpath, full(s), size),
             f"suffix s={s}")
        same(oracle.mis_weight_spcbpt(ts, ss, path, s, size),
             joracle.mis_weight_spcbpt(jts, jss, jpath, full(s), size),
             f"mis s={s}")
    same(oracle.eval_path(ts, ss, path, m + 1, size),
         joracle.eval_path(jts, jss, jpath, full(m + 1), size), "eval_path")


# ---- (b) the port's cached weights against the port's oracle ----

@pytest.mark.parametrize("m,l", [(1, 1), (2, 1), (1, 2), (2, 2), (3, 1)])
def test_general_connection_matches_oracle(setup, m, l):
    _, ts, _, ss, od, rec, lvs = setup
    path, valid, size = _build_path(od, rec, lvs, m, l)
    cached = rmis.general_connection(ts, ss, _at(rec["v"], m - 1),
                                     _at(lvs, l))
    _gates(*_compare(cached, _oracle_ratio(ts, ss, path, m + 1, size), valid),
           f"m={m} l={l}")


@pytest.mark.parametrize("m", [1, 2, 3])
def test_light_source_connection_matches_oracle(setup, m):
    _, ts, _, ss, od, rec, lvs = setup
    path, valid, size = _build_path(od, rec, lvs, m, 0)
    cached = rmis.connection_light_source(ts, ss, _at(rec["v"], m - 1),
                                          _at(lvs, 0))
    _gates(*_compare(cached, _oracle_ratio(ts, ss, path, m + 1, size), valid),
           f"m={m}")


@pytest.mark.parametrize("m", [1, 2])
def test_emitter_hit_matches_oracle(setup, m):
    """The pure-eye (BSDF emitter hit) strategy: light_hit for an eye chain
    that lands on the light-origin point vs the oracle's strategy_id ==
    size weight."""
    _, ts, _, ss, od, rec, lvs = setup
    path, valid, size = _build_path(od, rec, lvs, m, 0)
    lv0 = _at(lvs, 0)
    cached = rmis.light_hit(ts, ss, _at(rec["v"], m - 1), lv0.position,
                            lv0.normal, lv0.ratio * lv0.single_pdf[..., None],
                            lv0.single_pdf, lv0.subspace_id)
    _gates(*_compare(cached, _oracle_ratio(ts, ss, path, size, size), valid),
           f"m={m}")


@pytest.mark.parametrize("m", [1, 2, 3])
def test_light_hit_cached_matches(setup, m):
    """light_hit_cached, fed as the renderers feed it, equals the
    from-scratch light_hit."""
    _, ts, _, ss, _, rec, lvs = setup
    eye_v = _at(rec["v"], m - 1)
    lv0 = _at(lvs, 0)
    flux = lv0.ratio * lv0.single_pdf[..., None]
    conn_vec = lv0.position - eye_v.position
    in_dir = conn_vec / torch.linalg.norm(conn_vec, dim=-1, keepdim=True)
    cos_last = torch.abs((eye_v.normal * in_dir).sum(-1))
    inv_t2 = 1.0 / torch.clamp((conn_vec * conn_vec).sum(-1), min=1e-20)
    lb = eye_v.last_position - eye_v.position
    lb = lb / torch.clamp(torch.linalg.norm(lb, dim=-1, keepdim=True),
                          min=1e-20)
    pending = rmis._pdf_at(ts, eye_v, lb, in_dir) * rmis._rr(eye_v)
    r3, ru = rmis.tracing_update_eye(ts, ss, eye_v, lv0.position,
                                     torch.zeros_like(lv0.valid),
                                     in_dir=in_dir)
    cached = rmis.light_hit_cached(ss, eye_v, r3, ru, in_dir, cos_last,
                                   inv_t2, pending, lv0.normal, flux,
                                   lv0.single_pdf, lv0.subspace_id)
    expect = rmis.light_hit(ts, ss, eye_v, lv0.position, lv0.normal, flux,
                            lv0.single_pdf, lv0.subspace_id)
    c, e = cached.numpy(), expect.numpy()
    ok = (rec["valid"][:m].all(dim=0).numpy() & np.isfinite(c)
          & np.isfinite(e) & (e > 1e-6))
    assert ok.sum() >= 20
    np.testing.assert_allclose(c[ok], e[ok], rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("m,l", [(1, 0), (2, 0), (1, 1), (2, 2), (3, 1)])
def test_connect_vertex_fused_matches(setup, m, l):
    """connect_vertex_fused reproduces connect_vertex, bare and with every
    precomputed argument the renderer passes."""
    _, ts, _, ss, _, rec, lvs = setup
    eye_v = _at(rec["v"], m - 1)
    light_v = _at(lvs, l)
    eye = spcbpt._ConnEye(eye_v, torch.ones_like(eye_v.position))
    orig = spcbpt.connect_vertex(ts, ss, eye, light_v).numpy()
    valid = (rec["valid"][:m].all(dim=0) & light_v.valid).numpy()
    ok = valid & np.isfinite(orig).all(axis=-1)
    assert ok.sum() >= 20
    atol = 1e-6 * max(1.0, np.abs(orig[ok]).max())
    fused = spcbpt.connect_vertex_fused(ts, ss, eye, light_v).numpy()
    np.testing.assert_allclose(fused[ok], orig[ok], rtol=2e-4, atol=atol)
    fast = spcbpt.connect_vertex_fused(
        ts, ss, eye, light_v,
        pmf1=tcls.gamma_block(ss, eye_v.subspace_id, light_v.subspace_id),
        eye_parts=rmis.tracing_weight_eye_parts(ts, ss, eye_v,
                                                eye_v.position),
        weight_b=rmis.tracing_weight_light(ts, ss, light_v, eye_v.position))
    np.testing.assert_allclose(fast.numpy()[ok], orig[ok], rtol=2e-4,
                               atol=atol)


def test_is_brdf_zeroes_weight(setup):
    """Specular vertices force the connection weight to 0 (rmis.h:65-67,
    213-216)."""
    _, ts, _, ss, _, rec, lvs = setup
    eye_v = _at(rec["v"], 0)
    light_v = _at(lvs, 1)
    eye_brdf = dataclasses.replace(eye_v,
                                   is_brdf=torch.ones_like(eye_v.is_brdf))
    assert rmis.general_connection(ts, ss, eye_brdf, light_v).abs().max() == 0
    light_brdf = dataclasses.replace(
        light_v, is_brdf=torch.ones_like(light_v.is_brdf))
    assert rmis.general_connection(ts, ss, eye_v, light_brdf).abs().max() == 0


def test_perturbed_rmis_cache_is_detected(setup):
    """The comparison has teeth: corrupting the cached RMIS accumulators
    pushes the error far over the gates."""
    _, ts, _, ss, od, rec, lvs = setup
    m, l = 2, 1
    path, valid, size = _build_path(od, rec, lvs, m, l)
    expect = _oracle_ratio(ts, ss, path, m + 1, size)
    eye_v = _at(rec["v"], m - 1)
    light_v = _at(lvs, l)
    bad_eye = dataclasses.replace(eye_v, rmis3=eye_v.rmis3 * 1.5 + 0.05)
    rel, _ = _compare(rmis.general_connection(ts, ss, bad_eye, light_v),
                      expect, valid)
    assert rel.max() > GATE_MAX, "perturbed eye rmis chain not detected"

    # light side: a deeper light vertex (l=2) whose rmis pointer carries
    # accumulated strategies
    m2, l2 = 1, 2
    path2, valid2, size2 = _build_path(od, rec, lvs, m2, l2)
    expect2 = _oracle_ratio(ts, ss, path2, m2 + 1, size2)
    eye_v2 = _at(rec["v"], m2 - 1)
    light_v2 = _at(lvs, l2)
    rel_ok, _ = _compare(rmis.general_connection(ts, ss, eye_v2, light_v2),
                         expect2, valid2)
    assert rel_ok.max() < GATE_MAX
    bad_light = dataclasses.replace(light_v2, rmis=light_v2.rmis * 5.0 + 0.5)
    rel2, _ = _compare(rmis.general_connection(ts, ss, eye_v2, bad_light),
                       expect2, valid2)
    assert rel2.max() > GATE_MAX, "perturbed light rmis not detected"

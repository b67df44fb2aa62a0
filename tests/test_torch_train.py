"""The port's subspace-training modules against the JAX package on the same
inputs: train/qgamma.py (Q, reweighting, Gamma init, CMF), train/
gamma_train.py (training data, outlier clamp, loss and gradient, Adam
steps), render/autotune.py, pretrace._build_path_info on identical
buffers, and one pretrace launch on Cornell."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.config import NUM_SUBSPACE
from spcbpt_tpu.render import autotune as jauto
from spcbpt_tpu.render import vertex as jvertex
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import gamma_train as jgt
from spcbpt_tpu.train import pretrace as jpt
from spcbpt_tpu.train import qgamma as jqg
from spcbpt_tpu_torch.render import autotune as tauto
from spcbpt_tpu_torch.render import vertex as tvertex
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import gamma_train as tgt
from spcbpt_tpu_torch.train import pretrace as tpt
from spcbpt_tpu_torch.train import qgamma as tqg

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

P, C = 4096, 10
# Elementwise formulas and scatter-add sums over the same arrays: XLA and
# torch add in different orders and XLA contracts multiply-adds, so values
# differ by a few ulps; 1e-5 relative bounds them (sums of up to ~40k
# terms). Counts and labels are exact.
QG_RTOL = 1e-5
# XLA on the CPU flushes float32 subnormals to zero, torch keeps them
# (peak / Q_INF is ~1e-39): values below 1e-30 are taken as equal.
SUBNORMAL = 1e-30
# The loss is a sum over 512 paths of f/den, its gradient a scatter-add
# through the row normalisation of a 1000x1000 sigmoid: 1e-4 relative,
# entries below 1e-6 of the largest taken absolutely (cancellation).
GRAD_RTOL = 1e-4
GRAD_ATOL_REL = 1e-6
# Adam steps: the per-step losses to 1e-4 relative, the final Gamma (rows of
# 1000 entries near 1e-3) to 1e-4 relative and 1e-9 absolute: torch.optim
# .Adam and optax.adam compute m_hat / (sqrt(v_hat) + eps) in a different
# order, ulps that five steps of lr 0.01 keep small.
STEP_RTOL = 1e-4
GAMMA_RTOL = 1e-4
GAMMA_ATOL = 1e-9
# _build_path_info on identical buffers: products of up to nine segments'
# pdfs and BSDF values, FMA contractions on the XLA side: 1e-4 relative,
# 1e-6 of a field's largest value absolute; ints and flags exact.
PATH_RTOL = 1e-4
PATH_ATOL_REL = 1e-6
# One pretrace launch: the same seeds, the same formulas, but the ulps of
# the bounces compound (as in the light-trace tests): at least 99% of the
# lanes agree on valid and n_conns; on those, floats within 1e-2 relative
# and 99% of them within 1e-4, ints and flags exact.
LANE_AGREE = 0.99
LAUNCH_RTOL = 1e-2
LAUNCH_RTOL_TIGHT = 1e-4
LAUNCH_MIN_CLOSE = 0.99
LAUNCH_LANES = 1024


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _batch(seed=0, p=P, c=C):
    """A PretraceBatch of numpy arrays from a seed, with NaN, inf and zero
    entries where the functions guard against them."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    contri = f32(rng.lognormal(-2.0, 1.5, (p, 3)))
    contri[5] = np.inf
    contri[11, 1] = np.nan
    sample_pdf = f32(rng.lognormal(0.0, 2.0, p))
    sample_pdf[7] = 0.0
    # an outlier past the clamp's first 1000 paths
    out = min(2000, p - 1)
    contri[out], sample_pdf[out] = 30.0, 1e-4
    fix_pdf = f32(rng.lognormal(-1.0, 2.0, p) * (rng.random(p) > 0.05))
    fix_pdf[13] = np.inf
    fix_pdf[out] = 1e-6
    unit = lambda: f32(rng.normal(size=(p, c, 3)))
    label_a = rng.integers(0, NUM_SUBSPACE, (p, c)).astype(np.int32)
    label_b = rng.integers(0, NUM_SUBSPACE, (p, c)).astype(np.int32)
    label_a[3, 0], label_b[4, 1] = -1, NUM_SUBSPACE + 5
    conn_valid = rng.random((p, c)) < 0.6
    conn_valid[out] = False
    return jpt.PretraceBatch(
        contri=contri, sample_pdf=sample_pdf, fix_pdf=fix_pdf,
        n_conns=rng.integers(0, c, p).astype(np.int32),
        pixel=rng.integers(0, 65536, (p, 2)).astype(np.int32),
        valid=rng.random(p) < 0.95,
        a_position=unit(), a_normal=unit(), a_dir=unit(),
        b_position=unit(), b_normal=unit(), b_dir=unit(),
        peak_pdf=f32(rng.lognormal(-1.0, 2.0, (p, c))),
        label_a=label_a, label_b=label_b,
        light_source=rng.random((p, c)) < 0.2, conn_valid=conn_valid)


def _q(seed=1):
    rng = np.random.default_rng(seed)
    q = rng.lognormal(0.0, 1.0, NUM_SUBSPACE).astype(np.float32)
    q[::50] = 0.0
    q[7::50] = float(jqg.Q_INF)
    return q


def _light_vertices(seed=2, depth=9, n=2048):
    """A JAX LightVertices of numpy-seeded fields (what q_batch reads:
    ratio, subspace_id, valid, depth; the rest filled) and the port's."""
    rng = np.random.default_rng(seed)
    kw = {}
    for f in dataclasses.fields(jvertex.LightVertices):
        if f.name in ("position", "normal", "ratio", "color",
                      "last_position"):
            kw[f.name] = rng.lognormal(-1.0, 1.5, (depth, n, 3)).astype(
                np.float32)
        elif f.name in ("mat_id", "eye_label", "last_zone_id"):
            kw[f.name] = np.zeros((depth, n), np.int32)
        elif f.name in ("is_origin", "is_env", "is_ll_direction", "is_brdf",
                        "last_brdf"):
            kw[f.name] = np.zeros((depth, n), bool)
        else:
            kw[f.name] = rng.random((depth, n)).astype(np.float32)
    kw["ratio"][2, 3] = np.nan
    kw["ratio"][3, 4] = np.inf
    kw["subspace_id"] = rng.integers(-3, NUM_SUBSPACE + 3,
                                     (depth, n)).astype(np.int32)
    kw["depth"] = np.broadcast_to(np.arange(depth, dtype=np.int32)[:, None],
                                  (depth, n)).copy()
    kw["valid"] = rng.random((depth, n)) < np.linspace(1.0, 0.2, depth)[:, None]
    jlv = jvertex.LightVertices(**{k: jnp.asarray(v) for k, v in kw.items()})
    return jlv, tvertex.from_jax_vertices(jlv, "cpu")


def _qgamma_case(name):
    """(JAX outputs, port outputs) of one qgamma function on the same
    numpy-seeded inputs."""
    b = _batch()
    jb = lambda f: jnp.asarray(getattr(b, f))
    tb = lambda f: torch.from_numpy(np.asarray(getattr(b, f)))
    if name == "sample_reweight":
        args = ("contri", "sample_pdf", "pixel")
        return (jqg.sample_reweight(*map(jb, args), 512, 384),
                tqg.sample_reweight(*map(tb, args), 512, 384))
    if name == "gamma_init":
        args = ("label_a", "label_b", "conn_valid", "contri", "sample_pdf")
        return jqg.gamma_init(*map(jb, args)), tqg.gamma_init(*map(tb, args))
    if name == "q_batch":
        jlv, tlv = _light_vertices()
        return jqg.q_batch(jlv), tqg.q_batch(tlv)
    if name == "q_update":
        rng = np.random.default_rng(3)
        mean = rng.random(NUM_SUBSPACE).astype(np.float32)
        qsum = (rng.random(NUM_SUBSPACE) * 100).astype(np.float32)
        acc, bp = np.int32(123_457), np.int32(40_961)
        return (jqg.q_update(jnp.asarray(mean), jnp.asarray(acc),
                             jnp.asarray(qsum), jnp.asarray(bp)),
                tqg.q_update(torch.from_numpy(mean), torch.tensor(acc),
                             torch.from_numpy(qsum), torch.tensor(bp)))
    if name == "q_finalize":
        q = _q()
        q[q > 1e30] = 0.0
        return jqg.q_finalize(jnp.asarray(q)), \
            tqg.q_finalize(torch.from_numpy(q))
    if name == "inv_occ_finalize":
        occ = np.random.default_rng(4).integers(0, 50, NUM_SUBSPACE).astype(
            np.float32)
        return (jqg.inv_occ_finalize(jnp.asarray(occ), jnp.int32(9_001)),
                tqg.inv_occ_finalize(torch.from_numpy(occ),
                                     torch.tensor(9_001, dtype=torch.int32)))
    assert name == "gamma_to_cmf"
    g = np.random.default_rng(5).random((NUM_SUBSPACE, NUM_SUBSPACE))
    g = (g / g.sum(1, keepdims=True)).astype(np.float32)
    return jqg.gamma_to_cmf(jnp.asarray(g)), \
        tqg.gamma_to_cmf(torch.from_numpy(g))


@pytest.mark.parametrize("name", ["sample_reweight", "gamma_init", "q_batch",
                                  "q_update", "q_finalize",
                                  "inv_occ_finalize", "gamma_to_cmf"])
def test_qgamma_matches_jax(name):
    jout, tout = _qgamma_case(name)
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    for j, t in zip(jout, tout):
        j, t = np.asarray(j), _np(t)
        # non-finite inputs pass through where the JAX function lets them
        assert t.shape == j.shape and np.isfinite(t).mean() > 0.99, name
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
        if j.dtype.kind in "iub":
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            assert t.dtype == j.dtype, (name, t.dtype)
            np.testing.assert_allclose(t, j, rtol=QG_RTOL, err_msg=name)


def _train_data(seed=0, p=P):
    b = _batch(seed, p)
    q = _q()
    jtd = jgt.clamp_outliers(jgt.build_train_data(
        jpt.PretraceBatch(*map(jnp.asarray, b)), jnp.asarray(q),
        jnp.asarray(b.label_a), jnp.asarray(b.label_b)))
    tb = tpt.PretraceBatch(*[torch.from_numpy(np.asarray(x)) for x in b])
    ttd = tgt.clamp_outliers(tgt.build_train_data(
        tb, torch.from_numpy(q), tb.label_a, tb.label_b))
    return b, jtd, ttd


def test_build_train_data_and_clamp_match_jax():
    b, jtd, ttd = _train_data()
    raw = tgt.build_train_data(
        tpt.PretraceBatch(*[torch.from_numpy(np.asarray(x)) for x in b]),
        torch.from_numpy(_q()), torch.from_numpy(b.label_a),
        torch.from_numpy(b.label_b))
    assert not torch.equal(raw.f_square, ttd.f_square)   # the clamp bites
    for f in jgt.GammaTrainData._fields:
        j, t = np.asarray(getattr(jtd, f)), _np(getattr(ttd, f))
        assert t.shape == j.shape and np.isfinite(t).all(), f
        if j.dtype.kind in "iub":
            np.testing.assert_array_equal(t, j, err_msg=f)
        else:
            np.testing.assert_allclose(t, j, rtol=QG_RTOL, atol=SUBNORMAL,
                                       err_msg=f)
    carried = tgt.from_jax_train_data(jtd, "cpu")
    for f in jgt.GammaTrainData._fields:
        np.testing.assert_array_equal(_np(getattr(carried, f)),
                                      np.asarray(getattr(jtd, f)))


def test_loss_and_gradient_match_jax():
    _, jtd, _ = _train_data(p=512)
    td = tgt.from_jax_train_data(jtd, "cpu")
    theta = np.random.default_rng(6).normal(
        size=(NUM_SUBSPACE, NUM_SUBSPACE)).astype(np.float32)
    jl, jg = jax.value_and_grad(jgt.loss_fn)(jnp.asarray(theta), jtd)
    th = torch.from_numpy(theta).requires_grad_(True)
    tl = tgt.loss_fn(th, td)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=GRAD_RTOL)
    jg, tg = np.asarray(jg), th.grad.numpy()
    assert np.isfinite(tg).all() and np.abs(tg).max() > 0
    np.testing.assert_allclose(tg, jg, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * np.abs(jg).max())


def test_train_gamma_matches_jax():
    """Five Adam steps over fixed slices of 512 paths from the same Gamma
    and data: the losses of every step and the final Gamma."""
    b, jtd, _ = _train_data(p=5 * 512 + 100)
    td = tgt.from_jax_train_data(jtd, "cpu")
    g0 = jqg.gamma_init(*[jnp.asarray(getattr(b, f)) for f in
                          ("label_a", "label_b", "conn_valid", "contri",
                           "sample_pdf")])
    jgam, jloss = jgt.train_gamma(g0, jtd, lr=0.01, batch_size=512)
    tgam, tloss = tgt.train_gamma(torch.tensor(np.asarray(g0)), td,
                                  lr=0.01, batch_size=512)
    assert len(tloss) == len(jloss) == 5
    np.testing.assert_allclose(tloss, jloss, rtol=STEP_RTOL)
    tgam, jgam = tgam.numpy(), np.asarray(jgam)
    assert not np.allclose(tgam, np.asarray(g0), rtol=1e-3)   # it moved
    np.testing.assert_allclose(tgam, jgam, rtol=GAMMA_RTOL, atol=GAMMA_ATOL)
    np.testing.assert_allclose(tgam.sum(1), 1.0, rtol=1e-5)


def test_zero_denominators_give_finite_theta():
    """Valid lanes whose denominators are all zero (f_square, pdf0 and peak
    0, as in tests/test_gamma_train.py) keep the gradient and the trained
    Gamma finite."""
    p = 128
    td = tgt.GammaTrainData(
        f_square=torch.zeros(p), pdf0=torch.zeros(p),
        peak=torch.zeros((p, 3)),
        label_e=torch.zeros((p, 3), dtype=torch.int32),
        valid=torch.ones(p, dtype=torch.bool))
    theta = torch.zeros((NUM_SUBSPACE, NUM_SUBSPACE), requires_grad=True)
    tgt.loss_fn(theta, td).backward()
    assert torch.isfinite(theta.grad).all()
    g0 = torch.full((NUM_SUBSPACE, NUM_SUBSPACE), 1.0 / NUM_SUBSPACE)
    gamma, losses = tgt.train_gamma(g0, td, batch_size=64)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert torch.isfinite(gamma).all()
    # NaN gradient entries are zeroed before the step, as optax.zero_nans()
    nan_td = td._replace(f_square=torch.full((p,), float("nan")))
    gamma, _ = tgt.train_gamma(g0, nan_td, batch_size=p)
    assert torch.isfinite(gamma).all()


@pytest.mark.parametrize("case", ["low_dr", "high_dr", "mixed", "few"])
def test_select_second_stage_matches_jax(case):
    rng = np.random.default_rng(7)
    q = rng.lognormal(0.0, {"low_dr": 0.1, "high_dr": 2.0,
                            "mixed": 0.5, "few": 0.1}[case], NUM_SUBSPACE)
    inv_occ = rng.uniform(0.5, 2.0, NUM_SUBSPACE)
    q[::9] = float(jqg.Q_INF)
    inv_occ[::11] = 0.0
    if case == "few":           # fewer than 8 usable subspaces
        inv_occ[7:] = 0.0
    q, inv_occ = q.astype(np.float32), inv_occ.astype(np.float32)
    jm, js = jauto.select_second_stage(q, inv_occ)
    tm, ts = tauto.select_second_stage(q, inv_occ)
    assert tm == jm and ts == js
    expect = {"low_dr": "weighted", "high_dr": "uniform", "few": "uniform"}
    if case in expect:
        assert tm == expect[case], (case, ts)
    if case == "few":
        assert ts["n"] < 8 and ts["flux_dr"] == float("inf")


@pytest.fixture(scope="module")
def cornell():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    return jts, from_jax_scene(jts, "cpu"), cam.uvw()


def _path_buffers(n_mats, seed=8, n=512, c=C):
    """Eye-vertex buffers and a light record of numpy-seeded values in the
    layout of make_pretracer's buffers."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    unit = lambda *s: (lambda v: f32(v / np.linalg.norm(v, axis=-1,
                                                        keepdims=True)))(
        rng.normal(size=s + (3,)))
    buf = dict(position=f32(rng.uniform(-1, 1, (n, c, 3))),
               normal=unit(n, c), dir=unit(n, c),
               color=f32(rng.uniform(0.05, 1.0, (n, c, 3))),
               flux=f32(rng.lognormal(0.0, 1.0, (n, c, 3))),
               mat_id=rng.integers(0, n_mats, (n, c)).astype(np.int32),
               pdf=f32(rng.lognormal(0.0, 1.0, (n, c))),
               depth=np.broadcast_to(np.arange(c, dtype=np.int32),
                                     (n, c)).copy())
    k = rng.integers(1, c + 1, n).astype(np.int32)
    light = dict(position=f32(rng.uniform(-1, 1, (n, 3)) + [0, 2, 0]),
                 normal=unit(n), weight=f32(rng.uniform(1, 20, (n, 3))),
                 pdf=f32(rng.lognormal(0.0, 1.0, n)),
                 label=rng.integers(800, 1000, n).astype(np.int32),
                 is_dir=rng.random(n) < 0.1)
    return buf, k, light


def _assert_fields_close(name, got, ref, rtol, atol_rel):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=name)
        return
    assert np.array_equal(np.isfinite(got), np.isfinite(ref)), name
    ok = np.isfinite(ref)
    scale = max(np.abs(ref[ok]).max(), 1e-30) if ok.any() else 1.0
    np.testing.assert_allclose(got[ok], ref[ok], rtol=rtol,
                               atol=atol_rel * scale, err_msg=name)


def test_build_path_info_matches_jax(cornell):
    """Identical eye buffers and light records in both packages: every
    field of the path and of its connection records."""
    jts, ts, _ = cornell
    buf, k, light = _path_buffers(ts.mats.base_color.shape[0])
    jpath, jconn = jpt._build_path_info(
        jts, {kk: jnp.asarray(v) for kk, v in buf.items()}, jnp.asarray(k),
        {kk: jnp.asarray(v) for kk, v in light.items()})
    tpath, tconn = tpt._build_path_info(
        ts, {kk: torch.from_numpy(v) for kk, v in buf.items()},
        torch.from_numpy(k), {kk: torch.from_numpy(v)
                              for kk, v in light.items()})
    assert set(tpath) == set(jpath) and set(tconn) == set(jconn)
    assert np.asarray(jconn["conn_valid"]).sum(1).max() == C - 1
    for name in jpath:
        _assert_fields_close(name, tpath[name], jpath[name], PATH_RTOL,
                             PATH_ATOL_REL)
    for name in jconn:
        _assert_fields_close(name, tconn[name], jconn[name], PATH_RTOL,
                             PATH_ATOL_REL)


@pytest.fixture(scope="module")
def launches(cornell):
    jts, _, uvw = cornell
    jlaunch = jax.jit(jpt.make_pretracer(uvw, LAUNCH_LANES))
    return {f: jax.device_get(jlaunch(jts, f)) for f in (0, 1)}


@pytest.mark.parametrize("frame", [0, 1])
def test_pretrace_launch_matches_jax(cornell, launches, frame):
    """One launch of 1,024 lanes on Cornell, the same frame in both
    packages."""
    _, ts, uvw = cornell
    jb = launches[frame]
    tb = tpt.make_pretracer(uvw, LAUNCH_LANES)(ts, frame)
    assert all(x.shape[0] == LAUNCH_LANES for x in tb)
    tv, jv = tb.valid.numpy(), np.asarray(jb.valid)
    tn, jn = tb.n_conns.numpy(), np.asarray(jb.n_conns)
    agree = (tv == jv) & (tn == jn)
    assert agree.mean() >= LANE_AGREE, agree.mean()
    assert jv.mean() > 0.3 and (jn[jv] > 1).any()
    lanes = agree & jv
    for name in tpt.PretraceBatch._fields:
        got = _np(getattr(tb, name))[lanes]
        ref = np.asarray(getattr(jb, name))[lanes]
        assert got.dtype == ref.dtype, name
        if ref.dtype.kind in "iub":
            np.testing.assert_array_equal(got, ref, err_msg=name)
            continue
        ok = np.isfinite(ref)
        assert np.array_equal(np.isfinite(got), ok), name
        scale = max(np.abs(ref[ok]).max(), 1e-30)
        np.testing.assert_allclose(got[ok], ref[ok], rtol=LAUNCH_RTOL,
                                   atol=1e-6 * scale, err_msg=name)
        tight = np.abs(got[ok] - ref[ok]) <= (
            LAUNCH_RTOL_TIGHT * np.abs(ref[ok]) + 1e-7 * scale)
        assert tight.mean() >= LAUNCH_MIN_CLOSE, (name, tight.mean())


def test_from_jax_batch_is_exact(launches):
    jb = launches[0]
    tb = tpt.from_jax_batch(jb, "cpu")
    for name in tpt.PretraceBatch._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    host = tpt.to_host(tb)
    assert all(isinstance(x, np.ndarray) for x in host)

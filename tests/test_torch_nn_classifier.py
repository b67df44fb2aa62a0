"""The close-set network (spcbpt_tpu_torch/train/nn_classifier.py) against
the JAX package: its functions on the same numpy inputs, Adam training step
by step, the blended first stage of lvc.sample_first_stage with its RNG
stream, and checkpoints of a state that carries the network, both ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu import checkpoint as jckpt
from spcbpt_tpu.config import NUM_SUBSPACE
from spcbpt_tpu.render import lvc as jlvc
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.train import gamma_train as jgt
from spcbpt_tpu.train import nn_classifier as jnn
from spcbpt_tpu.utils import rng as jrng
from spcbpt_tpu_torch import checkpoint as tckpt
from spcbpt_tpu_torch.render import lvc as tlvc
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.train import gamma_train as tgt
from spcbpt_tpu_torch.train import nn_classifier as tnn
from spcbpt_tpu_torch.utils import rng as trng

torch.set_num_threads(1)

N = 2048
# The same f32 formulas: sin/cos and the per-lane products differ in the
# last ulps between XLA and torch (measured 1.5e-7 on probabilities).
ATOL = 1e-6
# Gradients of one loss (measured 3e-9 absolute on entries up to 1e-2).
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-8
# Adam, step by step: losses (measured 5e-6 relative after 15 steps) and
# the final weights (measured 4e-6 absolute).
LOSS_RTOL = 1e-4
WEIGHT_ATOL = 1e-5
# The blended first stage: the close-set pick sits on a float cumsum of a
# temperature softmax, whose ulps may move a pick across a boundary.
PICK_AGREE = 0.999
PMF_RTOL = 1e-5
HIST_SIGMAS = 4.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _gamma(rng, lo=0.0):
    g = rng.uniform(lo, 1, (NUM_SUBSPACE, NUM_SUBSPACE)).astype(np.float32)
    return g / g.sum(1, keepdims=True)


@pytest.fixture(scope="module")
def net():
    rng = np.random.default_rng(0)
    gamma = _gamma(rng)
    jst = jnn.init_params(np.random.default_rng(1), gamma)
    tst = tnn.init_params(np.random.default_rng(1), gamma)
    pos = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    nrm = rng.normal(size=(N, 3)).astype(np.float32)
    eye = rng.integers(0, NUM_SUBSPACE, N).astype(np.int32)
    feats = np.asarray(jnn.encode(jnp.asarray(pos), jnp.asarray(nrm),
                                  jnp.zeros(3), jnp.ones(3)))
    return dict(rng=rng, gamma=gamma, jst=jst, tst=tst, pos=pos, nrm=nrm,
                eye=eye, feats=feats)


def _batch(net, n=N):
    rng = np.random.default_rng(7)
    _, ids = jnn.forward(net["jst"], jnp.asarray(net["eye"]),
                         jnp.asarray(net["feats"]))
    # three quarters of the lanes inside their close set
    light = np.where(rng.random(n) < 0.75,
                     np.asarray(ids)[np.arange(n),
                                     rng.integers(0, jnn.CLOSE_SET, n)],
                     rng.integers(0, NUM_SUBSPACE, n)).astype(np.int32)
    return dict(eye_label=net["eye"], feats=net["feats"], light_label=light,
                f_square=rng.uniform(0.5, 1, n).astype(np.float32),
                pdf0=rng.uniform(0.01, 0.1, n).astype(np.float32),
                peak=rng.uniform(0.5, 2, n).astype(np.float32))


def test_init_params_equal_jax(net):
    assert tnn.CLOSE_SET == jnn.CLOSE_SET and tnn.HIDDEN == jnn.HIDDEN
    assert tnn.ENC_FREQS == jnn.ENC_FREQS
    assert tnn.TEMPERATURE == jnn.TEMPERATURE
    assert tnn.feature_dim() == jnn.feature_dim()
    for a, b in zip(net["jst"].params, net["tst"].params):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(net["tst"].close_set.numpy(),
                                  np.asarray(net["jst"].close_set))
    assert net["tst"].close_set.dtype == torch.int32


def test_encode_matches_jax(net):
    lo, hi = np.array([-1.0, 0.5, 0.0], np.float32), np.array(
        [2.0, 0.5, 4.0], np.float32)   # a flat axis: the 1e-6 floor
    pos = net["pos"] * 3 - 1
    j = jnn.encode(jnp.asarray(pos), jnp.asarray(net["nrm"]),
                   jnp.asarray(lo), jnp.asarray(hi))
    t = tnn.encode(_t(pos), _t(net["nrm"]), _t(lo), _t(hi))
    assert t.shape == (N, tnn.feature_dim())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def test_forward_matches_jax(net):
    jp, ji = jnn.forward(net["jst"], jnp.asarray(net["eye"]),
                         jnp.asarray(net["feats"]))
    tp, ti = tnn.forward(net["tst"], _t(net["eye"]), _t(net["feats"]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_close_probs_and_pmf_match_jax(net):
    """close_probs clips the eye label (labels past both ends here);
    close_pmf_of is 0 outside the close set."""
    eye = net["eye"].copy()
    eye[:8] = -3
    eye[8:16] = NUM_SUBSPACE + 5
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    jnt = jnn.tables_from_state(net["jst"], lo, hi)
    tnt = tnn.tables_from_state(net["tst"], lo, hi)
    jp, ji = jnn.close_probs(jnt, jnp.asarray(eye), jnp.asarray(net["pos"]),
                             jnp.asarray(net["nrm"]))
    tp, ti = tnn.close_probs(tnt, _t(eye), _t(net["pos"]), _t(net["nrm"]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    light = _batch(net)["light_label"]
    jm = jnn.close_pmf_of(jp, ji, jnp.asarray(light))
    tm = tnn.close_pmf_of(tp, ti, _t(light))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=ATOL)
    assert (tm.numpy() == 0).mean() > 0.2 and (tm.numpy() > 0).mean() > 0.5


def test_refined_gamma_row_matches_jax(net):
    j = jnn.refined_gamma_row(net["jst"], jnp.asarray(net["gamma"]),
                              jnp.asarray(net["eye"]),
                              jnp.asarray(net["feats"]), blend=0.3)
    t = tnn.refined_gamma_row(net["tst"], _t(net["gamma"]), _t(net["eye"]),
                              _t(net["feats"]), blend=0.3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.sum(-1).numpy(), 1.0, rtol=1e-4)


def test_second_moment_loss_and_gradients_match_jax(net):
    b = _batch(net)
    jl, jg = jax.value_and_grad(jnn.second_moment_loss)(
        net["jst"].params, net["jst"].close_set, jnp.asarray(net["gamma"]),
        {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [p.clone().requires_grad_(True) for p in net["tst"].params]
    tl = tnn.second_moment_loss(tnn.NNParams(*leaves), net["tst"].close_set,
                                _t(net["gamma"]),
                                {k: _t(v) for k, v in b.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=GRAD_RTOL)
    for name, a, p in zip(tnn.NNParams._fields, jg, leaves):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(a),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_train_matches_jax(net):
    b = _batch(net)
    jst, jl = jnn.train(net["jst"], jnp.asarray(net["gamma"]),
                        [{k: jnp.asarray(v) for k, v in b.items()}] * 15,
                        lr=3e-3)
    tst, tl = tnn.train(net["tst"], _t(net["gamma"]),
                        [{k: _t(v) for k, v in b.items()}] * 15, lr=3e-3)
    assert len(tl) == len(jl) == 15 and tl[-1] < tl[0] * 0.9
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for name, a, p in zip(tnn.NNParams._fields, jst.params, tst.params):
        np.testing.assert_allclose(p.numpy(), np.asarray(a), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=name)
    np.testing.assert_array_equal(tst.close_set.numpy(),
                                  np.asarray(jst.close_set))


def _corpus(n_paths, conns=10, seed=11):
    """A pretrace-shaped corpus: GammaTrainData of both packages and the
    per-connection endpoints and labels; a tenth of the paths invalid, the
    peaks of empty slots 0, a few labels past the ends (clipped)."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n_paths) > 0.1
    live = rng.random((n_paths, conns)) < 0.6
    peak = np.where(live, rng.uniform(0.1, 2, (n_paths, conns)), 0.0)
    la = rng.integers(0, NUM_SUBSPACE, (n_paths, conns)).astype(np.int32)
    lb = rng.integers(0, NUM_SUBSPACE, (n_paths, conns)).astype(np.int32)
    la[0, 0], lb[1, 1] = -2, NUM_SUBSPACE + 3
    f32 = lambda a: np.asarray(a, np.float32)
    jtd = jgt.GammaTrainData(
        f_square=jnp.asarray(f32(rng.uniform(0.1, 1, n_paths))),
        pdf0=jnp.asarray(f32(rng.uniform(0.01, 0.2, n_paths))),
        peak=jnp.asarray(f32(peak)),
        label_e=jnp.zeros((n_paths, conns), jnp.int32),
        valid=jnp.asarray(valid))
    return dict(jtd=jtd, ttd=tgt.from_jax_train_data(jtd, "cpu"),
                pos=f32(rng.uniform(-1, 3, (n_paths, conns, 3))),
                nrm=f32(rng.normal(size=(n_paths, conns, 3))), la=la, lb=lb)


def test_train_from_corpus_matches_jax(net):
    """Full batches only (the last 300 paths dropped), divided by the valid
    count, clipped labels; loss by loss and the final tables."""
    c = _corpus(3 * 512 + 300)
    mixed = _gamma(np.random.default_rng(5), lo=0.1)
    lo, hi = np.array([-1, -1, -1], np.float32), np.array([3, 3, 3],
                                                          np.float32)
    jst = jnn.init_params(np.random.default_rng(12345), mixed)
    tst = tnn.init_params(np.random.default_rng(12345), mixed)
    kw = dict(blend=0.5, lr=1e-3, batch_size=512, epochs=2)
    jnt, jl = jnn.train_from_corpus(jst, mixed, c["jtd"], c["pos"], c["nrm"],
                                    c["la"], c["lb"], lo, hi, **kw)
    tnt, tl = tnn.train_from_corpus(tst, mixed, c["ttd"], c["pos"], c["nrm"],
                                    c["la"], c["lb"], lo, hi, **kw)
    assert len(tl) == len(jl) == 6 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for name in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(getattr(tnt, name).numpy(),
                                   np.asarray(getattr(jnt, name)), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=name)
    for name in ("close_set", "scene_lo", "scene_hi"):
        np.testing.assert_array_equal(getattr(tnt, name).numpy(),
                                      np.asarray(getattr(jnt, name)))
    assert tnt.blend == jnt.blend == 0.5


def _nn_state(seed=3, blend=0.5):
    """The JAX test's state: random Gamma rows, alias tables, a network
    from init_params over [0, 1]^3 (tests/test_nn_classifier.py)."""
    rng = np.random.default_rng(seed)
    gamma = _gamma(rng, lo=0.1)
    st = jnn.init_params(rng, gamma)
    nt = jnn.tables_from_state(st, np.zeros(3), np.ones(3), blend=blend)
    aprob, aidx = jcls.build_alias(gamma)
    cmf = np.cumsum(gamma, axis=1).astype(np.float32)
    cmf[:, -1] = 1.0
    jss = jcls.publish_tables(jcls.SubspaceState(
        eye=jcls.dummy_classifier(), light=jcls.dummy_classifier(),
        q=jnp.ones((NUM_SUBSPACE,)), cmf_gamma=jnp.asarray(cmf),
        alias_prob=jnp.asarray(aprob), alias_idx=jnp.asarray(aidx),
        inv_occ=jnp.ones((NUM_SUBSPACE,)), nn=nt, trained=True))
    return jss, tcls.from_jax_state(jss, "cpu"), gamma


def test_from_jax_state_carries_the_network():
    jss, tss, _ = _nn_state(blend=0.3)
    assert isinstance(tss.nn, tnn.NNTables) and tss.nn.blend == 0.3
    for name in ("w1", "b1", "w2", "b2", "close_set", "scene_lo",
                 "scene_hi"):
        np.testing.assert_array_equal(getattr(tss.nn, name).numpy(),
                                      np.asarray(getattr(jss.nn, name)))
    assert tss.nn.close_set.dtype == torch.int32


def test_first_stage_nn_matches_jax():
    """2^14 lanes, eye labels and vertices drawn at random: the RNG states
    after the draw equal (r_sel, r_cl, then the alias row's draw), the
    picks agree on PICK_AGREE of the lanes and their pmfs within
    PMF_RTOL."""
    jss, tss, _ = _nn_state()
    n = 1 << 14
    rng = np.random.default_rng(4)
    eye = rng.integers(0, NUM_SUBSPACE, n).astype(np.int32)
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    lane = np.arange(n, dtype=np.uint32)
    jl, jp, js = jax.jit(lambda e, p, q, s: jlvc.sample_first_stage(
        jss, e, s, position=p, normal=q))(
        jnp.asarray(eye), jnp.asarray(pos), jnp.asarray(nrm),
        jrng.seed(jnp.asarray(lane), jnp.uint32(9)))
    tl, tp, ts = tlvc.sample_first_stage(
        tss, _t(eye), trng.seed(_t(lane.astype(np.int64)), 9),
        position=_t(pos), normal=_t(nrm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tl.dtype == torch.int32
    same = tl.numpy() == np.asarray(jl)
    assert same.mean() >= PICK_AGREE, same.mean()
    np.testing.assert_allclose(tp.numpy()[same], np.asarray(jp)[same],
                               rtol=PMF_RTOL)
    # without the eye vertex the network is not consulted: one draw
    tl0, _, ts0 = tlvc.sample_first_stage(
        tss, _t(eye), trng.seed(_t(lane.astype(np.int64)), 9))
    _, one = trng.next_float(trng.seed(_t(lane.astype(np.int64)), 9))
    assert torch.equal(ts0, one)


def test_blended_first_stage_pmf_matches_histogram():
    """The reported pmf is the exact density of the blended draw (the
    unbiasedness contract), as JAX's histogram test, at 2^16 lanes of one
    eye vertex: pmf equal to the analytic mixture (rtol 2e-4); the
    histogram of the close-set labels (which hold half the mass, bins of
    0.005-0.03) within HIST_SIGMAS standard errors of a binomial draw of
    2^16 (5.5% of a 0.005 bin; the chance that one of 32 exact bins falls
    outside is 2e-4)."""
    _, tss, gamma = _nn_state()
    n, row = 1 << 16, 17
    eye = torch.full((n,), row, dtype=torch.int32)
    pos = torch.tensor([[0.3, 0.6, 0.2]]).expand(n, 3)
    nrm = torch.tensor([[0.0, 1.0, 0.0]]).expand(n, 3)
    state = trng.seed(torch.arange(n, dtype=torch.int64), 9)
    l, pmf, _ = tlvc.sample_first_stage(tss, eye, state, position=pos,
                                        normal=nrm)
    l, pmf = l.numpy(), pmf.numpy()
    probs, ids = tnn.close_probs(tss.nn, eye[:1], pos[:1], nrm[:1])
    analytic = 0.5 * gamma[row].astype(np.float64)
    analytic[ids[0].numpy()] += 0.5 * probs[0].double().numpy()
    np.testing.assert_allclose(pmf, analytic[l], rtol=2e-4, atol=1e-7)
    hist = np.bincount(l, minlength=NUM_SUBSPACE) / n
    big = ids[0].numpy()
    se = np.sqrt(analytic[big] * (1 - analytic[big]) / n)
    z = np.abs(hist[big] - analytic[big]) / se
    assert z.max() <= HIST_SIGMAS, z
    np.testing.assert_allclose(analytic.sum(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_nn_checkpoints_cross_both_ways(direction, tmp_path):
    jss, tss, _ = _nn_state(blend=0.4)
    path = str(tmp_path / "nn.npz")
    if direction == "port_to_jax":
        tckpt.save_subspace_state(path, tss)
        got, ref = jckpt.load_subspace_state(path), tss
        keys = set(np.load(path).files)
        assert {"nn_w1", "nn_b1", "nn_w2", "nn_b2", "nn_close_set",
                "nn_scene_lo", "nn_scene_hi", "nn_blend"} <= keys
    else:
        jckpt.save_subspace_state(path, jss)
        got, ref = tckpt.load_subspace_state(path), jss
        assert got.nn.close_set.dtype == torch.int32
    assert got.nn is not None and got.nn.blend == ref.nn.blend == 0.4
    for name in ("w1", "b1", "w2", "b2", "close_set", "scene_lo",
                 "scene_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(got.nn, name)),
                                      np.asarray(getattr(ref.nn, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(got.cmf_gamma),
                                  np.asarray(ref.cmf_gamma))

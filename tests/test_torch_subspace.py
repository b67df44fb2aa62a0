"""The port's subspace state (train/classify.py, train/qgamma.gamma_to_cmf,
checkpoint.py) against the JAX package: labels, Gamma CMFs, alias tables,
published tables, the synthetic trained state, and npz checkpoints both
ways."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu import checkpoint as jckpt
from spcbpt_tpu.config import NUM_SUBSPACE
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.train import qgamma as jqg
from spcbpt_tpu_torch import checkpoint as tckpt
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.train import qgamma as tqg

torch.set_num_threads(1)

# Row CMFs are float32 cumulative sums over 1000 columns; XLA and torch
# add in different orders, so entries differ by a few ulps of 1 (the
# largest value): 4e-7 absolute. Everything built in numpy is exact.
CMF_ATOL = 4e-7
TABLES = ("q", "cmf_gamma", "alias_prob", "alias_idx", "inv_occ",
          "gamma_pmf", "alias_pack")


@pytest.fixture(scope="module")
def states():
    """Cornell in both packages, the JAX synthetic trained state, the same
    state carried over, and the port's own synthetic state."""
    jts, _, _ = jload(default_scene_path())
    ts = from_jax_scene(jts, "cpu")
    jss = jcls.synthetic_trained_state(jts, seed=3)
    return jts, ts, jss, tcls.from_jax_state(jss, "cpu"), \
        tcls.synthetic_trained_state(ts, seed=3)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_from_jax_state_is_exact(states):
    _, _, jss, carried, _ = states
    for f in TABLES:
        np.testing.assert_array_equal(_np(getattr(carried, f)),
                                      _np(getattr(jss, f)), err_msg=f)
    for side in ("eye", "light"):
        a, b = getattr(carried, side), getattr(jss, side)
        for f in ("centers_pos", "centers_norm", "diag2"):
            np.testing.assert_array_equal(_np(getattr(a, f)),
                                          _np(getattr(b, f)))
        assert a.label_bias == b.label_bias
    assert carried.trained and carried.second_stage == jss.second_stage


def test_synthetic_trained_state_matches_jax(states):
    """Same seed, same draws: classifiers, Q, inv_occ and the alias tables
    are equal; the CMF and the tables derived from it agree to CMF_ATOL."""
    _, _, jss, _, ss = states
    assert ss.trained and ss.second_stage == "mixture"
    for f in ("q", "alias_prob", "alias_idx", "inv_occ"):
        np.testing.assert_array_equal(_np(getattr(ss, f)),
                                      _np(getattr(jss, f)), err_msg=f)
    for side in ("eye", "light"):
        for f in ("centers_pos", "centers_norm", "diag2"):
            np.testing.assert_array_equal(_np(getattr(getattr(ss, side), f)),
                                          _np(getattr(getattr(jss, side), f)))
    for f in ("cmf_gamma", "gamma_pmf", "alias_pack"):
        np.testing.assert_allclose(_np(getattr(ss, f)), _np(getattr(jss, f)),
                                   rtol=0, atol=CMF_ATOL, err_msg=f)
    assert ss.eye.centers_pos.shape == (NUM_SUBSPACE, 3)
    assert ss.light.centers_pos.shape == (tcls.NUM_LIGHT_TREE_SUBSPACE, 3)


def test_gamma_to_cmf_matches_jax():
    g = np.random.default_rng(4).uniform(0, 1, (NUM_SUBSPACE, NUM_SUBSPACE))
    g = (g / g.sum(1, keepdims=True)).astype(np.float32)
    got = tqg.gamma_to_cmf(torch.from_numpy(g)).numpy()
    ref = np.asarray(jqg.gamma_to_cmf(jnp.asarray(g)))
    assert (got[:, -1] == 1.0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=CMF_ATOL)


def test_build_alias_and_classifier_match_jax():
    """The numpy builders are the JAX package's, bit for bit."""
    rng = np.random.default_rng(7)
    g = rng.uniform(0, 1, (64, 64)) ** 4
    pa, ia = tcls.build_alias(g)
    pb, ib = jcls.build_alias(g)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ia, ib)
    pos = rng.uniform(-1, 1, (500, 3))
    nrm = rng.normal(size=(500, 3))
    w = rng.uniform(0.1, 1.0, 500)
    a = tcls.build_classifier(pos, nrm, w, 32, label_bias=5)
    b = jcls.build_classifier(pos, nrm, w, 32, label_bias=5)
    for f in ("centers_pos", "centers_norm", "diag2"):
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)))
    assert a.label_bias == 5


def test_classify_labels_match_jax(states):
    """Exact nearest-centroid labels on 20,000 points spread over the scene
    box with random normals. The (N,6)x(6,C) score product is float32 in
    both packages but summed in another order, so a label may flip where
    two centroids tie to the last ulp: at least 99.9% agree."""
    jts, ts, jss, carried, _ = states
    rng = np.random.default_rng(11)
    p0 = np.asarray(jts.tri_p0)
    lo, hi = p0.min(0), p0.max(0)
    pos = rng.uniform(lo, hi, (20_000, 3)).astype(np.float32)
    nrm = rng.normal(size=(20_000, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    for side in ("eye", "light"):
        got = tcls.classify(getattr(carried, side), torch.from_numpy(pos),
                            torch.from_numpy(nrm)).numpy()
        ref = np.asarray(jcls.classify(getattr(jss, side), jnp.asarray(pos),
                                       jnp.asarray(nrm)))
        assert got.dtype == np.int32
        assert (got == ref).mean() >= 0.999, side
        assert len(np.unique(got)) > 20
    lab = tcls.label_eye(carried, torch.from_numpy(pos), torch.from_numpy(nrm))
    np.testing.assert_array_equal(
        lab.numpy(), tcls.classify(carried.eye, torch.from_numpy(pos),
                                   torch.from_numpy(nrm)).numpy())


def test_gamma_block_gamma_ss_and_untrained_defaults(states):
    """gamma_block and gamma_ss on the carried state equal JAX exactly, with
    and without the published pmf table; the untrained state labels 0 and
    weighs 1."""
    _, _, jss, carried, _ = states
    rng = np.random.default_rng(5)
    e = rng.integers(0, NUM_SUBSPACE, 4096).astype(np.int32)
    l = rng.integers(0, NUM_SUBSPACE, 4096).astype(np.int32)
    te, tl, je, jl = (torch.from_numpy(e), torch.from_numpy(l),
                      jnp.asarray(e), jnp.asarray(l))
    for tss, jst in ((carried, jss),
                     (carried.replace(gamma_pmf=None),
                      jss.replace(gamma_pmf=None))):
        np.testing.assert_array_equal(tcls.gamma_block(tss, te, tl).numpy(),
                                      np.asarray(jcls.gamma_block(jst, je, jl)))
        np.testing.assert_array_equal(tcls.gamma_ss(tss, te, tl).numpy(),
                                      np.asarray(jcls.gamma_ss(jst, je, jl)))
    un = tcls.untrained_state()
    assert not un.trained and tcls.publish_tables(un) is un
    assert (tcls.gamma_ss(un, te, tl) == 1).all()
    pos = torch.zeros((7, 3))
    assert (tcls.label_light(un, pos, pos) == 0).all()
    np.testing.assert_allclose(un.cmf_gamma.numpy(),
                               np.asarray(jcls.untrained_state().cmf_gamma),
                               rtol=0, atol=CMF_ATOL)


def test_publish_tables_matches_jax(states):
    _, _, jss, carried, _ = states
    bare = carried.replace(gamma_pmf=None, alias_pack=None)
    pub = tcls.publish_tables(bare)
    np.testing.assert_array_equal(pub.gamma_pmf.numpy(), _np(jss.gamma_pmf))
    np.testing.assert_array_equal(pub.alias_pack.numpy(), _np(jss.alias_pack))


def test_checkpoint_jax_to_port(states, tmp_path):
    _, _, jss, _, _ = states
    path = str(tmp_path / "j.npz")
    jckpt.save_subspace_state(path, jss)
    got = tckpt.load_subspace_state(path)
    for f in TABLES:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(jss, f)), err_msg=f)
    assert got.alias_idx.dtype == torch.int32
    assert got.trained and got.second_stage == jss.second_stage


def test_checkpoint_port_to_jax(states, tmp_path):
    _, _, _, _, ss = states
    ss = ss.replace(second_stage="weighted")
    path = str(tmp_path / "t.npz")
    tckpt.save_subspace_state(path, ss)
    got = jckpt.load_subspace_state(path)
    for f in TABLES:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(ss, f)), err_msg=f)
    for f in ("centers_pos", "centers_norm", "diag2"):
        np.testing.assert_array_equal(_np(getattr(got.eye, f)),
                                      _np(getattr(ss.eye, f)))
    assert got.trained and got.second_stage == "weighted"


def test_checkpoint_with_nn_classifier_raises(states, tmp_path):
    _, _, _, _, ss = states
    path = str(tmp_path / "t.npz")
    tckpt.save_subspace_state(path, ss)
    z = dict(np.load(path))
    z["nn_w1"] = np.zeros((6, 4), np.float32)
    np.savez(path, **z)
    with pytest.raises(NotImplementedError, match="nn classifier"):
        tckpt.load_subspace_state(path)

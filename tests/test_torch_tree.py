"""The octree classifier (spcbpt_tpu_torch/train/tree.py) against the JAX
package: build_tree's arrays equal, tree_lookup's labels equal, and the
three properties of tests/test_tree.py held by the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.train import tree as jtree
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.train import tree as ttree

torch.set_num_threads(1)

FIELDS = ("mid", "child", "label", "node_type", "leaf")


def _walls(n, seed):
    """Positions in a 20-unit box and axis normals (scene walls), labelled
    by the nearest of 64 centroids as in tests/test_tree.py."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    normal = axes[rng.integers(0, 6, n)]
    w = rng.uniform(0.1, 1.0, n)
    cls = tcls.build_classifier(pos, normal, w, 64)
    labels = tcls.classify(cls, torch.from_numpy(pos),
                           torch.from_numpy(normal)).numpy()
    return pos, normal, labels, w


@pytest.fixture(scope="module")
def walls():
    pos, normal, labels, w = _walls(6000, 0)
    return pos, normal, labels, w, jtree.build_tree(pos, normal, labels, w), \
        ttree.build_tree(pos, normal, labels, w)


def test_constants_equal_jax():
    for name in ("TYPE_POSITION", "TYPE_NORMAL", "MAX_DEPTH", "PURITY",
                 "MIN_LEAF", "NORMAL_SPLIT_EVERY"):
        assert getattr(ttree, name) == getattr(jtree, name), name


@pytest.mark.parametrize("case", ["walls", "pure", "degenerate"])
def test_build_tree_equals_jax(walls, case):
    """The same host numpy build: every array equal, dtypes included. The
    degenerate case has one normal and a position axis of one value, so
    splits fall back to the other key."""
    if case == "walls":
        jt, tt = walls[4], walls[5]
    else:
        rng = np.random.default_rng(2)
        pos = rng.uniform(0, 8, (3000, 3)).astype(np.float32)
        if case == "degenerate":
            pos[:, 2] = 1.0
        normal = np.tile(np.float32([0, 0, 1]), (3000, 1))
        labels = (pos[:, 0] > 4).astype(np.int64) + 2 * (pos[:, 1] > 2)
        args = (pos, normal, labels, np.ones(3000))
        jt, tt = jtree.build_tree(*args), ttree.build_tree(*args)
    assert len(tt.label) > 1
    for f in FIELDS:
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_tree_lookup_equals_jax(walls):
    """Labels of the training samples and of fresh points, the same as
    JAX's walk on the same tree."""
    pos, normal, _, _, jt, tt = walls
    fresh, fnormal, _, _ = _walls(4000, 9)
    for p, n in ((pos, normal), (fresh, fnormal)):
        j = np.asarray(jtree.tree_lookup(jt, jnp.asarray(p),
                                         jnp.asarray(n)))
        t = ttree.tree_lookup(tt, torch.from_numpy(p), torch.from_numpy(n))
        np.testing.assert_array_equal(t.numpy(), j)


def test_octree_learns_centroid_labels():
    """tests/test_tree.py's first property, through the port: the tree
    built from nearest-centroid labels reproduces them (> 0.90; the
    reference prints ~99% on its own scene data)."""
    pos, normal, labels, w = _walls(20000, 0)
    t = ttree.build_tree(pos, normal, labels, w)
    acc = ttree.tree_accuracy(t, pos, normal, labels)
    assert acc > 0.90, acc


def test_octree_pure_regions_exact():
    rng = np.random.default_rng(1)
    n = 5000
    pos = rng.uniform(0, 8, (n, 3)).astype(np.float32)
    normal = np.tile(np.asarray([0, 0, 1], np.float32), (n, 1))
    labels = (pos[:, 0] > 4).astype(np.int64)
    t = ttree.build_tree(pos, normal, labels, np.ones(n))
    acc = ttree.tree_accuracy(t, pos, normal, labels)
    assert acc > 0.99, acc


def test_classify_matches_float64_oracle():
    """The port's centroid labels against an exact float64 nearest-centroid
    oracle in the cancellation regime (large coordinates, tight spacing),
    as tests/test_tree.py holds JAX's; and equal to JAX's labels."""
    rng = np.random.default_rng(5)
    n, k = 4096, 257
    centers = 1000.0 + rng.normal(size=(k, 3)) * 0.5
    cnorm = rng.normal(size=(k, 3))
    cnorm /= np.linalg.norm(cnorm, axis=-1, keepdims=True)
    pos = 1000.0 + rng.normal(size=(n, 3)) * 0.5
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    diag2 = 0.25
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    c = tcls.Classifier(centers_pos=f32(centers), centers_norm=f32(cnorm),
                        diag2=f32(diag2))
    got = tcls.classify(c, f32(pos), f32(nrm)).numpy()
    p64 = pos.astype(np.float32).astype(np.float64)
    c64 = centers.astype(np.float32).astype(np.float64)
    n64 = (nrm.astype(np.float32) * np.float32(0.5 * diag2)).astype(
        np.float64)
    cn64 = cnorm.astype(np.float32).astype(np.float64)
    score = (c64 * c64).sum(-1)[None, :] - 2.0 * (p64 @ c64.T + n64 @ cn64.T)
    assert (got == score.argmin(axis=-1)).mean() > 0.999
    jc = jcls.Classifier(centers_pos=jnp.asarray(centers, jnp.float32),
                         centers_norm=jnp.asarray(cnorm, jnp.float32),
                         diag2=jnp.asarray(diag2, jnp.float32))
    j = np.asarray(jcls.classify(jc, jnp.asarray(pos, jnp.float32),
                                 jnp.asarray(nrm, jnp.float32)))
    assert (got == j).mean() > 0.999

"""The close-set network in the port's slice as a whole, against the JAX
package on Cornell: training it in fit_from_corpus (nn_train=True) on JAX's
own pretrace corpus against JAX's preprocess, one SPCBPT frame of the
regeneration pool with a state that carries it, and the CLI and the
benchmark with --classifier nn on the CPU."""
import json

import jax
import numpy as np
import pytest
import torch

from spcbpt_tpu import checkpoint as jckpt
from spcbpt_tpu.config import PretraceConfig as JPretraceConfig
from spcbpt_tpu.render import light_trace as jlt
from spcbpt_tpu.render import lvc as jlvc
from spcbpt_tpu.render import spcbpt_pool as jpool
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.train import nn_classifier as jnn
from spcbpt_tpu.train import pipeline as jpipe
from spcbpt_tpu_torch.apps import benchmark, render_cli
from spcbpt_tpu_torch.config import PretraceConfig
from spcbpt_tpu_torch.render import lvc as tlvc
from spcbpt_tpu_torch.render import spcbpt_pool as tpool
from spcbpt_tpu_torch.render.vertex import from_jax_vertices
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.train import pipeline as tpipe
from spcbpt_tpu_torch.train import pretrace as tpt

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

# Cornell at 512x512, 1,024 pretrace lanes, at least 8,400 paths (two
# 4,096-path network batches), Gamma batches of 1,024.
SIZE = dict(num_core=1024, target_samples=8400, target_q_samples=8192)
LT = dict(lt_paths=4096, lt_depth=8, gamma_cfg={"batch_size": 1024})
# Gamma differs from JAX's by ulps (test_torch_pipeline.py: 1e-5), so a
# close set (the top 32 of a mixed row) may order a near-tie otherwise
# (measured: 999 of 1,000 rows equal); the network's losses then follow
# within 1e-4 relative (measured 1e-7) and its weights within 1e-4
# absolute (measured 2e-5, on the row whose close set differs).
CLOSE_ROWS = 0.99
LOSS_RTOL = 1e-4
WEIGHT_ATOL = 1e-4
# One SPCBPT frame on the same LVC, state and seeds, as
# test_torch_spcbpt.py: counts exact, mean within 1e-4 relative, >= 98%
# of pixels within 1e-3 (a close-set pick at a cumsum boundary or a
# flipped label moves a path).
MEAN_RTOL = 1e-4
PIXEL_RTOL = 1e-3
PIXEL_SHARE = 0.98
SIDE = 16


@pytest.fixture(scope="module")
def fitted():
    """JAX's preprocess with the network on Cornell, its pretrace corpus
    recorded, and the port's fit_from_corpus on that corpus."""
    jts, desc, cam = jload(default_scene_path())
    corpus = []
    concat = jpipe._concat_batches

    def recording(batches):
        corpus.append(concat(batches))
        return corpus[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "_concat_batches", recording)
        jss, jstats = jpipe.preprocess(
            jts, cam.uvw(), desc.width, desc.height,
            JPretraceConfig(**SIZE), nn_train=True, **LT)
    data = tpt.PretraceBatch(*[np.asarray(x) for x in corpus[0]])
    ts = from_jax_scene(jts, "cpu")
    tss, tstats = tpipe.fit_from_corpus(
        ts, data, desc.width, desc.height, PretraceConfig(**SIZE),
        nn_train=True, **LT)
    return dict(jss=jss, jstats=jstats, tss=tss, tstats=tstats)


@pytest.mark.parametrize("check", ["losses", "tables", "stats"])
def test_fit_from_corpus_nn_matches_jax(fitted, check):
    jss, tss = fitted["jss"], fitted["tss"]
    jst, tst = fitted["jstats"], fitted["tstats"]
    assert tss.nn is not None and jss.nn is not None
    if check == "losses":
        assert len(tst.nn_losses) == len(jst.nn_losses) == 2
        assert np.isfinite(tst.nn_losses).all()
        np.testing.assert_allclose(tst.nn_losses, jst.nn_losses,
                                   rtol=LOSS_RTOL)
    elif check == "tables":
        same = (tss.nn.close_set.numpy()
                == np.asarray(jss.nn.close_set)).all(1)
        assert same.mean() >= CLOSE_ROWS, same.mean()
        # the scene AABB over p0, p0+e1 and p0+e2 of every triangle
        for name in ("scene_lo", "scene_hi"):
            np.testing.assert_array_equal(getattr(tss.nn, name).numpy(),
                                          np.asarray(getattr(jss.nn, name)))
        for name in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(getattr(tss.nn, name).numpy(),
                                       np.asarray(getattr(jss.nn, name)),
                                       rtol=0, atol=WEIGHT_ATOL,
                                       err_msg=name)
        assert tss.nn.blend == jss.nn.blend == 0.5
    else:
        assert tst.n_paths == jst.n_paths >= SIZE["target_samples"]
        assert tst.seconds["nn"] > 0 and "nn" in jst.seconds
        assert tss.second_stage == jss.second_stage


def test_spcbpt_pool_with_network_matches_jax(tmp_path):
    """One 16x16 frame of the regeneration pool on Cornell under the
    synthetic trained state with a close-set network (blend 0.5) over the
    scene's box: the JAX LVC carried over, samplers built by each
    package, the same seeds."""
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    eye, U, V, W = cam.uvw()
    base = jcls.synthetic_trained_state(jts, seed=0)
    gamma = np.asarray(base.gamma_pmf)
    lo, hi = np.full(3, -0.1, np.float32), np.full(3, 1.1, np.float32)
    nt = jnn.tables_from_state(jnn.init_params(np.random.default_rng(2),
                                               gamma), lo, hi)
    jss = base.replace(nn=nt)
    ts, tss = from_jax_scene(jts, "cpu"), tcls.from_jax_state(jss, "cpu")
    jlv = jax.jit(lambda: jlt.trace_light_paths(jts, jss, 2048, 7919,
                                                max_depth=8))()
    jsampler = jlvc.make_builder(jss)(jlv, 0)
    tsampler = tlvc.make_builder(tss)(from_jax_vertices(jlv, "cpu"), 0)
    jf, jc = jpool.render_pool_jit(jts, jss, jsampler, eye, U, V, W, SIDE,
                                   SIDE, 1, 0)
    tf, tc = tpool.render_pool(ts, tss, tsampler, (eye, U, V, W), SIDE,
                               SIDE, 1, 0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert abs(a.mean() - b.mean()) <= MEAN_RTOL * abs(b.mean())
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    close = (np.where(a == b, 0.0, err) <= PIXEL_RTOL).all(axis=-1).mean()
    assert close >= PIXEL_SHARE, close


def test_render_cli_trains_the_network(tmp_path):
    """--classifier nn trains the network after Gamma and renders with it;
    the checkpoint carries the nn_* arrays and loads in the JAX package."""
    out, stats, state = (tmp_path / "x.png", tmp_path / "s.json",
                         tmp_path / "x.npz")
    assert render_cli.main([
        "--device", "cpu", "--scene", "cornell", "--alg", "spcbpt",
        "--classifier", "nn", "--train-samples", "9000", "--q-samples",
        "4000", "--light-paths", "2000", "--dim", "32x32", "--spp", "1",
        "--checkpoint", str(state), "--out", str(out),
        "--stats-json", str(stats)]) == 0
    s = json.loads(stats.read_text())
    assert s["finite"] and s["count_min"] == s["count_max"] == 1
    assert s["mean_radiance"] > 0
    assert s["phases"]["preprocess"]["nn"] > 0
    losses = s["train"]["nn_losses"]
    assert len(losses) == s["train"]["n_paths"] // 4096 >= 2
    assert np.isfinite(losses).all()
    z = np.load(state)
    assert {"nn_w1", "nn_b1", "nn_w2", "nn_b2", "nn_close_set",
            "nn_scene_lo", "nn_scene_hi", "nn_blend"} <= set(z.files)
    jss = jckpt.load_subspace_state(str(state))
    assert jss.nn is not None and jss.nn.w1.shape == (1000, 27, 32)


def test_benchmark_trains_the_network(tmp_path):
    out = tmp_path / "b.json"
    assert benchmark.main([
        "--device", "cpu", "--scene", "cornell", "--dim", "16x16",
        "--ref-spp", "2", "--spp", "1", "--algs", "spcbpt",
        "--classifier", "nn", "--train-samples", "4200", "--q-samples",
        "2000", "--light-paths", "1000", "--checkpoint",
        str(tmp_path / "s.npz"), "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert np.isfinite(res["algs"]["spcbpt"]["relmse"])
    assert "nn" in res["train_seconds"]
    assert "nn_w1" in np.load(tmp_path / "s.npz").files

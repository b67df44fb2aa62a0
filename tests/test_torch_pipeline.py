"""The port's training pipeline (train/pipeline.py) against the JAX package:
fit_from_corpus on JAX's own pretrace corpus, the port's whole preprocess
against JAX's on Cornell, checkpoints of trained states both ways, and the
render CLI training from the scene alone on the CPU."""
import json

import numpy as np
import pytest
import torch

from spcbpt_tpu import checkpoint as jckpt
from spcbpt_tpu.config import PretraceConfig as JPretraceConfig
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.train import pipeline as jpipe
from spcbpt_tpu_torch import checkpoint as tckpt
from spcbpt_tpu_torch.apps import render_cli
from spcbpt_tpu_torch.config import PretraceConfig
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.train import pipeline as tpipe
from spcbpt_tpu_torch.train import pretrace as tpt

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

# Cornell at its 512x512, 1,024 pretrace lanes, 4,096 paths, 8,192 Q paths
# from 4,096-path light traces of depth 8, Gamma batches of 1,024 (4 steps).
SIZE = dict(num_core=1024, target_samples=4096, target_q_samples=8192)
LT = dict(lt_paths=4096, lt_depth=8, gamma_cfg={"batch_size": 1024})
# Both packages build the classifiers with the same numpy code from the
# same f32 weights, so centres and labels agree almost everywhere (measured
# 100%); Q is a mean of f32 scatter-add sums over the same light vertices
# (measured 1.5e-7 relative): 1e-5; the Adam losses 1e-5 relative (measured
# 3e-7); Gamma's pmf entries are >= 2e-4 (the conservative mixture's
# floor) and differ by ulps of the trained theta (measured 1.7e-6
# absolute): 1e-5 absolute, and the CMF the same.
CENTRE_AGREE = 0.999
LABEL_AGREE = 0.999
Q_RTOL = 1e-5
LOSS_RTOL = 1e-5
GAMMA_ATOL = 1e-5
# The port's own pretrace: the same seeds, paths parting only where ulps
# flip a lane: paths and connections within 1%, Q paths exact.
COUNT_RTOL = 0.01


@pytest.fixture(scope="module")
def trained():
    """JAX's preprocess on Cornell with its pretrace corpus recorded, and
    the port's fit_from_corpus on that corpus."""
    jts, desc, cam = jload(default_scene_path())
    uvw = cam.uvw()
    corpus = []
    concat = jpipe._concat_batches

    def recording(batches):
        out = concat(batches)
        corpus.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "_concat_batches", recording)
        jss, jstats = jpipe.preprocess(jts, uvw, desc.width, desc.height,
                                       JPretraceConfig(**SIZE), **LT)
    data = tpt.PretraceBatch(*[np.asarray(x) for x in corpus[0]])
    ts = from_jax_scene(jts, "cpu")
    tss, tstats = tpipe.fit_from_corpus(ts, data, desc.width, desc.height,
                                        PretraceConfig(**SIZE), **LT)
    return dict(jts=jts, ts=ts, uvw=uvw, desc=desc, data=data, jss=jss,
                jstats=jstats, tss=tss, tstats=tstats)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("check", ["second_stage", "centres", "labels", "q",
                                   "gamma", "losses"])
def test_fit_from_corpus_matches_jax(trained, check):
    jss, tss, data = trained["jss"], trained["tss"], trained["data"]
    assert tss.trained and trained["tstats"].n_paths == trained[
        "jstats"].n_paths == len(data.valid) > 0
    if check == "second_stage":
        assert tss.second_stage == jss.second_stage
        assert trained["tstats"].second_stage == tss.second_stage
    elif check == "centres":
        for side in ("eye", "light"):
            a, b = getattr(tss, side), getattr(jss, side)
            same = ((_np(a.centers_pos) == _np(b.centers_pos)).all(1)
                    & (_np(a.centers_norm) == _np(b.centers_norm)).all(1))
            assert same.mean() >= CENTRE_AGREE, (side, same.mean())
            assert float(a.diag2) == float(b.diag2)
    elif check == "labels":
        for side, pos, nrm in (("eye", data.a_position, data.a_normal),
                               ("light", data.b_position, data.b_normal)):
            p, n = pos.reshape(-1, 3), nrm.reshape(-1, 3)
            t = tcls.classify(getattr(tss, side), torch.from_numpy(p),
                              torch.from_numpy(n)).numpy()
            j = np.asarray(jcls.classify(getattr(jss, side), p, n))
            assert (t == j).mean() >= LABEL_AGREE, side
    elif check == "q":
        q, jq = _np(tss.q), _np(jss.q)
        np.testing.assert_array_equal(q > 1e30, jq > 1e30)
        np.testing.assert_allclose(q, jq, rtol=Q_RTOL)
        np.testing.assert_array_equal(_np(tss.inv_occ) > 0,
                                      _np(jss.inv_occ) > 0)
        np.testing.assert_allclose(_np(tss.inv_occ), _np(jss.inv_occ),
                                   rtol=Q_RTOL)
        assert trained["tstats"].q_paths == trained["jstats"].q_paths
    elif check == "gamma":
        for f in ("cmf_gamma", "gamma_pmf"):
            np.testing.assert_allclose(_np(getattr(tss, f)),
                                       _np(getattr(jss, f)), rtol=0,
                                       atol=GAMMA_ATOL, err_msg=f)
        pmf = _np(tss.gamma_pmf)
        np.testing.assert_allclose(pmf.sum(1), 1.0, rtol=1e-5)
        assert (np.diff(_np(tss.cmf_gamma), axis=1) >= 0).all()
    else:
        t, j = trained["tstats"].gamma_losses, trained["jstats"].gamma_losses
        assert len(t) == len(j) == 4
        np.testing.assert_allclose(t, j, rtol=LOSS_RTOL)


def test_preprocess_matches_jax_counts(trained):
    """The whole slice: the port's preprocess, its own pretrace included,
    against JAX's on the same scene and sizes."""
    desc = trained["desc"]
    ss, stats = tpipe.preprocess(trained["ts"], trained["uvw"], desc.width,
                                 desc.height, PretraceConfig(**SIZE), **LT)
    js = trained["jstats"]
    assert stats.n_paths >= SIZE["target_samples"]
    assert abs(stats.n_paths - js.n_paths) <= COUNT_RTOL * js.n_paths
    assert abs(stats.n_conns - js.n_conns) <= COUNT_RTOL * js.n_conns
    assert stats.q_paths == js.q_paths
    assert ss.second_stage == trained["jss"].second_stage
    assert {"pretrace", "trees", "labels", "q", "gamma", "publish",
            "total"} <= set(stats.seconds)
    assert stats.pretrace_launches > 0 and stats.q_launches > 0
    assert np.isfinite(stats.gamma_losses).all()


def test_trained_checkpoints_cross_both_ways(trained, tmp_path):
    """A state trained by the port loads in the JAX package, and one
    trained by JAX loads in the port, table for table."""
    tss, jss = trained["tss"], trained["jss"]
    tables = ("q", "cmf_gamma", "alias_prob", "alias_idx", "inv_occ")
    path = str(tmp_path / "port.npz")
    tckpt.save_subspace_state(path, tss)
    back = jckpt.load_subspace_state(path)
    for f in tables:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      _np(getattr(tss, f)), err_msg=f)
    assert back.trained and back.second_stage == tss.second_stage
    path = str(tmp_path / "jax.npz")
    jckpt.save_subspace_state(path, jss)
    mine = tckpt.load_subspace_state(path)
    for f in tables + ("gamma_pmf",):
        np.testing.assert_array_equal(_np(getattr(mine, f)),
                                      _np(getattr(jss, f)), err_msg=f)
    assert mine.trained and mine.second_stage == jss.second_stage


def test_render_cli_trains_from_the_scene(tmp_path):
    import imageio.v2 as imageio

    out, stats, state = (tmp_path / "x.png", tmp_path / "s.json",
                         tmp_path / "x.npz")
    assert render_cli.main([
        "--device", "cpu", "--scene", "cornell", "--alg", "spcbpt",
        "--train-samples", "2000", "--q-samples", "4000", "--light-paths",
        "2000", "--dim", "32x32", "--spp", "1", "--checkpoint", str(state),
        "--out", str(out), "--stats-json", str(stats)]) == 0
    img = imageio.imread(out)
    assert img.shape == (32, 32, 3) and img.mean() > 0
    s = json.loads(stats.read_text())
    assert s["finite"] and s["count_min"] == s["count_max"] == 1
    pre = s["phases"]["preprocess"]
    assert {"pretrace", "trees", "labels", "q", "gamma", "publish",
            "total"} <= set(pre) and all(v >= 0 for v in pre.values())
    assert s["train"]["n_paths"] >= 2000 and s["train"]["q_paths"] >= 4000
    jss = jckpt.load_subspace_state(str(state))
    assert jss.trained and jss.second_stage == s["train"]["second_stage"]
    np.testing.assert_allclose(np.asarray(jss.cmf_gamma)[:, -1], 1.0)


def test_nn_classifier_is_refused(monkeypatch, tmp_path):
    """--classifier nn runs (tests/test_torch_nn_pipeline.py) but never in
    place of the card: --device cuda without one refuses, in the CLI and
    in the benchmark."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        render_cli.main(["--alg", "spcbpt", "--classifier", "nn", "--out",
                         str(tmp_path / "x.png")])
    from spcbpt_tpu_torch.apps import benchmark
    with pytest.raises(SystemExit, match="no CUDA device"):
        benchmark.main(["--algs", "spcbpt", "--classifier", "nn"])

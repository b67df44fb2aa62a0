"""The port's relMSE benchmark app (apps/benchmark.py) on the CPU: PT, BDPT
and SPCBPT against a small reference, from a trained checkpoint and from
training in the app, and its default device."""
import json

import numpy as np
import pytest
import torch

from spcbpt_tpu_torch import checkpoint
from spcbpt_tpu_torch.apps import benchmark
from spcbpt_tpu_torch.apps.render_cli import resolve_scene
from spcbpt_tpu_torch.scene.scene import load_trace_scene
from spcbpt_tpu_torch.train import classify

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--scene", "cornell", "--dim", "16x16",
         "--ref-spp", "4", "--spp", "2", "--light-paths", "1000",
         "--light-depth", "4"]


def _run(tmp_path, extra):
    out = tmp_path / "b.json"
    assert benchmark.main(SMALL + ["--json", str(out)] + extra) == 0
    return json.loads(out.read_text())


def test_benchmark_relmse_of_three_algs(tmp_path):
    """From a saved trained-shaped state: finite relMSE for every
    algorithm, at the spp asked, with its images."""
    ts, _, _ = load_trace_scene(resolve_scene("cornell"), "cpu")
    state = tmp_path / "state.npz"
    checkpoint.save_subspace_state(
        str(state), classify.synthetic_trained_state(ts, seed=4,
                                                     second_stage="weighted"))
    res = _run(tmp_path, ["--checkpoint", str(state), "--save-images",
                          str(tmp_path / "img")])
    assert set(res["algs"]) == {"pt", "bdpt", "spcbpt"}
    for alg, r in res["algs"].items():
        assert np.isfinite(r["relmse"]) and r["relmse"] > 0, alg
        assert r["spp"] == 2 and len(r["repeats"]) == 1, alg
    for name in ("pt", "bdpt", "spcbpt", "ref"):
        assert (tmp_path / "img" / f"{name}.png").stat().st_size > 0


def test_benchmark_trains_spcbpt_and_checks_energy(tmp_path):
    """Without a checkpoint the app trains SPCBPT itself and saves the
    state; the BDPT reference and the energy cross-check run."""
    state = tmp_path / "trained.npz"
    res = _run(tmp_path, ["--algs", "spcbpt", "--train-samples", "1500",
                          "--q-samples", "2000", "--ref-alg", "bdpt",
                          "--ref-check-spp", "2", "--second-stage",
                          "uniform", "--checkpoint", str(state)])
    assert np.isfinite(res["algs"]["spcbpt"]["relmse"])
    assert {"pretrace", "q", "gamma", "total"} <= set(res["train_seconds"])
    assert np.isfinite(res["energy_check"]["rel_diff"])
    assert checkpoint.load_subspace_state(str(state)).trained


def test_benchmark_cuda_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        benchmark.main(["--json", str(tmp_path / "b.json")])

"""Multi-device dry run: one sharded SPCBPT render step and one
data-parallel Gamma step on tiny shapes, over n CPU ranks joined by gloo.

Counterpart of `dryrun_multichip` in the repository's __graft_entry__.py
(JAX runs it on an n-device virtual CPU mesh): it runs the trained-shaped
estimator that BASELINE config 5 ships (classifiers, alias tables, the
presampled mixture second stage, 3 connections), not the uniform one.

    python -m spcbpt_tpu_torch.parallel.dryrun 4
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import NUM_SUBSPACE

LIGHT_PATHS = 64
DEPTH = 3
CONNECTIONS = 3


def _rank(rank: int, world: int) -> dict:
    from ..render import lvc
    from ..scene.cornell import default_scene_path
    from ..scene.scene import load_trace_scene
    from ..train import classify, gamma_train
    from . import tile

    mesh = tile.make_mesh()
    width, height = 32, max(mesh.tile * 4, 8)
    ts, _, cam = load_trace_scene(default_scene_path(), "cpu")
    cam.aspect = width / height
    ss = classify.synthetic_trained_state(ts, seed=3)
    assert ss.trained and lvc.table_mode_for(ss) == "mixture"
    img = tile.sharded_spcbpt_render(
        ts, ss, cam.uvw(), width, height, 0, mesh,
        light_paths_per_chip=LIGHT_PATHS, light_depth=DEPTH, max_depth=DEPTH,
        connection_n=CONNECTIONS, uniform=False)
    assert img.shape == (width * height, 3), img.shape
    assert not torch.isnan(img).any()

    p, c = 8 * world, 4
    batch = gamma_train.GammaTrainData(
        f_square=torch.ones((p,)), pdf0=torch.full((p,), 0.5),
        peak=torch.ones((p, c)), label_e=torch.zeros((p, c), dtype=torch.int32),
        valid=torch.ones((p,), dtype=torch.bool))
    theta = torch.zeros((NUM_SUBSPACE, NUM_SUBSPACE), requires_grad=True)
    opt = torch.optim.Adam([theta], lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    loss = tile.dp_gamma_train_step(theta, opt, batch, mesh)
    assert torch.isfinite(loss)
    return dict(mesh=mesh.shape, shape=tuple(img.shape), loss=float(loss),
                img=img.numpy())


def dryrun_multichip(n_devices: int, timeout_s: float = 480.0,
                     rendezvous_dir: str | None = None) -> list:
    """Runs the dry run on n_devices gloo ranks; returns their results."""
    from .launch import spawn

    out = spawn(_rank, n_devices, device="cpu", timeout_s=timeout_s,
                rendezvous_dir=rendezvous_dir)
    for r in out[1:]:
        np.testing.assert_array_equal(r["img"], out[0]["img"])
        assert r["loss"] == out[0]["loss"]
    r = out[0]
    print(f"dryrun_multichip OK: mesh {r['mesh']}, trained two-stage path "
          f"(alias_pack + mixture tables, connection_n={CONNECTIONS}) render "
          f"{r['shape']}, gamma loss {r['loss']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)

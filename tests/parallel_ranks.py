"""Rank bodies and inputs for tests/test_torch_parallel.py.

Each spawned rank (spcbpt_tpu_torch.parallel.launch.spawn) imports this
module, which imports torch and the port only, builds its inputs from
seeds, runs the sharded renders and the data-parallel Gamma step on its
mesh, and returns numpy arrays. The test process builds the same inputs
for the sequential route and for JAX.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from spcbpt_tpu_torch.config import NUM_SUBSPACE

WIDTH, HEIGHT = 32, 8
DEPTH = 3
LIGHT_PATHS = 256
CONNS = 4
LR = 0.01


def scene(device="cpu"):
    from spcbpt_tpu_torch.scene.cornell import default_scene_path
    from spcbpt_tpu_torch.scene.scene import load_trace_scene
    from spcbpt_tpu_torch.train import classify

    ts, _, cam = load_trace_scene(default_scene_path(), device)
    cam.aspect = WIDTH / HEIGHT
    return ts, cam.uvw(), classify.synthetic_trained_state(ts, seed=3)


def gamma_inputs(paths: int, seed: int = 0) -> dict:
    """A Gamma training batch as numpy: a fifth of the paths invalid (so
    shards carry uneven valid counts), empty connection slots at peak 0,
    and theta from a random Gamma."""
    rng = np.random.default_rng(seed)
    live = rng.random((paths, CONNS)) < 0.7
    g = rng.uniform(0.1, 1.0, (NUM_SUBSPACE, NUM_SUBSPACE))
    g = (g / g.sum(1, keepdims=True)).astype(np.float32)
    return dict(
        f_square=rng.uniform(0.1, 1.0, paths).astype(np.float32),
        pdf0=rng.uniform(0.05, 0.5, paths).astype(np.float32),
        peak=np.where(live, rng.uniform(0.1, 2.0, (paths, CONNS)),
                      0.0).astype(np.float32),
        label_e=rng.integers(0, NUM_SUBSPACE ** 2,
                             (paths, CONNS)).astype(np.int32),
        valid=rng.random(paths) > 0.2,
        theta=np.log(g / (1 - g)).astype(np.float32))


def dp_step(arrays: dict, mesh):
    """dp_gamma_train_step from the numpy inputs; returns (loss, theta)."""
    from spcbpt_tpu_torch.parallel import tile
    from spcbpt_tpu_torch.train import gamma_train

    batch = gamma_train.GammaTrainData(
        *[torch.from_numpy(arrays[k]) for k in gamma_train.GammaTrainData
          ._fields])
    theta = torch.from_numpy(arrays["theta"]).clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    loss = tile.dp_gamma_train_step(theta, opt, batch, mesh)
    return float(loss), theta.detach().numpy()


def renders(mesh, sub_blocks: int = 1) -> dict:
    """PT, BDPT and SPCBPT (the synthetic trained state) of one subframe
    on `mesh` as numpy images."""
    from spcbpt_tpu_torch.parallel import tile

    ts, uvw, ss = scene()
    kw = dict(light_paths_per_chip=LIGHT_PATHS, light_depth=DEPTH,
              max_depth=DEPTH, sub_blocks=sub_blocks)
    return dict(
        pt=tile.sharded_pt_render(ts, uvw, WIDTH, HEIGHT, 1, mesh,
                                  max_depth=DEPTH).numpy(),
        bdpt=tile.sharded_spcbpt_render(ts, ss, uvw, WIDTH, HEIGHT, 1, mesh,
                                        uniform=True, **kw).numpy(),
        spcbpt=tile.sharded_spcbpt_render(ts, ss, uvw, WIDTH, HEIGHT, 1,
                                          mesh, **kw).numpy())


def mesh_rank(rank: int, world: int, tile_n: int, spp: int) -> dict:
    from spcbpt_tpu_torch.parallel import tile

    mesh = tile.make_mesh(tile=tile_n, spp=spp)
    out = renders(mesh)
    out["loss"], out["theta"] = dp_step(gamma_inputs(16 * world), mesh)
    out.update(coords=mesh.coords, shape=mesh.shape,
               row=dist.get_process_group_ranks(mesh.row_group),
               col=dist.get_process_group_ranks(mesh.col_group))
    return out

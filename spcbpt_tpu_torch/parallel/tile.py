"""Multi-device rendering and training with torch.distributed.

Port of spcbpt_tpu/parallel/tile.py (BASELINE.md config 5, "multi-chip
tiled SPCBPT"). One process per device, rank r at mesh coordinates
(ti, si) = divmod(r, spp), the layout of JAX's reshape(tile, spp):
- pixel rows shard over `tile`, independent sample streams shard over `spp`
  and are averaged (an all-reduce SUM over the rank's spp row, then / spp,
  as JAX's pmean); the row blocks are all-gathered over the rank's tile
  column into the whole (W*H, 3) image, in tile order, on every rank;
- scene, Gamma/Q and classifiers are replicated;
- each rank traces its own light sub-paths (frame subframe*65536 + rank)
  and builds its own LVC sampler: no communication, more light paths;
- Gamma training is data parallel: the batch shards over the flattened
  mesh, loss sums, valid counts and gradients are all-reduced, and the
  division happens on the totals.

A mesh without a rank (`sequential_mesh`) is the sequential route: it runs
the same per-(ti, si) bodies one after another in one process and combines
them as the collectives do (streams summed in spp order, then / spp). The
tests hold the gloo meshes to it, and it to JAX's shard_map.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..render import light_trace, lvc, pt, spcbpt
from ..train import gamma_train
from ..utils import rng as rng_mod

_MASK = 0xFFFFFFFF


@dataclasses.dataclass
class Mesh:
    tile: int
    spp: int
    rank: int | None = None     # None: the sequential route
    row_group: object = None    # this rank's spp row
    col_group: object = None    # this rank's tile column

    @property
    def shape(self) -> dict:
        return {"tile": self.tile, "spp": self.spp}

    @property
    def size(self) -> int:
        return self.tile * self.spp

    @property
    def coords(self) -> tuple:
        return divmod(self.rank, self.spp)


def mesh_shape(n: int, tile: int | None = None,
               spp: int | None = None) -> tuple:
    """(tile, spp) for n devices, with JAX's defaults: spp = 2 when n is
    even and larger than 1."""
    if tile is None:
        spp = spp or (2 if n % 2 == 0 and n > 1 else 1)
        tile = n // spp
    elif spp is None:
        spp = n // tile
    if tile * spp != n:
        raise ValueError(f"mesh {tile}x{spp} != {n} devices")
    return tile, spp


def make_mesh(tile: int | None = None, spp: int | None = None) -> Mesh:
    """(tile, spp) mesh over the initialised torch.distributed world. Every
    rank creates the spp-row groups and then the tile-column groups, in the
    same order, as new_group requires."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(parallel/launch.spawn does it)")
    n, rank = dist.get_world_size(), dist.get_rank()
    tile, spp = mesh_shape(n, tile, spp)
    rows = [dist.new_group([ti * spp + si for si in range(spp)])
            for ti in range(tile)]
    cols = [dist.new_group([ti * spp + si for ti in range(tile)])
            for si in range(spp)]
    ti, si = divmod(rank, spp)
    return Mesh(tile, spp, rank, rows[ti], cols[si])


def sequential_mesh(tile: int, spp: int = 1) -> Mesh:
    return Mesh(tile, spp)


def _combine(mesh: Mesh, body):
    """The image of body(ti, si) -> (rows*W, 3) blocks: streams averaged
    over spp, row blocks in tile order."""
    if mesh.rank is None:
        blocks = []
        for ti in range(mesh.tile):
            acc = body(ti, 0)
            for si in range(1, mesh.spp):
                acc = acc + body(ti, si)
            blocks.append(acc / mesh.spp)
        return torch.cat(blocks)
    ti, si = mesh.coords
    img = body(ti, si).contiguous()
    dist.all_reduce(img, group=mesh.row_group)
    img = img / mesh.spp
    parts = [torch.empty_like(img) for _ in range(mesh.tile)]
    dist.all_gather(parts, img, group=mesh.col_group)
    return torch.cat(parts)


def _block_camera_rays(eye, U, V, W, width, height, rows_per_tile, tile_idx,
                       stream_idx, subframe, device="cpu"):
    """Camera rays for one row block; seeds follow the global pixel index,
    so results equal the single-device renderer's, with the sample-stream
    axis folded into the frame index. Every subframe jitters."""
    n = width * rows_per_tile
    lane = (torch.arange(n, dtype=torch.int64, device=device)
            + width * rows_per_tile * int(tile_idx)) & _MASK
    state = rng_mod.seed(lane, (int(subframe) * 4096 + int(stream_idx))
                         & _MASK)
    jx, state = rng_mod.next_float(state)
    jy, state = rng_mod.next_float(state)
    x = (lane % width).to(torch.float32)
    y = (lane // width).to(torch.float32)
    dx = 2.0 * (x + jx) / width - 1.0
    dy = 2.0 * (y + jy) / height - 1.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    eye, U, V, W = f32(eye), f32(U), f32(V), f32(W)
    d = dx[:, None] * U + dy[:, None] * V + W
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return eye.expand(d.shape), d, state


def sharded_pt_render(ts, cam_uvw, width: int, height: int, subframe,
                      mesh: Mesh, max_depth: int = 12):
    """One progressive PT sample for the full image, pixels sharded over
    `tile`, sample streams averaged over `spp`. Returns (W*H, 3)."""
    if height % mesh.tile:
        raise ValueError(f"height {height} % tile {mesh.tile} != 0")
    rows = height // mesh.tile
    step = pt.make_pt_step(ts, max_depth)

    def body(ti, si):
        return step(*_block_camera_rays(*cam_uvw, width, height, rows, ti,
                                        si, subframe, device=ts.device))

    return _combine(mesh, body)


def sharded_spcbpt_render(ts, ss, cam_uvw, width: int, height: int, subframe,
                          mesh: Mesh, light_paths_per_chip: int = 8192,
                          light_depth: int = 8, max_depth: int = 12,
                          connection_n: int = 3, uniform: bool = False,
                          sub_blocks: int = 1):
    """Tiled SPCBPT: each rank traces its own light sub-paths, builds its
    LVC sampler, renders its row block, and sample streams are averaged
    over `spp`. sub_blocks > 1 renders the block as that many sequential
    row blocks (tile index ti*sub_blocks + b) from the same sampler: live
    lanes drop sub_blocks-fold, the estimator is unchanged."""
    if height % mesh.tile:
        raise ValueError(f"height {height} % tile {mesh.tile} != 0")
    rows = height // mesh.tile
    if rows % sub_blocks:
        raise ValueError(f"rows {rows} % sub_blocks {sub_blocks} != 0")
    rows_b = rows // sub_blocks
    mode = None if uniform else lvc.table_mode_for(ss)

    def body(ti, si):
        frame = (int(subframe) * 65536 + ti * mesh.spp + si) & _MASK
        lv = light_trace.trace_light_paths(ts, ss, light_paths_per_chip,
                                           frame, max_depth=light_depth)
        sampler = lvc.build_sampler(lv, table_mode=mode, table_seed=frame,
                                    ss=ss)
        step = spcbpt.make_spcbpt_step(ts, ss, sampler, max_depth,
                                       connection_n, uniform)
        return torch.cat([step(*_block_camera_rays(
            *cam_uvw, width, height, rows_b, ti * sub_blocks + b, si,
            subframe, device=ts.device)) for b in range(sub_blocks)])

    return _combine(mesh, body)


def dp_gamma_train_step(theta, opt, batch: gamma_train.GammaTrainData,
                        mesh: Mesh):
    """One data-parallel Gamma step: the batch shards over the flattened
    mesh (shard r = rank r, tile-major); each shard's unnormalized loss sum,
    valid count and gradient are summed over the mesh and divided on the
    totals, so loss and gradient are the global batch's even for uneven
    valid counts (VERDICT r3 #4). Then every rank takes the same Adam step
    (opt over the leaf theta) with NaN gradients set to 0. Returns the
    loss."""
    n = batch.f_square.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch {n} % mesh size {mesh.size} != 0")
    per = n // mesh.size

    def shard_sums(r):
        shard = gamma_train.GammaTrainData(
            *[a[r * per:(r + 1) * per] for a in batch])
        theta.grad = None
        s, c = gamma_train.loss_sum_fn(theta, shard)
        s.backward()
        return s.detach(), c, theta.grad

    if mesh.rank is None:
        s_tot, c_tot, g_tot = shard_sums(0)
        for r in range(1, mesh.size):
            s, c, g = shard_sums(r)
            s_tot, c_tot, g_tot = s_tot + s, c_tot + c, g_tot + g
    else:
        s_tot, c_tot, g_tot = shard_sums(mesh.rank)
        for t in (s_tot, c_tot, g_tot):
            dist.all_reduce(t)
    denom = torch.clamp(c_tot, min=1).to(s_tot.dtype)
    g = g_tot / denom
    opt.zero_grad(set_to_none=True)
    theta.grad = torch.where(torch.isnan(g), 0.0, g)
    opt.step()
    return s_tot / denom

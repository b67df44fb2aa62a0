"""Path-regeneration SPCBPT/BDPT eye renderer (pool variant of
render/spcbpt.py — same estimator, near-full lane utilization).

Port of `render_pool` of spcbpt_tpu/render/spcbpt_pool.py. `render_pool`
runs the pool loop of render/pool.py with the state of an eye sub-path on
each lane. One LVC sampler (one frame of light sub-paths) serves all
samples of the call; the reference refreshes the LVC every progressive
frame, so callers use spp=1 per sampler for parity.

The loop body reads the light-vertex sampler only through the pool's copy,
into which each call copies the sampler it is given (a sampler's shapes
are fixed by its light paths and depth; only its addresses change from
frame to frame). A pool is dropped with its scene or its subspace state.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..config import CONNECTION_N
from ..scene.scene import TraceScene
from ..train import classify
from ..utils import profiling
from ..utils import vec
from . import pool
from .lvc import LVCSampler
from .spcbpt import _eye_bounce, _init_eye_vertices, _select
from .vertex import map_fields

# the sampler's tensors the loop body can read (the draws of every
# second-stage mode, BDPT's uniform draw, the packed rows); it reads
# neither `vertices` nor `seg_sum`
SAMPLER_FIELDS = ("order", "cmf", "seg_start", "seg_size", "vertex_count",
                  "path_count", "packed", "table_idx", "table_pmf",
                  "table_pack")


def _sampler_key(sampler: LVCSampler) -> tuple:
    """What a pool's copy of the sampler is fixed to: each read tensor's
    shape and dtype (or its absence), the table mode, the weight column."""
    def sig(t):
        return None if t is None else (tuple(t.shape), t.dtype)
    return (tuple(sig(getattr(sampler, f)) for f in SAMPLER_FIELDS),
            sampler.table_mode, sampler.has_weight_b)


def _fresh(cam, width: int, height: int, subframe0, pixel, rep) -> dict:
    """Lanes on sample rep of `pixel`: the camera ray, its eye vertex and
    the path state of a new eye sub-path."""
    o, d, state = pool.camera_rays(cam, width, height, subframe0)(
        pixel, rep)
    n = pixel.shape[0]
    dev = pixel.device
    return dict(o=o, d=d, state=state, v=_init_eye_vertices(o, d),
                ratio=torch.ones((n, 3), device=dev),
                pending_f=torch.ones((n, 3), device=dev),
                pending_single=torch.ones((n,), device=dev),
                result=torch.zeros((n, 3), device=dev),
                depth=torch.zeros((n,), dtype=torch.int32, device=dev))


# the lane state of `_fresh` a pool keeps, in its own buffers
LANE_FIELDS = ("o", "d", "state", "ratio", "pending_f", "pending_single",
               "result", "depth")


class _Pool(pool.Pool):
    """An eye pool's buffers: the frame's, each lane's path state and eye
    vertex, and the pool's copy of the sampler."""

    def __init__(self, n_pool: int, n_pixels: int, sampler: LVCSampler,
                 dev):
        super().__init__(n_pool, n_pixels, dev)
        zeros = self.zeros
        self.o, self.d = zeros(n_pool, 3), zeros(n_pool, 3)
        self.state = zeros(n_pool, dtype=torch.int64)
        self.ratio, self.pending_f = zeros(n_pool, 3), zeros(n_pool, 3)
        self.pending_single = zeros(n_pool)
        self.result = zeros(n_pool, 3)
        self.depth = zeros(n_pool, dtype=torch.int32)
        self.v = map_fields(torch.zeros_like,
                            _init_eye_vertices(self.o, self.d))
        self.sampler = dataclasses.replace(
            sampler, vertices=None, seg_sum=None,
            **{f: None if getattr(sampler, f) is None
               else torch.empty_like(getattr(sampler, f))
               for f in SAMPLER_FIELDS})


# (id(scene), id(state), width, height, spp, n_pool, max_depth,
# connection_n, uniform, second_stage, the sampler's key, device) -> _Pool
_POOLS = pool.Cache()


def _copy_fields(dst, src) -> None:
    """Each tensor field of record `dst` overwritten by src's."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def _start(p: _Pool, sampler: LVCSampler, cam_uvw, subframe0: int,
           width: int, height: int, total: int) -> None:
    """A frame's set-up, written into p: the sampler's tensors, then each
    lane on a new eye sub-path."""
    for f in SAMPLER_FIELDS:
        if getattr(p.sampler, f) is not None:
            getattr(p.sampler, f).copy_(getattr(sampler, f))

    def fresh(pixel, rep):
        c = _fresh(p.cam, width, height, p.subframe0, pixel, rep)
        for f in LANE_FIELDS:
            getattr(p, f).copy_(c[f])
        _copy_fields(p.v, c["v"])
    pool.start(p, cam_uvw, subframe0, width, height, total, fresh)


def _iteration(ts: TraceScene, ss: classify.SubspaceState, p: _Pool,
               width: int, height: int, total: int, max_depth: int,
               connection_n: int, uniform: bool, second_stage) -> None:
    """One pass of the loop body over p: the eye bounce of every live
    lane, then the flush and regeneration, its buffers updated in place."""
    c = {f: getattr(p, f) for f in LANE_FIELDS}
    c["v"] = p.v
    live = p.alive
    # pool-exhausted (~alive) lanes: dead-lane tmax skips their traversal
    b = _eye_bounce(ts, ss, p.sampler, c, connection_n, uniform,
                    second_stage, live)
    result, cont, keep = b["result"], b["cont"], b["hit_surf"]

    depth = c["depth"] + 1
    terminated = live & (b["miss"] | b["hit_light"] | (keep & ~cont)
                         | (depth > max_depth))

    def refill(take, pixel, rep):
        fresh = _fresh(p.cam, width, height, p.subframe0, pixel, rep)
        v_next = _select(take, fresh["v"], _select(keep, b["mid"], c["v"]))
        nxt = dict(
            o=vec.where3(take, fresh["o"], vec.where3(cont, b["P"], c["o"])),
            d=vec.where3(take, fresh["d"],
                         vec.where3(cont, b["new_d"], c["d"])),
            state=torch.where(take, fresh["state"], b["state"]),
            ratio=vec.where3(take, fresh["ratio"],
                             vec.where3(keep, b["ratio_mid"], c["ratio"])),
            pending_f=vec.where3(take, fresh["pending_f"],
                                 vec.where3(cont, b["f"], c["pending_f"])),
            pending_single=torch.where(
                take, 1.0,
                torch.where(cont, b["pdf_rr"], c["pending_single"])),
            result=torch.where((take | terminated)[..., None], 0.0, result),
            depth=torch.where(take, 0, depth))
        for f in LANE_FIELDS:
            getattr(p, f).copy_(nxt[f])
        _copy_fields(p.v, v_next)
    pool.regenerate(p, terminated, result, width * height, total, refill)


@profiling.traced("spcbpt_pool.render", ends_frame=True)
def render_pool(ts: TraceScene, ss: classify.SubspaceState,
                sampler: LVCSampler, cam_uvw, width: int, height: int,
                spp: int, subframe0: int = 0, n_pool: int = 1 << 16,
                max_depth: int = 16, connection_n: int = CONNECTION_N,
                uniform: bool = False, second_stage=None):
    """Render `spp` samples/pixel on the scene's device; returns
    (film_sum (W*H, 3), counts (W*H,) int32), the caller's own: no later
    call writes them."""
    total = width * height * spp
    n_pool = min(n_pool, total)
    p = _POOLS.get(
        (ts, ss), (width, height, spp, n_pool, max_depth, connection_n,
                   uniform, second_stage, _sampler_key(sampler), ts.device),
        lambda: _Pool(n_pool, width * height, sampler, ts.device))
    _start(p, sampler, cam_uvw, subframe0, width, height, total)
    return pool.run("spcbpt_pool", ts, p, functools.partial(
        _iteration, ts, ss, p, width, height, total, max_depth,
        connection_n, uniform, second_stage))

"""Path-regeneration wavefront PT: the throughput variant of render/pt.py.

Port of spcbpt_tpu/render/pt_pool.py. `render_pool` runs the pool loop of
render/pool.py with the path state of a PT lane. `render_waves`, the
scatter-free variant: one lane per pixel renders its spp samples in turn,
its film entry the lane's own sum. Same estimator (the sky's escape
radiance included) and same per-pixel sample counts as render/pt.py; in
both, sample rep r of pixel p uses seed(p, subframe0 + r), so per pixel
they differ only in summation order and traversal ties.
"""
from __future__ import annotations

import functools

import torch

from ..config import CULL_BACKFACE, PT_MAX_DEPTH, SCENE_EPSILON
from ..scene.scene import TraceScene, local_geometry, trace_closest
from ..utils import profiling
from ..utils import vec
from . import pool
from .pt import _nee, bounce, emitter_hit, escape


def _path_step(ts: TraceScene, o, d, state, throughput, result, bsdf_pdf,
               depth, live, max_depth: int) -> tuple:
    """One bounce of every live lane: closest hit, sky, emitter, NEE and the
    BSDF sample. Returns (result, terminated, origin, direction,
    throughput, bsdf_pdf, depth, rng state), the path state moved on where
    the path continues; the caller restarts or drops the lanes that
    terminated."""
    # dead lanes: dead-lane tmax skips their traversal
    hit = trace_closest(ts, o, d, SCENE_EPSILON,
                        torch.where(live, 1e16, -1.0), CULL_BACKFACE)
    miss = ~hit.valid & live
    if ts.has_env:
        result = result + escape(ts, miss, d, throughput, depth)
    geom = local_geometry(ts, hit, o, d)
    hit_light = hit.valid & (geom["light_id"] >= 0) & live
    hit_surf = hit.valid & (geom["light_id"] < 0) & live

    emit, front = emitter_hit(ts, geom, hit, d, throughput, bsdf_pdf, depth)
    result = result + vec.scrub(
        torch.where((hit_light & front)[..., None], emit, 0.0))

    nee, state2 = _nee(ts, geom, -d, throughput, state, mask=hit_surf)
    result = result + torch.where(hit_surf[..., None], nee, 0.0)

    new_d, pdf, rr, ratio, kill, state2 = bounce(ts, geom, d, state2)
    cont = hit_surf & ~kill & (pdf > 0.0)

    depth = depth + 1
    terminated = live & (miss | hit_light | (hit_surf & ~cont)
                         | (depth > max_depth))
    return (result, terminated, vec.where3(cont, geom["P"], o),
            vec.where3(cont, new_d, d),
            vec.where3(cont, throughput * ratio, throughput),
            torch.where(cont, pdf * rr, bsdf_pdf), depth, state2)


class _Pool(pool.Pool):
    """A PT pool's buffers: the frame's, and each lane's path state."""

    def __init__(self, n_pool: int, n_pixels: int, dev):
        super().__init__(n_pool, n_pixels, dev)
        zeros = self.zeros
        self.o, self.d = zeros(n_pool, 3), zeros(n_pool, 3)
        self.state = zeros(n_pool, dtype=torch.int64)
        self.throughput, self.result = zeros(n_pool, 3), zeros(n_pool, 3)
        self.bsdf_pdf = zeros(n_pool)
        self.depth = zeros(n_pool, dtype=torch.int32)
        self.zeros3 = zeros(n_pool, 3)
        self.ones3 = torch.ones((n_pool, 3), device=dev)


# (id(scene), width, height, spp, n_pool, max_depth, device) -> _Pool
_POOLS = pool.Cache()


def _start(p: _Pool, cam_uvw, subframe0: int, width: int, height: int,
           total: int) -> None:
    """A frame's set-up, written into p, each lane on a new path."""
    def fresh(pixel, rep):
        o, d, state = pool.camera_rays(p.cam, width, height, p.subframe0)(
            pixel, rep)
        p.o.copy_(o)
        p.d.copy_(d)
        p.state.copy_(state)
        p.throughput.fill_(1.0)
        p.result.zero_()
        p.bsdf_pdf.zero_()
        p.depth.zero_()
    pool.start(p, cam_uvw, subframe0, width, height, total, fresh)


def _iteration(ts: TraceScene, p: _Pool, width: int, height: int,
               total: int, max_depth: int) -> None:
    """One pass of the loop body over p: a bounce of every live lane, then
    the flush and regeneration, its buffers updated in place."""
    (result, terminated, o, d, throughput, bsdf_pdf, depth,
     state2) = _path_step(ts, p.o, p.d, p.state, p.throughput, p.result,
                          p.bsdf_pdf, p.depth, p.alive, max_depth)

    def refill(take, pixel, rep):
        o_new, d_new, st_new = pool.camera_rays(
            p.cam, width, height, p.subframe0)(pixel, rep)
        p.o.copy_(vec.where3(take, o_new, o))
        p.d.copy_(vec.where3(take, d_new, d))
        p.state.copy_(torch.where(take, st_new, state2))
        p.throughput.copy_(vec.where3(take, p.ones3, throughput))
        p.result.copy_(vec.where3(take | terminated, p.zeros3, result))
        p.bsdf_pdf.copy_(torch.where(take, 0.0, bsdf_pdf))
        p.depth.copy_(torch.where(take, 0, depth))
    pool.regenerate(p, terminated, result, width * height, total, refill)


@profiling.traced("pt_pool.render", ends_frame=True)
def render_pool(ts: TraceScene, cam_uvw, width: int, height: int,
                spp: int, subframe0: int = 0, n_pool: int = 1 << 17,
                max_depth: int = PT_MAX_DEPTH):
    """Render `spp` samples/pixel on the scene's device; returns
    (film_sum (W*H,3), counts (W*H,) int32), the caller's own: no later
    call writes them."""
    total = width * height * spp
    n_pool = min(n_pool, total)
    p = _POOLS.get((ts,), (width, height, spp, n_pool, max_depth, ts.device),
                   lambda: _Pool(n_pool, width * height, ts.device))
    _start(p, cam_uvw, subframe0, width, height, total)
    return pool.run("pt_pool", ts, p, functools.partial(
        _iteration, ts, p, width, height, total, max_depth))


def render_waves(ts: TraceScene, cam_uvw, width: int, height: int,
                 spp: int, subframe0: int = 0,
                 max_depth: int = PT_MAX_DEPTH):
    """Scatter-free variant: one lane per pixel renders its spp samples in
    turn (a terminated lane restarts the SAME pixel on its next sample), so
    the film is the lanes' own sums, at the cost of tail idling when a
    pixel's last path outlives its neighbours'. Returns (film_sum (W*H, 3),
    counts (W*H,) int32, all spp)."""
    dev = ts.device
    n_pixels = width * height
    pixel = torch.arange(n_pixels, dtype=torch.int64, device=dev)
    camera_ray = pool.camera_rays(
        pool.camera(cam_uvw, dev), width, height,
        torch.full((), subframe0, dtype=torch.int64, device=dev))
    rep = torch.zeros((n_pixels,), dtype=torch.int64, device=dev)
    o, d, state = camera_ray(pixel, rep)
    throughput = torch.ones((n_pixels, 3), device=dev)
    result = torch.zeros((n_pixels, 3), device=dev)
    bsdf_pdf = torch.zeros((n_pixels,), device=dev)
    depth = torch.zeros((n_pixels,), dtype=torch.int32, device=dev)
    alive = torch.ones((n_pixels,), dtype=torch.bool, device=dev)
    film = torch.zeros((n_pixels, 3), device=dev)
    zeros3 = torch.zeros((n_pixels, 3), device=dev)
    ones3 = torch.ones((n_pixels, 3), device=dev)

    while bool(alive.any()):
        live = alive
        (result, terminated, o, d, throughput, bsdf_pdf, depth,
         state2) = _path_step(ts, o, d, state, throughput, result, bsdf_pdf,
                              depth, live, max_depth)
        film = film + torch.where(terminated[..., None], result, 0.0)
        rep = rep + terminated.to(torch.int64)
        restart = terminated & (rep < spp)
        o_new, d_new, st_new = camera_ray(pixel, rep)

        o = vec.where3(restart, o_new, o)
        d = vec.where3(restart, d_new, d)
        state = torch.where(restart, st_new, state2)
        throughput = vec.where3(restart, ones3, throughput)
        result = vec.where3(restart | terminated, zeros3, result)
        bsdf_pdf = torch.where(restart, 0.0, bsdf_pdf)
        depth = torch.where(restart, 0, depth)
        alive = (live & ~terminated) | restart
    return film, torch.full((n_pixels,), spp, dtype=torch.int32, device=dev)

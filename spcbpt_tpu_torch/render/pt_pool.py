"""Path-regeneration wavefront PT: the throughput variant of render/pt.py.

Port of `render_pool` of spcbpt_tpu/render/pt_pool.py. A fixed pool of
lanes runs a loop: whenever a lane terminates, its result scatter-adds into
the film and the lane restarts on the next camera sample from a global
counter, so utilization stays high whatever the path-length distribution.
Same estimator (the sky's escape radiance included) and same per-pixel
sample counts as render/pt.py; sample rep r of pixel p uses
seed(p, subframe0 + r). JAX's `render_waves` is not ported.

The loop condition (any lane alive, or samples left) is read on the host
once per iteration. The film scatter-add is `index_add_`, whose order of
atomic adds on the card is not deterministic.
"""
from __future__ import annotations

import torch

from ..config import CULL_BACKFACE, PT_MAX_DEPTH, SCENE_EPSILON
from ..scene.scene import TraceScene, local_geometry, trace_closest
from ..utils import rng as rng_mod
from ..utils import vec
from .pt import _nee, bounce, emitter_hit, escape


def render_pool(ts: TraceScene, cam_uvw, width: int, height: int,
                spp: int, subframe0: int = 0, n_pool: int = 1 << 17,
                max_depth: int = PT_MAX_DEPTH):
    """Render `spp` samples/pixel on the scene's device; returns
    (film_sum (W*H,3), counts (W*H,) int32)."""
    dev = ts.device
    eye, U, V, W = [torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in cam_uvw]
    n_pixels = width * height
    total = n_pixels * spp
    n_pool = min(n_pool, total)

    def camera_ray(pixel, rep):
        state = rng_mod.seed(pixel, subframe0 + rep)
        jx, state = rng_mod.next_float(state)
        jy, state = rng_mod.next_float(state)
        first = (subframe0 + rep) == 0
        jx = torch.where(first, 0.5, jx)
        jy = torch.where(first, 0.5, jy)
        x = (pixel % width).to(torch.float32)
        y = (pixel // width).to(torch.float32)
        dx = 2.0 * (x + jx) / width - 1.0
        dy = 2.0 * (y + jy) / height - 1.0
        d = dx[:, None] * U + dy[:, None] * V + W
        d = d / torch.sqrt(vec.dot(d, d))[:, None]
        return eye.expand(d.shape), d, state

    lane = torch.arange(n_pool, dtype=torch.int64, device=dev)
    pixel = lane % n_pixels
    o, d, state = camera_ray(pixel, lane // n_pixels)
    throughput = torch.ones((n_pool, 3), device=dev)
    result = torch.zeros((n_pool, 3), device=dev)
    bsdf_pdf = torch.zeros((n_pool,), device=dev)
    depth = torch.zeros((n_pool,), dtype=torch.int32, device=dev)
    alive = torch.ones((n_pool,), dtype=torch.bool, device=dev)
    next_sample = torch.tensor(n_pool, dtype=torch.int64, device=dev)
    film = torch.zeros((n_pixels, 3), device=dev)
    count = torch.zeros((n_pixels,), dtype=torch.int32, device=dev)
    zeros3 = torch.zeros((n_pool, 3), device=dev)
    ones3 = torch.ones((n_pool, 3), device=dev)

    while bool(alive.any() | (next_sample < total)):
        live = alive
        # pool-exhausted (~alive) lanes: dead-lane tmax skips their traversal
        hit = trace_closest(ts, o, d, SCENE_EPSILON,
                            torch.where(live, 1e16, -1.0), CULL_BACKFACE)
        miss = ~hit.valid & live
        if ts.has_env:
            result = result + escape(ts, miss, d, throughput, depth)
        geom = local_geometry(ts, hit, o, d)
        hit_light = hit.valid & (geom["light_id"] >= 0) & live
        hit_surf = hit.valid & (geom["light_id"] < 0) & live

        emit, front = emitter_hit(ts, geom, hit, d, throughput, bsdf_pdf,
                                  depth)
        result = result + vec.scrub(
            torch.where((hit_light & front)[..., None], emit, 0.0))

        nee, state2 = _nee(ts, geom, -d, throughput, state, mask=hit_surf)
        result = result + torch.where(hit_surf[..., None], nee, 0.0)

        new_d, pdf, rr, ratio, kill, state2 = bounce(ts, geom, d, state2)
        cont = hit_surf & ~kill & (pdf > 0.0)

        depth = depth + 1
        terminated = live & (miss | hit_light | (hit_surf & ~cont)
                             | (depth > max_depth))
        still = live & ~terminated

        # flush finished samples into the film
        film.index_add_(0, pixel, torch.where(terminated[..., None], result,
                                              0.0))
        count.index_add_(0, pixel, terminated.to(torch.int32))

        # regenerate dead lanes from the global sample counter
        want = terminated | ~live
        rank = torch.cumsum(want.to(torch.int64), dim=0) - 1
        sid = next_sample + rank
        take = want & (sid < total)
        n_taken = take.sum()
        new_pixel = sid % n_pixels
        o_new, d_new, st_new = camera_ray(new_pixel, sid // n_pixels)

        o = vec.where3(take, o_new, vec.where3(cont, geom["P"], o))
        d = vec.where3(take, d_new, vec.where3(cont, new_d, d))
        state = torch.where(take, st_new, state2)
        pixel = torch.where(take, new_pixel, pixel)
        throughput = vec.where3(take, ones3,
                                vec.where3(cont, throughput * ratio,
                                           throughput))
        result = vec.where3(take | terminated, zeros3, result)
        bsdf_pdf = torch.where(take, 0.0, torch.where(cont, pdf * rr,
                                                      bsdf_pdf))
        depth = torch.where(take, 0, depth)
        alive = still | take
        next_sample = next_sample + n_taken
    return film, count

"""Path-regeneration wavefront PT: the throughput variant of render/pt.py.

Port of spcbpt_tpu/render/pt_pool.py. `render_pool`: a fixed pool of
lanes runs a loop; whenever a lane terminates, its result scatter-adds into
the film and the lane restarts on the next camera sample from a global
counter, so utilization stays high whatever the path-length distribution.
`render_waves`, the scatter-free variant: one lane per pixel renders its
spp samples in turn, its film entry the lane's own sum. Same estimator (the
sky's escape radiance included) and same per-pixel sample counts as
render/pt.py; in both, sample rep r of pixel p uses seed(p, subframe0 + r),
so per pixel they differ only in summation order and traversal ties.

The loop condition (any lane alive, or samples left) is read on the host
once per iteration. The pool's film scatter-add is `index_add_`, whose
order of atomic adds on the card is not deterministic.
"""
from __future__ import annotations

import torch

from ..config import CULL_BACKFACE, PT_MAX_DEPTH, SCENE_EPSILON
from ..scene.scene import TraceScene, local_geometry, trace_closest
from ..utils import profiling
from ..utils import rng as rng_mod
from ..utils import vec
from .pt import _nee, bounce, emitter_hit, escape


def _camera_rays(cam_uvw, width: int, height: int, subframe0: int, dev):
    """camera_ray(pixel, rep) -> (origins, dirs, rng state) of sample rep of
    each pixel, seeded by (pixel, subframe0 + rep); the first sample of
    subframe 0 goes through the pixel's centre."""
    eye, U, V, W = [torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in cam_uvw]

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
    return camera_ray


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


@profiling.traced("pt_pool.render", ends_frame=True)
def render_pool(ts: TraceScene, cam_uvw, width: int, height: int,
                spp: int, subframe0: int = 0, n_pool: int = 1 << 17,
                max_depth: int = PT_MAX_DEPTH):
    """Render `spp` samples/pixel on the scene's device; returns
    (film_sum (W*H,3), counts (W*H,) int32)."""
    dev = ts.device
    n_pixels = width * height
    total = n_pixels * spp
    n_pool = min(n_pool, total)
    camera_ray = _camera_rays(cam_uvw, width, height, subframe0, dev)

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

    while profiling.read_flag("pt_pool.sync",
                              alive.any() | (next_sample < total)):
        with profiling.span("pt_pool.iteration"):
            profiling.count("pt_pool.iterations", 1)
            live = alive
            (result, terminated, o, d, throughput, bsdf_pdf, depth,
             state2) = _path_step(ts, o, d, state, throughput, result,
                                  bsdf_pdf, depth, live, max_depth)
            still = live & ~terminated

            # flush finished samples into the film
            film.index_add_(0, pixel, torch.where(terminated[..., None],
                                                  result, 0.0))
            count.index_add_(0, pixel, terminated.to(torch.int32))

            # regenerate dead lanes from the global sample counter
            want = terminated | ~live
            rank = torch.cumsum(want.to(torch.int64), dim=0) - 1
            sid = next_sample + rank
            take = want & (sid < total)
            n_taken = take.sum()
            new_pixel = sid % n_pixels
            o_new, d_new, st_new = camera_ray(new_pixel, sid // n_pixels)

            o = vec.where3(take, o_new, o)
            d = vec.where3(take, d_new, d)
            state = torch.where(take, st_new, state2)
            pixel = torch.where(take, new_pixel, pixel)
            throughput = vec.where3(take, ones3, throughput)
            result = vec.where3(take | terminated, zeros3, result)
            bsdf_pdf = torch.where(take, 0.0, bsdf_pdf)
            depth = torch.where(take, 0, depth)
            alive = still | take
            next_sample = next_sample + n_taken
    return film, count


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
    camera_ray = _camera_rays(cam_uvw, width, height, subframe0, dev)
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

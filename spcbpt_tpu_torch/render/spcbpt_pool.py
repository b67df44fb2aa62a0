"""Path-regeneration SPCBPT/BDPT eye renderer (pool variant of
render/spcbpt.py — same estimator, near-full lane utilization).

Port of `render_pool` of spcbpt_tpu/render/spcbpt_pool.py. A fixed pool of
lanes runs a loop: whenever a lane terminates, its result scatter-adds into
the film and the lane restarts on the next camera sample from a global
counter. One LVC sampler (one frame of light sub-paths) serves all samples
of the call; the reference refreshes the LVC every progressive frame, so
callers use spp=1 per sampler for parity.

As in the port's PT pool, the loop condition (any lane alive, or samples
left) is read on the host once per iteration, and the film scatter-add is
`index_add_`, whose order of atomic adds on the card is not deterministic.
"""
from __future__ import annotations

import torch

from spcbpt_tpu.config import CONNECTION_N

from ..scene.scene import TraceScene
from ..train import classify
from ..utils import rng as rng_mod
from ..utils import vec
from .lvc import LVCSampler
from .spcbpt import _eye_bounce, _init_eye_vertices, _select


def render_pool(ts: TraceScene, ss: classify.SubspaceState,
                sampler: LVCSampler, cam_uvw, width: int, height: int,
                spp: int, subframe0: int = 0, n_pool: int = 1 << 16,
                max_depth: int = 16, connection_n: int = CONNECTION_N,
                uniform: bool = False, second_stage=None):
    """Render `spp` samples/pixel on the scene's device; returns
    (film_sum (W*H, 3), counts (W*H,) int32)."""
    if ts.has_env:
        raise NotImplementedError("environment maps are not ported yet")
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

    def fresh_lanes(pixel, rep):
        o, d, state = camera_ray(pixel, rep)
        n = pixel.shape[0]
        return dict(o=o, d=d, state=state, v=_init_eye_vertices(o, d),
                    ratio=torch.ones((n, 3), device=dev),
                    pending_f=torch.ones((n, 3), device=dev),
                    pending_single=torch.ones((n,), device=dev),
                    result=torch.zeros((n, 3), device=dev),
                    depth=torch.zeros((n,), dtype=torch.int32, device=dev))

    lane = torch.arange(n_pool, dtype=torch.int64, device=dev)
    pixel = lane % n_pixels
    c = fresh_lanes(pixel, lane // n_pixels)
    alive = torch.ones((n_pool,), dtype=torch.bool, device=dev)
    next_sample = torch.tensor(n_pool, dtype=torch.int64, device=dev)
    film = torch.zeros((n_pixels, 3), device=dev)
    count = torch.zeros((n_pixels,), dtype=torch.int32, device=dev)

    while bool(alive.any() | (next_sample < total)):
        live = alive
        # pool-exhausted (~alive) lanes: dead-lane tmax skips their traversal
        b = _eye_bounce(ts, ss, sampler, c, connection_n, uniform,
                        second_stage, live)
        result, cont, keep = b["result"], b["cont"], b["hit_surf"]

        depth = c["depth"] + 1
        terminated = live & (b["miss"] | b["hit_light"] | (keep & ~cont)
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
        fresh = fresh_lanes(new_pixel, sid // n_pixels)

        v_next = _select(take, fresh["v"], _select(keep, b["mid"], c["v"]))
        c = dict(
            o=vec.where3(take, fresh["o"], vec.where3(cont, b["P"], c["o"])),
            d=vec.where3(take, fresh["d"],
                         vec.where3(cont, b["new_d"], c["d"])),
            state=torch.where(take, fresh["state"], b["state"]),
            v=v_next,
            ratio=vec.where3(take, fresh["ratio"],
                             vec.where3(keep, b["ratio_mid"], c["ratio"])),
            pending_f=vec.where3(take, fresh["pending_f"],
                                 vec.where3(cont, b["f"], c["pending_f"])),
            pending_single=torch.where(
                take, 1.0, torch.where(cont, b["pdf_rr"],
                                       c["pending_single"])),
            result=torch.where((take | terminated)[..., None], 0.0, result),
            depth=torch.where(take, 0, depth))
        pixel = torch.where(take, new_pixel, pixel)
        alive = still | take
        next_sample = next_sample + n_taken
    return film, count

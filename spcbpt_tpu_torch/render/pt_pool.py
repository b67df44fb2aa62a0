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

The pool's loop body (`_iteration`) is one function over a fixed set of
buffers (`_Pool`), which it updates in place, loop condition included.
On a CUDA scene in `brute` mode (`graph_route`: fixed shapes, and no host
sync inside the body) the first frame of a key runs the body once eagerly,
captures it as a CUDA graph, and each later iteration replays the graph:
one host launch in place of the body's ~1,250. The other modes (`tile`,
`bvh` and `walk` sync inside their traversal) and the CPU run the same
body eagerly. The pools of the last MAX_POOLS keys stay cached, each
dropped with its scene; a pool serves one thread at a time.
"""
from __future__ import annotations

import collections
import functools
import weakref

import torch

from .. import kernels
from ..config import CULL_BACKFACE, PT_MAX_DEPTH, SCENE_EPSILON
from ..scene.scene import TraceScene, local_geometry, trace_closest
from ..utils import profiling
from ..utils import rng as rng_mod
from ..utils import vec
from .pt import _nee, bounce, emitter_hit, escape

# pools (buffers, and the graph of their loop body) kept across calls
MAX_POOLS = 4


def _camera(cam_uvw, dev) -> torch.Tensor:
    """The camera's eye, U, V, W as the rows of a (4, 3) float32 tensor."""
    return torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev)
                        for x in cam_uvw])


def _camera_rays(cam, width: int, height: int, subframe0):
    """camera_ray(pixel, rep) -> (origins, dirs, rng state) of sample rep of
    each pixel, seeded by (pixel, subframe0 + rep); the first sample of
    subframe 0 goes through the pixel's centre. cam: the (4, 3) camera;
    subframe0: an int64 scalar tensor on its device."""
    eye, U, V, W = cam

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


class _Pool:
    """The buffers of one pool render, on one device: the lanes' path
    state, the film and counts, the frame's inputs (camera, subframe0) and
    the loop flag; on the graph route, the captured loop body and the
    kernel launches it records."""

    def __init__(self, n_pool: int, n_pixels: int, dev):
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.o, self.d = zeros(n_pool, 3), zeros(n_pool, 3)
        self.state = zeros(n_pool, dtype=torch.int64)
        self.throughput, self.result = zeros(n_pool, 3), zeros(n_pool, 3)
        self.bsdf_pdf = zeros(n_pool)
        self.depth = zeros(n_pool, dtype=torch.int32)
        self.alive = zeros(n_pool, dtype=torch.bool)
        self.pixel = zeros(n_pool, dtype=torch.int64)
        self.next_sample = zeros(dtype=torch.int64)
        self.film = zeros(n_pixels, 3)
        self.count = zeros(n_pixels, dtype=torch.int32)
        self.cam = zeros(4, 3)
        self.subframe0 = zeros(dtype=torch.int64)
        self.flag = zeros(dtype=torch.bool)
        self.zeros3 = zeros(n_pool, 3)
        self.ones3 = torch.ones((n_pool, 3), device=dev)
        self.graph = None
        self.launches = {}


# (id(scene), width, height, spp, n_pool, max_depth, device) -> _Pool,
# least recently used first; id(scene) -> the finalizer that drops its
# pools with it
_POOLS = collections.OrderedDict()
_SCENES = {}


def _drop(scene_id: int) -> None:
    _SCENES.pop(scene_id, None)
    for key in [k for k in _POOLS if k[0] == scene_id]:
        del _POOLS[key]


def _pool(ts: TraceScene, width: int, height: int, spp: int, n_pool: int,
          max_depth: int) -> _Pool:
    """The pool of this scene and key, made at its first use; beyond
    MAX_POOLS the least recently used is dropped."""
    key = (id(ts), width, height, spp, n_pool, max_depth, ts.device)
    pool = _POOLS.pop(key, None)
    if pool is None:
        pool = _Pool(n_pool, width * height, ts.device)
        if id(ts) not in _SCENES:
            _SCENES[id(ts)] = weakref.finalize(ts, _drop, id(ts))
    _POOLS[key] = pool
    while len(_POOLS) > MAX_POOLS:
        _POOLS.popitem(last=False)
    return pool


def graph_route(device, mode: str) -> bool:
    """Whether the pool replays its loop body as a CUDA graph: on a CUDA
    device in `brute` mode, whose body has fixed shapes and no host sync."""
    return torch.device(device).type == "cuda" and mode == "brute"


def _start(p: _Pool, cam_uvw, subframe0: int, width: int, height: int,
           total: int) -> None:
    """A frame's set-up, written into p: the camera and subframe0, each
    lane on its first sample, the film and counts zeroed, the loop flag."""
    n_pool = p.alive.shape[0]
    n_pixels = width * height
    p.cam.copy_(_camera(cam_uvw, p.cam.device))
    p.subframe0.fill_(subframe0)
    lane = torch.arange(n_pool, dtype=torch.int64, device=p.cam.device)
    pixel = lane % n_pixels
    o, d, state = _camera_rays(p.cam, width, height, p.subframe0)(
        pixel, lane // n_pixels)
    p.o.copy_(o)
    p.d.copy_(d)
    p.state.copy_(state)
    p.pixel.copy_(pixel)
    p.throughput.fill_(1.0)
    p.result.zero_()
    p.bsdf_pdf.zero_()
    p.depth.zero_()
    p.alive.fill_(True)
    p.next_sample.fill_(n_pool)
    p.film.zero_()
    p.count.zero_()
    p.flag.fill_(total > 0)


def _iteration(ts: TraceScene, p: _Pool, width: int, height: int,
               total: int, max_depth: int) -> None:
    """One pass of the loop body over p, its buffers updated in place at
    the end, the loop flag (any lane alive, or samples left) included."""
    n_pixels = width * height
    live = p.alive
    (result, terminated, o, d, throughput, bsdf_pdf, depth,
     state2) = _path_step(ts, p.o, p.d, p.state, p.throughput, p.result,
                          p.bsdf_pdf, p.depth, live, max_depth)
    still = live & ~terminated

    # flush finished samples into the film
    p.film.index_add_(0, p.pixel, torch.where(terminated[..., None],
                                              result, 0.0))
    p.count.index_add_(0, p.pixel, terminated.to(torch.int32))

    # regenerate dead lanes from the global sample counter
    want = terminated | ~live
    rank = torch.cumsum(want.to(torch.int64), dim=0) - 1
    sid = p.next_sample + rank
    take = want & (sid < total)
    n_taken = take.sum()
    new_pixel = sid % n_pixels
    o_new, d_new, st_new = _camera_rays(p.cam, width, height, p.subframe0)(
        new_pixel, sid // n_pixels)

    p.o.copy_(vec.where3(take, o_new, o))
    p.d.copy_(vec.where3(take, d_new, d))
    p.state.copy_(torch.where(take, st_new, state2))
    p.pixel.copy_(torch.where(take, new_pixel, p.pixel))
    p.throughput.copy_(vec.where3(take, p.ones3, throughput))
    p.result.copy_(vec.where3(take | terminated, p.zeros3, result))
    p.bsdf_pdf.copy_(torch.where(take, 0.0, bsdf_pdf))
    p.depth.copy_(torch.where(take, 0, depth))
    p.alive.copy_(still | take)
    p.next_sample.add_(n_taken)
    p.flag.copy_(p.alive.any() | (p.next_sample < total))


def _capture(step, dev) -> tuple:
    """step() once eagerly on a side stream, as CUDA graph capture asks of
    the work it records, then step() captured: (the graph, the kernel
    launches it records, which run once a replay)."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with kernels.capture_launches() as launches, torch.cuda.graph(graph):
            step()
    return graph, launches


@profiling.traced("pt_pool.render", ends_frame=True)
def render_pool(ts: TraceScene, cam_uvw, width: int, height: int,
                spp: int, subframe0: int = 0, n_pool: int = 1 << 17,
                max_depth: int = PT_MAX_DEPTH):
    """Render `spp` samples/pixel on the scene's device; returns
    (film_sum (W*H,3), counts (W*H,) int32), the caller's own: no later
    call writes them."""
    total = width * height * spp
    n_pool = min(n_pool, total)
    p = _pool(ts, width, height, spp, n_pool, max_depth)
    _start(p, cam_uvw, subframe0, width, height, total)
    graphed = graph_route(ts.device, ts.mode)
    step = functools.partial(_iteration, ts, p, width, height, total,
                             max_depth)
    while profiling.read_flag("pt_pool.sync", p.flag):
        with profiling.span("pt_pool.iteration"):
            profiling.count("pt_pool.iterations", 1)
            if not graphed:
                step()
            elif p.graph is None:
                # the warm-up pass is this iteration; the capture runs
                # nothing
                p.graph, p.launches = _capture(step, ts.device)
                profiling.count("pt_pool.graph_captures", 1)
            else:
                p.graph.replay()
                kernels.add_launches(p.launches)
                profiling.count("pt_pool.graph_replays", 1)
    return p.film.clone(), p.count.clone()


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
    camera_ray = _camera_rays(
        _camera(cam_uvw, dev), width, height,
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

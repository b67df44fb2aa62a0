"""The path-regeneration pool loop that both pool renderers run
(render/pt_pool.py, render/spcbpt_pool.py).

A fixed pool of lanes runs a loop; whenever a lane terminates, its result
scatter-adds into the film and the lane restarts on the next camera sample
from a global counter, so utilization stays high whatever the path-length
distribution. Sample rep r of pixel p is seeded by (p, subframe0 + r).

The loop condition (any lane alive, or samples left) is read on the host
once per iteration. The film scatter-add is `index_add_`, whose order of
atomic adds on the card is not deterministic.

The loop body is one function over a fixed set of buffers (a `Pool`, to
which each estimator adds its lanes' state), which it updates in place,
loop condition included. On a CUDA scene in `brute` or `walk` mode
(`graph_route`: fixed shapes, and no host sync inside the body; the walk's
sort, its K1/K2 launches over each part and its set-up stay on the device)
the first frame of a key runs the body once eagerly, captures it as a CUDA
graph, and each later iteration replays the graph: one host launch in
place of the body's hundreds or thousands. The other modes (`tile`'s K4
round loop and the `bvh` walk sync on the host) and the CPU run the same
body eagerly. Each estimator keeps its pools in a `Cache` of its own; a
pool serves one thread at a time. `Graphed` takes the same route for the
light pass and its sampler build, each one graph a call.
"""
from __future__ import annotations

import collections
import weakref

import torch

from .. import kernels
from ..utils import profiling
from ..utils import rng as rng_mod
from ..utils import vec

# pools (buffers, and the graph of their loop body) a cache keeps
MAX_POOLS = 4


def graph_route(device, mode: str) -> bool:
    """Whether the pool replays its loop body as a CUDA graph: on a CUDA
    device in `brute` (K3) or `walk` (K1/K2) mode, whose body has fixed
    shapes and no host sync. `tile` and `bvh` sync inside their traversal
    and stay eager."""
    return torch.device(device).type == "cuda" and mode in ("brute", "walk")


def capture(step, dev) -> tuple:
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


class Graphed:
    """A function of fixed device buffers run as one CUDA graph, on the
    graph route of the light pass and of its sampler build
    (render/light_trace.py, render/lvc.py): the first call runs it once
    eagerly and captures it, each later call replays the graph. Its
    result, a dict of tensors, is copied into fixed output buffers, and
    each call returns a copy of them, the caller's own. The function is
    passed at every call and not kept: a captured graph holds no Python
    object, so the buffers' owners can be collected."""

    def __init__(self):
        self.out = None
        self.graph = None
        self.launches = {}

    def __call__(self, name: str, fn, dev) -> dict:
        """fn() captured or replayed, under the counters `name`.*."""
        if self.graph is None:
            def step():
                got = fn()
                if self.out is None:
                    # the warm-up pass gives the buffers their shapes
                    self.out = {k: torch.empty_like(v)
                                for k, v in got.items()}
                for k, v in got.items():
                    self.out[k].copy_(v)
            # the warm-up pass is this call; the capture runs nothing
            self.graph, self.launches = capture(step, dev)
            profiling.count(f"{name}.graph_captures", 1)
        else:
            self.graph.replay()
            kernels.add_launches(self.launches)
            profiling.count(f"{name}.graph_replays", 1)
        return {k: v.clone() for k, v in self.out.items()}


def camera(cam_uvw, dev) -> torch.Tensor:
    """The camera's eye, U, V, W as the rows of a (4, 3) float32 tensor."""
    return torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev)
                        for x in cam_uvw])


def camera_rays(cam, width: int, height: int, subframe0):
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


class Cache:
    """The pools of the last MAX_POOLS keys, least recently used first.
    A key is the ids of the pool's owners followed by the rest of the key
    the estimator builds; a pool is dropped when any of its owners is
    collected."""

    def __init__(self):
        self.pools = collections.OrderedDict()
        # (the owner's place in the key, its id) -> the finalizer that
        # drops its pools with it
        self.owners = {}

    def get(self, owners: tuple, rest: tuple, make):
        """The pool of this key, make() at its first use."""
        key = tuple(map(id, owners)) + rest
        pool = self.pools.pop(key, None)
        if pool is None:
            pool = make()
            for at, obj in enumerate(owners):
                if (at, id(obj)) not in self.owners:
                    self.owners[at, id(obj)] = weakref.finalize(
                        obj, self._drop, at, id(obj))
        self.pools[key] = pool
        while len(self.pools) > MAX_POOLS:
            self.pools.popitem(last=False)
        return pool

    def _drop(self, at: int, ident: int) -> None:
        self.owners.pop((at, ident), None)
        for key in [k for k in self.pools if k[at] == ident]:
            del self.pools[key]


class Pool:
    """The frame half of one pool render's buffers, on one device: each
    lane's pixel and liveness, the next sample, the film and counts, the
    frame's inputs (camera, subframe0) and the loop flag; on the graph
    route, the captured loop body and the kernel launches it records. Each
    estimator's pool adds its lanes' state."""

    def __init__(self, n_pool: int, n_pixels: int, dev):
        self.dev = dev
        self.pixel = self.zeros(n_pool, dtype=torch.int64)
        self.alive = self.zeros(n_pool, dtype=torch.bool)
        self.next_sample = self.zeros(dtype=torch.int64)
        self.film = self.zeros(n_pixels, 3)
        self.count = self.zeros(n_pixels, dtype=torch.int32)
        self.cam = self.zeros(4, 3)
        self.subframe0 = self.zeros(dtype=torch.int64)
        self.flag = self.zeros(dtype=torch.bool)
        self.graph = None
        self.launches = {}

    def zeros(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.dev)


def start(p: Pool, cam_uvw, subframe0: int, width: int, height: int,
          total: int, fresh) -> None:
    """A frame's set-up, written into p: the camera and subframe0, each
    lane on its first sample (fresh(pixel, rep) writes the estimator's
    lane state), the film and counts zeroed, the loop flag."""
    n_pool = p.alive.shape[0]
    n_pixels = width * height
    p.cam.copy_(camera(cam_uvw, p.cam.device))
    p.subframe0.fill_(subframe0)
    lane = torch.arange(n_pool, dtype=torch.int64, device=p.cam.device)
    pixel = lane % n_pixels
    fresh(pixel, lane // n_pixels)
    p.pixel.copy_(pixel)
    p.alive.fill_(True)
    p.next_sample.fill_(n_pool)
    p.film.zero_()
    p.count.zero_()
    p.flag.fill_(total > 0)


def regenerate(p: Pool, terminated, result, n_pixels: int, total: int,
               refill) -> None:
    """The end of one pass of the loop body, once the estimator has moved
    its live lanes on: the terminated lanes' results flushed into the film,
    dead lanes restarted on the next samples of the global counter
    (refill(take, pixel, rep) writes the estimator's lane state, new on the
    `take` lanes), then each lane's pixel and liveness, the counter and the
    loop flag (any lane alive, or samples left)."""
    live = p.alive
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
    refill(take, new_pixel, sid // n_pixels)
    p.pixel.copy_(torch.where(take, new_pixel, p.pixel))
    p.alive.copy_(still | take)
    p.next_sample.add_(n_taken)
    p.flag.copy_(p.alive.any() | (p.next_sample < total))


def run(name: str, ts, p: Pool, step):
    """The loop over p, started: step() a pass of its body, run eagerly,
    or captured and replayed as a CUDA graph on the graph route, under the
    spans and counters `name`.*. Returns (film_sum (W*H, 3), counts (W*H,)
    int32), the caller's own: no later call writes them."""
    graphed = graph_route(ts.device, ts.mode)
    while profiling.read_flag(f"{name}.sync", p.flag):
        with profiling.span(f"{name}.iteration"):
            profiling.count(f"{name}.iterations", 1)
            if not graphed:
                step()
            elif p.graph is None:
                # the warm-up pass is this iteration; the capture runs
                # nothing
                p.graph, p.launches = capture(step, ts.device)
                profiling.count(f"{name}.graph_captures", 1)
            else:
                p.graph.replay()
                kernels.add_launches(p.launches)
                profiling.count(f"{name}.graph_replays", 1)
    return p.film.clone(), p.count.clone()

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

The loop body (`_iteration`) is one function over a fixed set of buffers
(`_Pool`), which it updates in place, loop condition included; it reads
the light-vertex sampler only through the pool's copy, into which each
call copies the sampler it is given (a sampler's shapes are fixed by its
light paths and depth; only its addresses change from frame to frame).
As render/pt_pool.py does, on a CUDA scene in `brute` mode the first
frame of a key runs the body once eagerly, captures it as a CUDA graph,
and each later iteration replays the graph; other modes and the CPU run
the same body eagerly. The pools of the last MAX_POOLS keys stay cached,
each dropped with its scene or its subspace state; a pool serves one
thread at a time.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import weakref

import torch

from .. import kernels
from ..config import CONNECTION_N
from ..scene.scene import TraceScene
from ..train import classify
from ..utils import profiling
from ..utils import vec
from .lvc import LVCSampler
from .pt_pool import _camera, _camera_rays, _capture, graph_route
from .spcbpt import _eye_bounce, _init_eye_vertices, _select
from .vertex import map_fields

# pools (buffers, the sampler's copy, the graph of their loop body) kept
# across calls
MAX_POOLS = 4
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
    o, d, state = _camera_rays(cam, width, height, subframe0)(pixel, rep)
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


class _Pool:
    """The buffers of one pool render, on one device: the lanes' path
    state and eye vertices, their pixels and liveness, the film and
    counts, the frame's inputs (camera, subframe0, the sampler's copy) and
    the loop flag; on the graph route, the captured loop body and the
    kernel launches it records."""

    def __init__(self, n_pool: int, n_pixels: int, sampler: LVCSampler,
                 dev):
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.o, self.d = zeros(n_pool, 3), zeros(n_pool, 3)
        self.state = zeros(n_pool, dtype=torch.int64)
        self.ratio, self.pending_f = zeros(n_pool, 3), zeros(n_pool, 3)
        self.pending_single = zeros(n_pool)
        self.result = zeros(n_pool, 3)
        self.depth = zeros(n_pool, dtype=torch.int32)
        self.v = map_fields(torch.zeros_like,
                            _init_eye_vertices(self.o, self.d))
        self.pixel = zeros(n_pool, dtype=torch.int64)
        self.alive = zeros(n_pool, dtype=torch.bool)
        self.next_sample = zeros(dtype=torch.int64)
        self.film = zeros(n_pixels, 3)
        self.count = zeros(n_pixels, dtype=torch.int32)
        self.flag = zeros(dtype=torch.bool)
        self.cam = zeros(4, 3)
        self.subframe0 = zeros(dtype=torch.int64)
        self.sampler = dataclasses.replace(
            sampler, vertices=None, seg_sum=None,
            **{f: None if getattr(sampler, f) is None
               else torch.empty_like(getattr(sampler, f))
               for f in SAMPLER_FIELDS})
        self.graph = None
        self.launches = {}


# (id(scene), id(state), width, height, spp, n_pool, max_depth,
# connection_n, uniform, second_stage, the sampler's key, device) -> _Pool,
# least recently used first; id(scene) and id(state) -> the finalizers
# that drop their pools with them
_POOLS = collections.OrderedDict()
_SCENES = {}
_STATES = {}


def _drop(owners: dict, at: int, ident: int) -> None:
    owners.pop(ident, None)
    for key in [k for k in _POOLS if k[at] == ident]:
        del _POOLS[key]


def _pool(ts: TraceScene, ss: classify.SubspaceState, sampler: LVCSampler,
          width: int, height: int, spp: int, n_pool: int, max_depth: int,
          connection_n: int, uniform: bool, second_stage) -> _Pool:
    """The pool of this scene, state and key, made at its first use;
    beyond MAX_POOLS the least recently used is dropped."""
    key = (id(ts), id(ss), width, height, spp, n_pool, max_depth,
           connection_n, uniform, second_stage, _sampler_key(sampler),
           ts.device)
    pool = _POOLS.pop(key, None)
    if pool is None:
        pool = _Pool(n_pool, width * height, sampler, ts.device)
        for owners, at, obj in ((_SCENES, 0, ts), (_STATES, 1, ss)):
            if id(obj) not in owners:
                owners[id(obj)] = weakref.finalize(obj, _drop, owners, at,
                                                   id(obj))
    _POOLS[key] = pool
    while len(_POOLS) > MAX_POOLS:
        _POOLS.popitem(last=False)
    return pool


def _copy_fields(dst, src) -> None:
    """Each tensor field of record `dst` overwritten by src's."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def _start(p: _Pool, sampler: LVCSampler, cam_uvw, subframe0: int,
           width: int, height: int, total: int) -> None:
    """A frame's set-up, written into p: the sampler's tensors, the camera
    and subframe0, each lane on its first sample, the film and counts
    zeroed, the loop flag."""
    for f in SAMPLER_FIELDS:
        if getattr(p.sampler, f) is not None:
            getattr(p.sampler, f).copy_(getattr(sampler, f))
    n_pool = p.alive.shape[0]
    n_pixels = width * height
    p.cam.copy_(_camera(cam_uvw, p.cam.device))
    p.subframe0.fill_(subframe0)
    lane = torch.arange(n_pool, dtype=torch.int64, device=p.cam.device)
    pixel = lane % n_pixels
    c = _fresh(p.cam, width, height, p.subframe0, pixel, lane // n_pixels)
    for f in LANE_FIELDS:
        getattr(p, f).copy_(c[f])
    _copy_fields(p.v, c["v"])
    p.pixel.copy_(pixel)
    p.alive.fill_(True)
    p.next_sample.fill_(n_pool)
    p.film.zero_()
    p.count.zero_()
    p.flag.fill_(total > 0)


def _iteration(ts: TraceScene, ss: classify.SubspaceState, p: _Pool,
               width: int, height: int, total: int, max_depth: int,
               connection_n: int, uniform: bool, second_stage) -> None:
    """One pass of the loop body over p: the eye bounce of every live
    lane, the flush of finished samples, the regeneration of dead lanes;
    its buffers updated in place at the end, the loop flag (any lane
    alive, or samples left) last."""
    n_pixels = width * height
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
    fresh = _fresh(p.cam, width, height, p.subframe0, new_pixel,
                   sid // n_pixels)

    v_next = _select(take, fresh["v"], _select(keep, b["mid"], c["v"]))
    nxt = dict(
        o=vec.where3(take, fresh["o"], vec.where3(cont, b["P"], c["o"])),
        d=vec.where3(take, fresh["d"], vec.where3(cont, b["new_d"], c["d"])),
        state=torch.where(take, fresh["state"], b["state"]),
        ratio=vec.where3(take, fresh["ratio"],
                         vec.where3(keep, b["ratio_mid"], c["ratio"])),
        pending_f=vec.where3(take, fresh["pending_f"],
                             vec.where3(cont, b["f"], c["pending_f"])),
        pending_single=torch.where(
            take, 1.0, torch.where(cont, b["pdf_rr"], c["pending_single"])),
        result=torch.where((take | terminated)[..., None], 0.0, result),
        depth=torch.where(take, 0, depth))
    pixel = torch.where(take, new_pixel, p.pixel)
    for f in LANE_FIELDS:
        getattr(p, f).copy_(nxt[f])
    _copy_fields(p.v, v_next)
    p.pixel.copy_(pixel)
    p.alive.copy_(still | take)
    p.next_sample.add_(n_taken)
    p.flag.copy_(p.alive.any() | (p.next_sample < total))


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
    p = _pool(ts, ss, sampler, width, height, spp, n_pool, max_depth,
              connection_n, uniform, second_stage)
    _start(p, sampler, cam_uvw, subframe0, width, height, total)
    graphed = graph_route(ts.device, ts.mode)
    step = functools.partial(_iteration, ts, ss, p, width, height, total,
                             max_depth, connection_n, uniform, second_stage)
    while profiling.read_flag("spcbpt_pool.sync", p.flag):
        with profiling.span("spcbpt_pool.iteration"):
            profiling.count("spcbpt_pool.iterations", 1)
            if not graphed:
                step()
            elif p.graph is None:
                # the warm-up pass is this iteration; the capture runs
                # nothing
                p.graph, p.launches = _capture(step, ts.device)
                profiling.count("spcbpt_pool.graph_captures", 1)
            else:
                p.graph.replay()
                kernels.add_launches(p.launches)
                profiling.count("spcbpt_pool.graph_replays", 1)
    return p.film.clone(), p.count.clone()

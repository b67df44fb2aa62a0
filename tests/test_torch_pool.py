"""The pool loop both pool renderers run (render/pool.py), on the CPU: the
route choice (a CUDA graph only on CUDA scenes in `brute` or `walk` mode),
the launch-count helper, and for each of the PT and SPCBPT pools: that it
runs through the one loop with no route, capture or cache of its own, the
eager body on the CPU, the graph route's bookkeeping with a stand-in for
the capture (tests/graph_stand_in.py) on a brute-mode and a walk-mode
scene, a walk-mode iteration that builds no tensor from host data (what a
capture cannot record), films that stay the caller's own, and the cache's
bound and its release with its owners; then the shared flush and
regeneration on hand-built lanes."""
import ast
import gc
import inspect

import numpy as np
import pytest
import torch

from spcbpt_tpu_torch import kernels
from spcbpt_tpu_torch.config import CULL_BACKFACE, SCENE_EPSILON
from spcbpt_tpu_torch.kernels import brute_trace
from spcbpt_tpu_torch.render import light_trace, lvc, pool, pt_pool
from spcbpt_tpu_torch.render import spcbpt_pool
from spcbpt_tpu_torch.scene import scene as scene_mod
from spcbpt_tpu_torch.scene.cornell import default_scene_path
from spcbpt_tpu_torch.train import classify
from spcbpt_tpu_torch.utils import profiling

from graph_stand_in import graphed, refuse_host_data  # noqa: F401

torch.set_num_threads(1)

SIDE = 12
N_POOL = 160
EYE_DEPTH = 8
LIGHT_PATHS = 600
LIGHT_DEPTH = 5
# three frames: (subframe0, how far the eye moves along the camera's U)
FRAMES = ((3, 0.0), (7, 0.15), (11, -0.1))
POOLS = {"pt": pt_pool, "spcbpt": spcbpt_pool}
KINDS = sorted(POOLS)
# the launches of one iteration of either pool on a scene of one cluster
# set (PT: the path's closest hit and NEE's shadow ray; SPCBPT: the eye
# bounce and the connections' visibility), K3 on brute and K1/K2 on walk
RECORDED = {"brute": {"brute_closest": 1, "brute_any": 1},
            "walk": {"walk_closest": 1, "walk_any": 1}}


@pytest.fixture(scope="module")
def cornell():
    ts, _, cam = scene_mod.load_trace_scene(default_scene_path(), "cpu")
    cam.aspect = 1.0
    return cam.uvw()


def _scene(mode=None):
    ts, _, _ = scene_mod.load_trace_scene(default_scene_path(), "cpu",
                                          mode=mode)
    return ts


def _moved(uvw, step: float):
    eye, U, V, W = (np.asarray(x, np.float64) for x in uvw)
    return (eye + step * U / np.linalg.norm(U), U, V, W)


def _sampler(ts, ss, light_frame: int):
    lv = light_trace.trace_light_paths(ts, ss, LIGHT_PATHS, light_frame,
                                       max_depth=LIGHT_DEPTH)
    return lvc.make_builder(ss)(lv, light_frame)


class _Renderer:
    """Frames of pool `kind` on a scene of its own (and, for SPCBPT, a
    subspace state and a sampler for each light frame)."""

    def __init__(self, kind: str, ts=None):
        self.kind, self.mod = kind, POOLS[kind]
        self.ts = _scene() if ts is None else ts
        if kind == "spcbpt":
            self.ss = classify.synthetic_trained_state(self.ts, seed=0)
            self.samplers = {}

    def sampler(self, frame: int, ss=None):
        """The sampler of light frame 100 + frame under ss, built once."""
        ss = self.ss if ss is None else ss
        if (id(ss), frame) not in self.samplers:
            self.samplers[id(ss), frame] = _sampler(self.ts, ss, 100 + frame)
        return self.samplers[id(ss), frame]

    def __call__(self, uvw, sub, side=SIDE, spp=2, frame=0, ss=None, **kw):
        kw = {"n_pool": N_POOL, "max_depth": EYE_DEPTH, **kw}
        if self.kind == "pt":
            return pt_pool.render_pool(self.ts, uvw, side, side, spp, sub,
                                       **kw)
        ss = self.ss if ss is None else ss
        return spcbpt_pool.render_pool(self.ts, ss, self.sampler(frame, ss),
                                       uvw, side, side, spp, sub, **kw)

    def pools(self):
        """This scene's cache entries, least recently used first."""
        return [p for k, p in self.mod._POOLS.pools.items()
                if k[0] == id(self.ts)]


@pytest.mark.parametrize("device, mode, graph", [
    ("cuda", "brute", True), ("cuda:1", "brute", True),
    ("cpu", "brute", False), ("cuda", "tile", False),
    ("cuda", "bvh", False), ("cuda", "walk", True), ("cpu", "tile", False),
    ("cpu", "walk", False),
])
def test_graph_route_only_on_cuda_brute_and_walk(device, mode, graph):
    assert pool.graph_route(torch.device(device), mode) is graph


def test_capture_launches_counts_once_a_replay():
    kernels.reset_launches()
    brute_trace.LAUNCHES["brute_closest"] += 2          # ran before
    with kernels.capture_launches() as got:
        brute_trace.LAUNCHES["brute_closest"] += 3      # recorded
        brute_trace.LAUNCHES["brute_any"] += 1
    assert got == {"brute_closest": 3, "brute_any": 1}
    assert kernels.read_launches()["brute_closest"] == 2
    assert kernels.read_launches()["brute_any"] == 0
    for _ in range(4):
        kernels.add_launches(got)
    n = kernels.read_launches()
    assert n["brute_closest"] == 2 + 4 * 3 and n["brute_any"] == 4
    assert sum(n.values()) == 2 + 4 * 4
    kernels.reset_launches()


@pytest.mark.parametrize("kind, params", [
    ("pt", ["ts", "cam_uvw", "width", "height", "spp", "subframe0",
            "n_pool", "max_depth"]),
    ("spcbpt", ["ts", "ss", "sampler", "cam_uvw", "width", "height", "spp",
                "subframe0", "n_pool", "max_depth", "connection_n",
                "uniform", "second_stage"]),
])
def test_no_argument_chooses_the_route(kind, params):
    assert list(inspect.signature(
        POOLS[kind].render_pool).parameters) == params


@pytest.mark.parametrize("kind", KINDS)
def test_both_pools_run_through_the_one_loop(cornell, kind, monkeypatch):
    """render_pool goes through pool.run under its own prefix; the module
    defines no route, capture, camera or cache of its own, and imports
    neither the other pool nor any name of it."""
    mod = POOLS[kind]
    names = []

    def run(name, ts, p, step):
        names.append(name)
        return loop(name, ts, p, step)
    loop = pool.run
    monkeypatch.setattr(pool, "run", run)
    _Renderer(kind)(cornell, 0, side=6, spp=1)
    assert names == [f"{kind}_pool"]
    for name in ("graph_route", "_capture", "capture", "_camera",
                 "_camera_rays", "MAX_POOLS", "_drop", "_pool", "_SCENES",
                 "_STATES", "collections", "weakref", "kernels"):
        assert not hasattr(mod, name), name
    assert isinstance(mod._POOLS, pool.Cache)
    assert issubclass(mod._Pool, pool.Pool)
    other = [m for k, m in POOLS.items() if k != kind][0]
    for node in ast.walk(ast.parse(inspect.getsource(mod))):
        if isinstance(node, ast.ImportFrom):
            assert other.__name__.split(".")[-1] not in (
                [node.module or ""] + [a.name for a in node.names])
    assert not [v for v in vars(mod).values() if v is other]


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_renders_take_the_eager_body(cornell, kind):
    """A CPU brute-mode render captures nothing and counts no graph."""
    render = _Renderer(kind)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        render(cornell, 0, side=8, spp=1)
    got = profiling.collect()
    assert list(got["counters"]) == [f"{kind}_pool.iterations"]
    (p,) = render.pools()
    assert p.graph is None and p.launches == {}


def _check_graph_route(cornell, kind, mode, frames, monkeypatch):
    """Frame 1 of a key: its first iteration the warm-up and capture, every
    later one a replay; later frames (each on its own light frame, for
    SPCBPT, built beforehand): replays alone, one an iteration. The launch
    counters gain an iteration's launches for the warm-up pass and each
    replay, and none for the capture, as the eager route counts them; the
    other pool counts nothing. Films and counts equal the eager route's."""
    render = _Renderer(kind, _scene(mode))
    assert render.ts.mode == mode
    name = f"{kind}_pool"
    counters, launches, outs = [], [], []
    for k, (sub, step) in enumerate(frames):
        if kind == "spcbpt":
            render.sampler(k)
        kernels.reset_launches()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            outs.append(render(_moved(cornell, step), sub, frame=k))
        counters.append({c: sum(v.values()) for c, v in
                         profiling.collect()["counters"].items()})
        launches.append(kernels.read_launches())
    first = counters[0]
    assert first[f"{name}.graph_captures"] == 1
    assert (first[f"{name}.graph_replays"]
            == first[f"{name}.iterations"] - 1)
    for later in counters[1:]:
        assert f"{name}.graph_captures" not in later
        assert (later[f"{name}.graph_replays"]
                == later[f"{name}.iterations"] > 1)
    for c, n in zip(counters, launches):
        assert all(k.startswith(name + ".") for k in c), c
        assert {kernel for kernel, k in n.items() if k} == set(
            RECORDED[mode])
        for kernel, k in RECORDED[mode].items():
            assert n[kernel] == k * c[f"{name}.iterations"]

    monkeypatch.setattr(pool, "graph_route", lambda device, mode: False)
    eager = _Renderer(kind, render.ts)
    if kind == "spcbpt":
        eager.ss, eager.samplers = render.ss, render.samplers
    for k, ((sub, step), (f, c)) in enumerate(zip(frames, outs)):
        ef, ec = eager(_moved(cornell, step), sub, frame=k)
        assert torch.equal(f, ef) and torch.equal(c, ec)


@pytest.mark.parametrize("kind", KINDS)
def test_graph_route_counts_captures_replays_and_launches(cornell, kind,
                                                          graphed,
                                                          monkeypatch):
    """The graph route's bookkeeping on a brute-mode scene (K3)."""
    _check_graph_route(cornell, kind, "brute", FRAMES, monkeypatch)


@pytest.mark.parametrize("kind", KINDS)
def test_walk_scene_takes_the_graph_route(cornell, kind, graphed,
                                          monkeypatch):
    """The same bookkeeping on a walk-mode scene (K1/K2): one capture, then
    replays alone, films and counts equal to the eager body's."""
    _check_graph_route(cornell, kind, "walk", FRAMES[:2], monkeypatch)


# lanes of the walk traces below: not a multiple of the walk's padding unit
WALK_LANES = 200


@pytest.mark.parametrize("query", ["closest", "any"])
def test_walk_trace_set_up_takes_no_host_data(cornell, query, monkeypatch):
    """A walk-mode trace with number bounds over lanes the walk pads: no
    tensor made from host data, and the same hits as the unguarded call
    and as a call with the bounds as lanes."""
    ts = _scene("walk")
    assert WALK_LANES % 128
    gen = torch.Generator().manual_seed(7)
    eye = torch.as_tensor(np.asarray(cornell[0]), dtype=torch.float32)
    o = eye + 0.1 * torch.randn((WALK_LANES, 3), generator=gen)
    d = torch.randn((WALK_LANES, 3), generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    tmax = 1e16 if query == "closest" else 300.0

    def trace(tmin, tmax):
        if query == "closest":
            hit = scene_mod.trace_closest(ts, o, d, tmin, tmax,
                                          CULL_BACKFACE)
            return hit.t, hit.tri, hit.u, hit.v
        return (scene_mod.trace_any(ts, o, d, tmin, tmax),)
    with monkeypatch.context() as m:
        refuse_host_data(m)
        got = trace(SCENE_EPSILON, tmax)
    lanes = [torch.full((WALK_LANES,), x) for x in (SCENE_EPSILON, tmax)]
    for want in (trace(SCENE_EPSILON, tmax), trace(*lanes)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    if query == "closest":
        assert bool((got[1] >= 0).any()) and bool((got[1] < 0).any())
    else:
        assert bool(got[0].any()) and not bool(got[0].all())


def _start_pool(kind, ts, ss, sampler, cam_uvw):
    """A pool of N_POOL lanes on an 8x8 frame, 4 spp, started."""
    side = 8
    total = side * side * 4
    if kind == "pt":
        p = pt_pool._Pool(N_POOL, side * side, ts.device)
        pt_pool._start(p, cam_uvw, 0, side, side, total)
        return p, lambda: pt_pool._iteration(ts, p, side, side, total,
                                             EYE_DEPTH)
    p = spcbpt_pool._Pool(N_POOL, side * side, sampler, ts.device)
    spcbpt_pool._start(p, sampler, cam_uvw, 0, side, side, total)
    return p, lambda: spcbpt_pool._iteration(ts, ss, p, side, side, total,
                                             EYE_DEPTH, 3, False, None)


@pytest.mark.parametrize("kind", KINDS)
def test_walk_pool_iteration_takes_no_host_data(cornell, kind, monkeypatch):
    """One pass of the loop body on a walk-mode scene, over N_POOL lanes
    (which the walk pads), builds no tensor from host data, and leaves the
    pool's buffers as the unguarded pass does."""
    ts = _scene("walk")
    ss = sampler = None
    if kind == "spcbpt":
        ss = classify.synthetic_trained_state(ts, seed=0)
        sampler = _sampler(ts, ss, 100)
    assert N_POOL % 128
    bufs = []
    for guarded in (True, False):
        p, step = _start_pool(kind, ts, ss, sampler, cornell)
        if guarded:
            with monkeypatch.context() as m:
                refuse_host_data(m)
                step()
        else:
            step()
        bufs.append({k: v.clone() for k, v in vars(p).items()
                     if torch.is_tensor(v)})
    assert bufs[0].keys() == bufs[1].keys()
    assert all(torch.equal(bufs[0][k], bufs[1][k]) for k in bufs[0])
    assert bool(bufs[0]["alive"].any())


@pytest.mark.parametrize("kind", KINDS)
def test_returned_film_is_the_callers(cornell, kind):
    """A later call through the same pool leaves an earlier call's film
    and counts as they were."""
    render = _Renderer(kind)
    f1, c1 = render(cornell, 0, side=8, spp=1, n_pool=32)
    keep = f1.clone(), c1.clone()
    f2, c2 = render(cornell, 5, side=8, spp=1, n_pool=32)
    assert len(render.pools()) == 1
    assert not torch.equal(f1, f2)
    assert torch.equal(f1, keep[0]) and torch.equal(c1, keep[1])
    f2 += 1.0
    c2 += 1
    assert torch.equal(f1, keep[0]) and torch.equal(c1, keep[1])


@pytest.mark.parametrize("kind", KINDS)
def test_cache_is_bounded_and_dropped_with_its_owners(cornell, kind):
    """MAX_POOLS keys at most, the least recently used dropped first; the
    pools of a scene (and, for SPCBPT, of a subspace state) go when it
    does; the other pool's cache is left as it was."""
    render = _Renderer(kind)
    cache, sid = render.mod._POOLS, id(render.ts)
    other = [m for k, m in POOLS.items() if k != kind][0]
    theirs = list(other._POOLS.pools)
    # the width's place in the key: after the owners' ids
    side_at = 1 if kind == "pt" else 2

    def mine():
        return [k[side_at] for k in cache.pools if k[0] == sid]
    sides = list(range(2, 3 + pool.MAX_POOLS))
    for side in sides:
        render(cornell, 0, side=side, spp=1, n_pool=16, max_depth=2)
    assert len(cache.pools) <= pool.MAX_POOLS
    assert mine() == sides[-pool.MAX_POOLS:]
    # used again: now the newest; then back in, the oldest out
    for side in (sides[-pool.MAX_POOLS], sides[0]):
        render(cornell, 0, side=side, spp=1, n_pool=16, max_depth=2)
    assert mine() == sides[-pool.MAX_POOLS + 2:] + [
        sides[-pool.MAX_POOLS], sides[0]]
    assert list(other._POOLS.pools) == theirs

    if kind == "spcbpt":
        ss = classify.synthetic_trained_state(render.ts, seed=3)
        oid = id(ss)
        render(cornell, 0, side=3, spp=1, n_pool=16, max_depth=2, ss=ss)
        assert [k for k in cache.pools if k[1] == oid]
        del ss
        render.samplers.clear()
        gc.collect()
        assert not [k for k in cache.pools if k[1] == oid]
        assert (1, oid) not in cache.owners
        assert mine()
    del render
    gc.collect()
    assert not mine()
    assert (0, sid) not in cache.owners


# the shared flush and regeneration, on hand-built lanes: N_PIXELS pixels,
# the pool's lanes on the pixels and liveness given
N_PIXELS = 4


def _lanes(pixel, alive, next_sample):
    p = pool.Pool(len(pixel), N_PIXELS, "cpu")
    p.pixel.copy_(torch.tensor(pixel))
    p.alive.copy_(torch.tensor(alive))
    p.next_sample.fill_(next_sample)
    return p


def _regenerate(p, terminated, total, result=None):
    """pool.regenerate over p; returns what refill was given."""
    got = {}

    def refill(take, pixel, rep):
        got.update(take=take.clone(), pixel=pixel.clone(), rep=rep.clone())
    terminated = torch.tensor(terminated)
    if result is None:
        result = torch.ones((len(terminated), 3))
    pool.regenerate(p, terminated, result, N_PIXELS, total, refill)
    return got


def test_regeneration_takes_samples_in_rank_order():
    """The dead and the terminated lanes take the next samples, in lane
    order, from next_sample; the others keep theirs."""
    p = _lanes([0, 1, 2, 3, 0], [True, False, True, True, False], 10)
    got = _regenerate(p, [False, False, True, False, False], total=100)
    assert got["take"].tolist() == [False, True, True, False, True]
    taken = got["take"]
    assert (got["pixel"][taken].tolist(), got["rep"][taken].tolist()) == (
        [10 % N_PIXELS, 11 % N_PIXELS, 12 % N_PIXELS],
        [10 // N_PIXELS, 11 // N_PIXELS, 12 // N_PIXELS])
    assert p.pixel.tolist() == [0, 2, 3, 3, 0]
    assert p.alive.tolist() == [True] * 5
    assert int(p.next_sample) == 13


def test_no_sample_is_taken_at_or_past_total():
    """With two samples left, the third lane that wants one stays dead on
    its old pixel, and the counter stops at total."""
    p = _lanes([0, 1, 2, 3], [True, True, True, False], 10)
    got = _regenerate(p, [True, False, True, False], total=12)
    assert got["take"].tolist() == [True, False, True, False]
    assert p.alive.tolist() == [True, True, True, False]
    assert p.pixel.tolist() == [10 % N_PIXELS, 1, 11 % N_PIXELS, 3]
    assert int(p.next_sample) == 12


def test_only_terminated_lanes_flush():
    """Film and counts gain the terminated lanes' results at their pixels;
    a live lane's running result and a dead lane's are not flushed."""
    p = _lanes([1, 1, 2, 3], [True, True, True, False], 4)
    result = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1.0
    _regenerate(p, [True, False, True, False], total=4, result=result)
    want = torch.zeros((N_PIXELS, 3))
    want[1], want[2] = result[0], result[2]
    assert torch.equal(p.film, want)
    assert p.count.tolist() == [0, 1, 1, 0]


@pytest.mark.parametrize("alive, terminated, next_sample, flag", [
    ([True, True], [True, False], 8, True),      # a lane still alive
    ([True, True], [True, True], 8, False),      # none alive, none left
    ([True, False], [True, False], 6, True),     # samples left: taken
])
def test_flag_falls_only_when_no_lane_alive_and_no_sample_left(
        alive, terminated, next_sample, flag):
    p = _lanes([0, 1], alive, next_sample)
    _regenerate(p, terminated, total=8)
    assert bool(p.flag) is flag


def test_rep_follows_the_pixel_count_when_the_pool_is_larger():
    """A pool of more lanes than pixels: at a frame's start lane l is on
    pixel l % n_pixels, sample rep l // n_pixels; a regenerated lane on
    sample sid gets rep sid // n_pixels."""
    p = pool.Pool(10, N_PIXELS, "cpu")
    got = {}

    def fresh(pixel, rep):
        got.update(pixel=pixel.tolist(), rep=rep.tolist())
    pool.start(p, (np.zeros(3), np.eye(3)[0], np.eye(3)[1], np.eye(3)[2]),
               0, 2, 2, 3 * N_PIXELS, fresh)
    lane = list(range(10))
    assert got == {"pixel": [i % N_PIXELS for i in lane],
                   "rep": [i // N_PIXELS for i in lane]}
    assert p.pixel.tolist() == got["pixel"] and int(p.next_sample) == 10
    assert bool(p.flag) and not bool(p.film.any())
    term = [False] * 10
    term[3] = term[7] = True
    regen = _regenerate(p, term, total=3 * N_PIXELS)
    assert regen["rep"][regen["take"]].tolist() == [10 // N_PIXELS,
                                                    11 // N_PIXELS]
    assert p.pixel[[3, 7]].tolist() == [10 % N_PIXELS, 11 % N_PIXELS]

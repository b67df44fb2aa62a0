"""The PT pool's loop body over its cached buffers (render/pt_pool.py), on
the CPU: the route choice (a CUDA graph only on CUDA scenes in `brute`
mode), two frames through one cache entry against the JAX pool and a fresh
call, the graph route's bookkeeping with a stand-in for the capture (the
card's capture and replay are checked by chip_smoke.py), the launch-count
helper, the cache's bound and its release with the scene, and films that
stay the caller's own."""
import gc
import inspect

import numpy as np
import pytest
import torch

from spcbpt_tpu.render import pt_pool as jpool
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch import kernels
from spcbpt_tpu_torch.kernels import brute_trace
from spcbpt_tpu_torch.render import pt_pool
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.utils import profiling

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

SIDE = 16
SPP = 2
# two frames: (subframe0, how far the eye moves along the camera's U)
FRAMES = ((3, 0.0), (7, 0.15))


@pytest.fixture(scope="module")
def cornell():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    return jts, cam.uvw()


def _moved(uvw, step: float):
    eye, U, V, W = (np.asarray(x, np.float64) for x in uvw)
    return (eye + step * U / np.linalg.norm(U), U, V, W)


def _pixels_within(a, b, rtol):
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return float((np.where(a == b, 0.0, err) <= rtol).all(axis=-1).mean())


class _Replay:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    captured loop body, which reads and writes the pool's buffers."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


# what the stand-in's capture records: one K3 closest and one any launch,
# as a brute-mode PT iteration issues
RECORDED = {"brute_closest": 1, "brute_any": 1}


def _stand_in_capture(step, dev):
    """The route's capture on the CPU: the eager warm-up pass, then a
    'capture' whose bindings count RECORDED launches that do not run."""
    step()
    with kernels.capture_launches() as launches:
        for name, n in RECORDED.items():
            brute_trace.LAUNCHES[name] += n
    return _Replay(step), launches


@pytest.fixture
def graphed(monkeypatch):
    """The graph route taken on the CPU, with the stand-in capture."""
    monkeypatch.setattr(pt_pool, "graph_route", lambda device, mode: True)
    monkeypatch.setattr(pt_pool, "_capture", _stand_in_capture)
    yield
    # a stand-in holds its loop body, and so its scene: drop its pools
    for key in [k for k, p in pt_pool._POOLS.items()
                if isinstance(p.graph, _Replay)]:
        del pt_pool._POOLS[key]


@pytest.mark.parametrize("device, mode, graph", [
    ("cuda", "brute", True), ("cuda:1", "brute", True),
    ("cpu", "brute", False), ("cuda", "tile", False),
    ("cuda", "bvh", False), ("cuda", "walk", False), ("cpu", "tile", False),
])
def test_graph_route_only_on_cuda_brute(device, mode, graph):
    assert pt_pool.graph_route(torch.device(device), mode) is graph


def test_no_argument_chooses_the_route():
    assert list(inspect.signature(pt_pool.render_pool).parameters) == [
        "ts", "cam_uvw", "width", "height", "spp", "subframe0", "n_pool",
        "max_depth"]


def test_cpu_renders_take_the_eager_body(cornell):
    """A CPU brute-mode render captures nothing and counts no graph."""
    ts = from_jax_scene(cornell[0], "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pt_pool.render_pool(ts, cornell[1], 8, 8, 1, 0, n_pool=32,
                            max_depth=4)
    got = profiling.collect()
    assert list(got["counters"]) == ["pt_pool.iterations"]
    (pool,) = [p for k, p in pt_pool._POOLS.items() if k[0] == id(ts)]
    assert pool.graph is None and pool.launches == {}


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_two_frames_through_one_cache_entry(cornell, route, request):
    """Frame 2 (a new subframe0, the eye moved) rendered through the pool
    frame 1 made: the JAX pool's parity bounds (tests/test_torch_pt.py),
    and equal to a fresh call on a scene of its own."""
    if route == "graph":
        request.getfixturevalue("graphed")
    jts, uvw = cornell
    ts = from_jax_scene(jts, "cpu")
    outs = []
    for sub, step in FRAMES:
        outs.append(pt_pool.render_pool(ts, _moved(uvw, step), SIDE, SIDE,
                                        SPP, sub))
    assert sum(k[0] == id(ts) for k in pt_pool._POOLS) == 1
    sub, step = FRAMES[1]
    tf, tc = outs[1]
    fresh = pt_pool.render_pool(from_jax_scene(jts, "cpu"),
                                _moved(uvw, step), SIDE, SIDE, SPP, sub)
    assert torch.equal(tf, fresh[0]) and torch.equal(tc, fresh[1])
    assert not torch.equal(outs[0][0], tf)

    eye, U, V, W = _moved(uvw, step)
    jf, jc = jpool.render_pool_jit(jts, eye, U, V, W, SIDE, SIDE, SPP, sub)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert _pixels_within(a, b, 1e-4) >= 0.99
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())


def test_graph_route_counts_captures_replays_and_launches(cornell, graphed,
                                                          monkeypatch):
    """Frame 1 of a key: its first iteration the warm-up and capture, every
    later one a replay; frame 2: replays alone, one an iteration. The
    launch counters gain the recorded launches once a replay and none for
    the capture. Films and counts equal the eager route's."""
    jts, uvw = cornell
    ts = from_jax_scene(jts, "cpu")
    counters = []
    launches = []
    outs = []
    for sub, step in FRAMES:
        kernels.reset_launches()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            outs.append(pt_pool.render_pool(ts, _moved(uvw, step), SIDE,
                                            SIDE, SPP, sub))
        counters.append({k: sum(v.values()) for k, v in
                         profiling.collect()["counters"].items()})
        launches.append(kernels.read_launches())
    first, second = counters
    assert first["pt_pool.graph_captures"] == 1
    assert first["pt_pool.graph_replays"] == first["pt_pool.iterations"] - 1
    assert "pt_pool.graph_captures" not in second
    assert second["pt_pool.graph_replays"] == second["pt_pool.iterations"]
    for c, n in zip(counters, launches):
        for name, k in RECORDED.items():
            assert n[name] == k * c["pt_pool.graph_replays"]

    monkeypatch.setattr(pt_pool, "graph_route", lambda device, mode: False)
    eager = from_jax_scene(jts, "cpu")
    for (sub, step), (f, c) in zip(FRAMES, outs):
        ef, ec = pt_pool.render_pool(eager, _moved(uvw, step), SIDE, SIDE,
                                     SPP, sub)
        assert torch.equal(f, ef) and torch.equal(c, ec)


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


def test_returned_film_is_the_callers(cornell):
    """A later call through the same pool leaves an earlier call's film
    and counts as they were."""
    ts = from_jax_scene(cornell[0], "cpu")
    f1, c1 = pt_pool.render_pool(ts, cornell[1], 8, 8, 1, 0, n_pool=32)
    keep = f1.clone(), c1.clone()
    f2, c2 = pt_pool.render_pool(ts, cornell[1], 8, 8, 1, 5, n_pool=32)
    assert not torch.equal(f1, f2)
    assert torch.equal(f1, keep[0]) and torch.equal(c1, keep[1])
    f2 += 1.0
    c2 += 1
    assert torch.equal(f1, keep[0]) and torch.equal(c1, keep[1])


def test_cache_is_bounded_and_dropped_with_its_scene(cornell):
    """MAX_POOLS keys at most, the least recently used dropped first; a
    scene's pools go when the scene does."""
    ts = from_jax_scene(cornell[0], "cpu")
    sid = id(ts)

    def render(side):
        pt_pool.render_pool(ts, cornell[1], side, side, 1, 0, n_pool=16,
                            max_depth=2)
    sides = list(range(2, 3 + pt_pool.MAX_POOLS))
    for side in sides:
        render(side)
    mine = [k[1] for k in pt_pool._POOLS if k[0] == sid]
    assert len(pt_pool._POOLS) <= pt_pool.MAX_POOLS
    assert mine == sides[-pt_pool.MAX_POOLS:]
    render(sides[-pt_pool.MAX_POOLS])         # used again: now the newest
    render(sides[0])                          # back in, the oldest out
    mine = [k[1] for k in pt_pool._POOLS if k[0] == sid]
    assert mine == sides[-pt_pool.MAX_POOLS + 2:] + [
        sides[-pt_pool.MAX_POOLS], sides[0]]
    del ts
    gc.collect()
    assert not [k for k in pt_pool._POOLS if k[0] == sid]
    assert sid not in pt_pool._SCENES

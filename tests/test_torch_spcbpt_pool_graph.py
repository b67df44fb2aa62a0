"""The SPCBPT eye pool's loop body over its cached buffers
(render/spcbpt_pool.py), on the CPU: the route choice (a CUDA graph only on
CUDA scenes in `brute` mode), three frames through one cache entry, each
with a sampler of its own light frame, against the eager body; the graph
route's bookkeeping with a stand-in for the capture (the card's capture and
replay are checked by chip_smoke.py); what gets a pool of its own; the
cache's bound and its release with the scene and the state; films that stay
the caller's own; BDPT and a sky-lit scene through the pooled body against
the JAX pool."""
import dataclasses
import gc
import inspect

import jax
import numpy as np
import pytest
import torch

from spcbpt_tpu.render import light_trace as jlt
from spcbpt_tpu.render import lvc as jlvc
from spcbpt_tpu.render import spcbpt_pool as jpool
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu_torch import kernels
from spcbpt_tpu_torch.kernels import brute_trace
from spcbpt_tpu_torch.render import light_trace, lvc, pt_pool, spcbpt_pool
from spcbpt_tpu_torch.render.vertex import from_jax_vertices
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify
from spcbpt_tpu_torch.utils import profiling

from jax_native import native_jax_route  # noqa: F401 (autouse)
from sky_scene import write_sky_floor

torch.set_num_threads(1)

SIDE = 12
SPP = 2
N_POOL = 160
LIGHT_PATHS = 600
LIGHT_DEPTH = 5
EYE_DEPTH = 8
# three frames: (subframe0, how far the eye moves along the camera's U);
# each traces its own light frame
FRAMES = ((3, 0.0), (7, 0.15), (11, -0.1))
# against the JAX pool, as tests/test_torch_spcbpt.py: counts exact, mean
# within 1e-4 relative, >= 98% of pixels within 1e-3
JAX_SIDE = 16
JAX_PATHS = 2048
MEAN_RTOL = 1e-4
PIXEL_RTOL = 1e-3
PIXEL_SHARE = 0.98


@pytest.fixture(scope="module")
def cornell():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    return jts, cam.uvw()


def _moved(uvw, step: float):
    eye, U, V, W = (np.asarray(x, np.float64) for x in uvw)
    return (eye + step * U / np.linalg.norm(U), U, V, W)


def _sampler(ts, ss, light_frame: int, table=True):
    """The sampler of one light frame, built as the CLI builds it (with
    table=False: without the presampled tables)."""
    lv = light_trace.trace_light_paths(ts, ss, LIGHT_PATHS, light_frame,
                                       max_depth=LIGHT_DEPTH)
    if table:
        return lvc.make_builder(ss)(lv, light_frame)
    return lvc.build_sampler(lv, ss=ss)


def _render(ts, ss, sampler, uvw, sub, **kw):
    kw = {"n_pool": N_POOL, "max_depth": EYE_DEPTH, **kw}
    return spcbpt_pool.render_pool(ts, ss, sampler, uvw, SIDE, SIDE, SPP,
                                   sub, **kw)


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


# what the stand-in's capture records: one K3 closest launch (the eye
# bounce) and one any launch (the connections' visibility), as a
# brute-mode SPCBPT iteration issues
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
    """The eye pool's graph route taken on the CPU, with the stand-in
    capture; the PT pool's route is left as it is."""
    monkeypatch.setattr(spcbpt_pool, "graph_route",
                        lambda device, mode: True)
    monkeypatch.setattr(spcbpt_pool, "_capture", _stand_in_capture)
    yield
    # a stand-in holds its loop body, and so its scene and state: drop
    # its pools
    for key in [k for k, p in spcbpt_pool._POOLS.items()
                if isinstance(p.graph, _Replay)]:
        del spcbpt_pool._POOLS[key]


def _eager(monkeypatch):
    monkeypatch.setattr(spcbpt_pool, "graph_route",
                        lambda device, mode: False)


@pytest.mark.parametrize("device, mode, graph", [
    ("cuda", "brute", True), ("cuda:1", "brute", True),
    ("cpu", "brute", False), ("cuda", "tile", False),
    ("cuda", "bvh", False), ("cuda", "walk", False), ("cpu", "walk", False),
])
def test_graph_route_only_on_cuda_brute(device, mode, graph):
    assert spcbpt_pool.graph_route(torch.device(device), mode) is graph


def test_the_route_and_capture_are_the_pt_pools():
    """One route rule and one capture for both pools, bound to names of
    their own in each (so that a test stands in for each separately)."""
    assert spcbpt_pool.graph_route is pt_pool.graph_route
    assert spcbpt_pool._capture is pt_pool._capture


def test_no_argument_chooses_the_route():
    assert list(inspect.signature(spcbpt_pool.render_pool).parameters) == [
        "ts", "ss", "sampler", "cam_uvw", "width", "height", "spp",
        "subframe0", "n_pool", "max_depth", "connection_n", "uniform",
        "second_stage"]


def test_cpu_renders_take_the_eager_body(cornell):
    """A CPU brute-mode render captures nothing and counts no graph."""
    ts = from_jax_scene(cornell[0], "cpu")
    ss = classify.synthetic_trained_state(ts, seed=0)
    sampler = _sampler(ts, ss, 5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _render(ts, ss, sampler, cornell[1], 0)
    got = profiling.collect()
    assert list(got["counters"]) == ["spcbpt_pool.iterations"]
    (pool,) = [p for k, p in spcbpt_pool._POOLS.items() if k[0] == id(ts)]
    assert pool.graph is None and pool.launches == {}


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_three_frames_each_with_its_own_sampler(cornell, route, request,
                                                monkeypatch):
    """Three frames through one cache entry, each on the sampler of its
    own light frame, with a new subframe0 and a moved eye: each film and
    its counts equal to the eager body's on a pool of its own with the
    same sampler. A body that read an earlier frame's sampler would
    depart. The pool's copy of the sampler keeps its tensors, and holds
    the last frame's values."""
    if route == "graph":
        request.getfixturevalue("graphed")
    ts = from_jax_scene(cornell[0], "cpu")
    ss = classify.synthetic_trained_state(ts, seed=0)
    samplers = [_sampler(ts, ss, 100 + k) for k in range(len(FRAMES))]
    outs, ptrs = [], []
    for (sub, step), sampler in zip(FRAMES, samplers):
        outs.append(_render(ts, ss, sampler, _moved(cornell[1], step), sub))
        (pool,) = [p for k, p in spcbpt_pool._POOLS.items()
                   if k[0] == id(ts)]
        ptrs.append([getattr(pool.sampler, f).data_ptr()
                     for f in spcbpt_pool.SAMPLER_FIELDS
                     if getattr(pool.sampler, f) is not None])
    assert ptrs[0] == ptrs[1] == ptrs[2]
    assert torch.equal(pool.sampler.packed, samplers[-1].packed)
    assert not torch.equal(samplers[0].packed, samplers[-1].packed)
    assert pool.sampler.vertices is None

    _eager(monkeypatch)
    for (sub, step), sampler, (f, c) in zip(FRAMES, samplers, outs):
        own = from_jax_scene(cornell[0], "cpu")
        ef, ec = _render(own, ss, sampler, _moved(cornell[1], step), sub)
        assert torch.equal(c, ec) and bool((c == SPP).all())
        assert torch.equal(f, ef)
        assert f.abs().sum() > 0
    assert not torch.equal(outs[0][0], outs[1][0])


def test_graph_route_counts_captures_replays_and_launches(cornell, graphed):
    """Frame 1 of a key: its first iteration the warm-up and capture, every
    later one a replay; frames 2 and 3: replays alone, one an iteration.
    The launch counters gain the recorded launches once a replay and none
    for the capture."""
    ts = from_jax_scene(cornell[0], "cpu")
    ss = classify.synthetic_trained_state(ts, seed=0)
    counters, launches = [], []
    for k, (sub, step) in enumerate(FRAMES):
        sampler = _sampler(ts, ss, 200 + k)
        kernels.reset_launches()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _render(ts, ss, sampler, _moved(cornell[1], step), sub)
        counters.append({k: sum(v.values()) for k, v in
                         profiling.collect()["counters"].items()})
        launches.append(kernels.read_launches())
    first = counters[0]
    assert first["spcbpt_pool.graph_captures"] == 1
    assert (first["spcbpt_pool.graph_replays"]
            == first["spcbpt_pool.iterations"] - 1)
    for later in counters[1:]:
        assert "spcbpt_pool.graph_captures" not in later
        assert (later["spcbpt_pool.graph_replays"]
                == later["spcbpt_pool.iterations"] > 1)
    for c, n in zip(counters, launches):
        for name, k in RECORDED.items():
            assert n[name] == k * c["spcbpt_pool.graph_replays"]
    assert not any(k.startswith("pt_pool.") for c in counters for k in c)


def _keys_of(ts):
    return [k for k in spcbpt_pool._POOLS if k[0] == id(ts)]


@pytest.mark.parametrize("change", ["state", "table_mode", "connection_n",
                                    "uniform", "depth"])
def test_what_gets_a_pool_of_its_own(cornell, change):
    """A new subspace state, a sampler without the presampled tables, another
    connection count, BDPT's uniform draw or another depth cap: a new pool,
    the first left as it was; the same inputs again: the same pool."""
    ts = from_jax_scene(cornell[0], "cpu")
    ss = classify.synthetic_trained_state(ts, seed=0)
    sampler = _sampler(ts, ss, 9)
    _render(ts, ss, sampler, cornell[1], 0)
    (first,) = _keys_of(ts)
    pool = spcbpt_pool._POOLS[first]
    ss2, sampler2, kw = ss, sampler, {}
    if change == "state":
        ss2 = classify.synthetic_trained_state(ts, seed=1)
    elif change == "table_mode":
        sampler2 = _sampler(ts, ss, 9, table=False)
        assert sampler2.table_pack is None and sampler.table_pack is not None
    elif change == "connection_n":
        kw = {"connection_n": 1}
    elif change == "uniform":
        kw = {"uniform": True}
    else:
        kw = {"max_depth": EYE_DEPTH - 2}
    _render(ts, ss2, sampler2, cornell[1], 0, **kw)
    keys = _keys_of(ts)
    assert len(keys) == 2 and keys[0] == first
    assert spcbpt_pool._POOLS[first] is pool
    _render(ts, ss, sampler, cornell[1], 1)
    assert _keys_of(ts) == [keys[1], first]
    assert spcbpt_pool._POOLS[first] is pool


def test_returned_film_is_the_callers(cornell):
    """A later call through the same pool leaves an earlier call's film
    and counts as they were."""
    ts = from_jax_scene(cornell[0], "cpu")
    ss = classify.synthetic_trained_state(ts, seed=0)
    sampler = _sampler(ts, ss, 3)
    f1, c1 = _render(ts, ss, sampler, cornell[1], 0)
    keep = f1.clone(), c1.clone()
    f2, c2 = _render(ts, ss, sampler, cornell[1], 5)
    assert not torch.equal(f1, f2)
    assert torch.equal(f1, keep[0]) and torch.equal(c1, keep[1])
    f2 += 1.0
    c2 += 1
    assert torch.equal(f1, keep[0]) and torch.equal(c1, keep[1])


def test_cache_is_bounded_and_dropped_with_its_scene_and_state(cornell):
    """MAX_POOLS keys at most, the least recently used dropped first; the
    pools of a scene, or of a subspace state, go when it does."""
    ts = from_jax_scene(cornell[0], "cpu")
    ss = classify.synthetic_trained_state(ts, seed=0)
    sampler = _sampler(ts, ss, 4)
    sid = id(ts)

    def render(side, state=ss):
        spcbpt_pool.render_pool(ts, state, sampler, cornell[1], side, side,
                                1, 0, n_pool=16, max_depth=2)
    sides = list(range(2, 3 + spcbpt_pool.MAX_POOLS))
    for side in sides:
        render(side)
    mine = [k[2] for k in spcbpt_pool._POOLS if k[0] == sid]
    assert len(spcbpt_pool._POOLS) <= spcbpt_pool.MAX_POOLS
    assert mine == sides[-spcbpt_pool.MAX_POOLS:]
    render(sides[-spcbpt_pool.MAX_POOLS])       # used again: now the newest
    render(sides[0])                            # back in, the oldest out
    mine = [k[2] for k in spcbpt_pool._POOLS if k[0] == sid]
    assert mine == sides[-spcbpt_pool.MAX_POOLS + 2:] + [
        sides[-spcbpt_pool.MAX_POOLS], sides[0]]

    other = classify.synthetic_trained_state(ts, seed=3)
    oid = id(other)
    render(3, other)
    assert [k for k in spcbpt_pool._POOLS if k[1] == oid]
    del other
    gc.collect()
    assert not [k for k in spcbpt_pool._POOLS if k[1] == oid]
    assert oid not in spcbpt_pool._STATES
    assert [k for k in spcbpt_pool._POOLS if k[0] == sid]

    del ts
    gc.collect()
    assert not [k for k in spcbpt_pool._POOLS if k[0] == sid]
    assert sid not in spcbpt_pool._SCENES


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    path = write_sky_floor(str(tmp_path_factory.mktemp("sky")),
                           direction=True)
    jts, _, cam = jload(path, mode="brute")
    assert jts.has_env
    return jts, cam.uvw()


@pytest.mark.parametrize("scene, alg", [("cornell", "bdpt"),
                                        ("sky", "bdpt"), ("sky", "spcbpt")])
def test_pooled_body_matches_jax(cornell, sky, scene, alg, graphed):
    """A frame replayed whole through a captured pool (the stand-in's), on
    the JAX light frame carried over, against the JAX pool: BDPT
    (uniform=True, the untrained state) on Cornell and on the sky-lit
    floor, and SPCBPT there with its env connections and escape weight."""
    jts, (eye, U, V, W) = cornell if scene == "cornell" else sky
    ts = from_jax_scene(jts, "cpu")
    uniform = alg == "bdpt"
    if uniform:
        jss, tss = jcls.untrained_state(), classify.untrained_state()
    else:
        jss = jcls.synthetic_trained_state(jts, seed=0)
        tss = classify.from_jax_state(jss, "cpu")
    jlv = jax.jit(lambda: jlt.trace_light_paths(
        jts, jss, JAX_PATHS, 7919, max_depth=LIGHT_DEPTH))()
    jsampler = jlvc.make_builder(None if uniform else jss)(jlv, 0)
    tsampler = lvc.make_builder(None if uniform else tss)(
        from_jax_vertices(jlv, "cpu"), 0)
    # the first frame captures; the second is replays alone
    warm = dataclasses.replace(tsampler, packed=torch.zeros_like(
        tsampler.packed))
    for s in (warm, tsampler):
        tf, tc = spcbpt_pool.render_pool(ts, tss, s, (eye, U, V, W),
                                         JAX_SIDE, JAX_SIDE, 1, 0,
                                         uniform=uniform)
    (pool,) = [p for k, p in spcbpt_pool._POOLS.items() if k[0] == id(ts)]
    assert isinstance(pool.graph, _Replay)
    jf, jc = jpool.render_pool_jit(jts, jss, jsampler, eye, U, V, W,
                                   JAX_SIDE, JAX_SIDE, 1, 0, uniform=uniform)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() == 1).all()
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert abs(a.mean() - b.mean()) <= MEAN_RTOL * abs(b.mean())
    assert _pixels_within(a, b, PIXEL_RTOL) >= PIXEL_SHARE

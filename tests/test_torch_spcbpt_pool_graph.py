"""The SPCBPT eye pool's loop body over its cached buffers
(render/spcbpt_pool.py), on the CPU, with a stand-in for the graph route's
capture (tests/graph_stand_in.py): three frames through one cache entry,
each with a sampler of its own light frame, against the eager body; what
gets a pool of its own; BDPT and a sky-lit scene through the pooled body
against the JAX pool. The loop both pools share is tested in
tests/test_torch_pool.py."""
import dataclasses

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
from spcbpt_tpu_torch.render import light_trace, lvc, pool, spcbpt_pool
from spcbpt_tpu_torch.render.vertex import from_jax_vertices
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify

from graph_stand_in import Replay, graphed  # noqa: F401 (fixture)
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


def _eager(monkeypatch):
    monkeypatch.setattr(pool, "graph_route", lambda device, mode: False)


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
        (p,) = [q for k, q in spcbpt_pool._POOLS.pools.items()
                if k[0] == id(ts)]
        ptrs.append([getattr(p.sampler, f).data_ptr()
                     for f in spcbpt_pool.SAMPLER_FIELDS
                     if getattr(p.sampler, f) is not None])
    assert ptrs[0] == ptrs[1] == ptrs[2]
    assert torch.equal(p.sampler.packed, samplers[-1].packed)
    assert not torch.equal(samplers[0].packed, samplers[-1].packed)
    assert p.sampler.vertices is None

    _eager(monkeypatch)
    for (sub, step), sampler, (f, c) in zip(FRAMES, samplers, outs):
        own = from_jax_scene(cornell[0], "cpu")
        ef, ec = _render(own, ss, sampler, _moved(cornell[1], step), sub)
        assert torch.equal(c, ec) and bool((c == SPP).all())
        assert torch.equal(f, ef)
        assert f.abs().sum() > 0
    assert not torch.equal(outs[0][0], outs[1][0])


def _keys_of(ts):
    return [k for k in spcbpt_pool._POOLS.pools if k[0] == id(ts)]


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
    p = spcbpt_pool._POOLS.pools[first]
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
    assert spcbpt_pool._POOLS.pools[first] is p
    _render(ts, ss, sampler, cornell[1], 1)
    assert _keys_of(ts) == [keys[1], first]
    assert spcbpt_pool._POOLS.pools[first] is p


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
    (p,) = [q for k, q in spcbpt_pool._POOLS.pools.items()
            if k[0] == id(ts)]
    assert isinstance(p.graph, Replay)
    jf, jc = jpool.render_pool_jit(jts, jss, jsampler, eye, U, V, W,
                                   JAX_SIDE, JAX_SIDE, 1, 0, uniform=uniform)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() == 1).all()
    a = (tf / tc[:, None]).numpy()
    b = np.asarray(jf) / np.asarray(jc)[:, None]
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert abs(a.mean() - b.mean()) <= MEAN_RTOL * abs(b.mean())
    assert _pixels_within(a, b, PIXEL_RTOL) >= PIXEL_SHARE

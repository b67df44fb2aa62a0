"""The light pass (render/light_trace.py) and its sampler build
(render/lvc.py) on the graph route, on the CPU, with the stand-in for the
capture (tests/graph_stand_in.py), on a brute-mode and a walk-mode Cornell
box: one capture at a key's first call and replays after it, the recorded
launches added at each replay, vertices and samplers equal to the eager
route's frame by frame, results that stay the caller's own, no tensor made
from host data, and the light pass's cache dropped with its owners."""
import dataclasses
import gc

import pytest
import torch

from spcbpt_tpu_torch import kernels
from spcbpt_tpu_torch.render import light_trace, lvc, pool
from spcbpt_tpu_torch.render.lvc import SAMPLER_TENSORS
from spcbpt_tpu_torch.scene import scene as scene_mod
from spcbpt_tpu_torch.scene.cornell import default_scene_path
from spcbpt_tpu_torch.train import classify
from spcbpt_tpu_torch.utils import profiling

from graph_stand_in import graphed, refuse_host_data  # noqa: F401

torch.set_num_threads(1)

LIGHT_PATHS = 600
LIGHT_DEPTH = 5
# three frames: the light pass's frame index and the tables' seed
FRAMES = ((7919, 3), (7920, 4), (8000, 11))
MODES = ("brute", "walk")


def _scene(mode):
    ts, _, _ = scene_mod.load_trace_scene(default_scene_path(), "cpu",
                                          mode=mode)
    assert ts.mode == mode
    return ts


def _frames(ts, ss, build, frames=FRAMES):
    """Each frame's (vertices, sampler, the program's counters, the
    launches), under the recorder."""
    out = []
    for frame, seed in frames:
        kernels.reset_launches()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            lv = light_trace.trace_light_paths(ts, ss, LIGHT_PATHS, frame,
                                               max_depth=LIGHT_DEPTH)
            s = build(lv, seed)
        counters = {c: sum(v.values()) for c, v in
                    profiling.collect()["counters"].items()}
        out.append((lv, s, counters, kernels.read_launches()))
    return out


def _fields(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name))}


def _equal(a, b) -> bool:
    fa, fb = _fields(a), _fields(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def _clone(x):
    return dataclasses.replace(x, **{k: v.clone()
                                     for k, v in _fields(x).items()})


@pytest.mark.parametrize("mode", MODES)
def test_light_pass_and_build_capture_once_then_replay(mode, graphed,
                                                       monkeypatch):
    """Frame 1 captures the light pass and the build, frames 2 and 3 replay
    each once; every frame's launches equal the eager route's (the warm-up
    pass's counted, the capture's not, a replay's added); vertices and
    sampler torch.equal to the eager route's; each frame's vertices its own
    (the frame index is read from its buffer, not baked into the graph);
    and no later call writes what an earlier one returned."""
    ts = _scene(mode)
    ss = classify.synthetic_trained_state(ts, seed=0)
    build = lvc.make_builder(ss)
    got = _frames(ts, ss, build)
    kept = [(_clone(lv), _clone(s)) for lv, s, _, _ in got]

    first = got[0][2]
    assert first == {"light_trace.graph_captures": 1,
                     "lvc.graph_captures": 1}, first
    for _, _, counters, _ in got[1:]:
        assert counters == {"light_trace.graph_replays": 1,
                            "lvc.graph_replays": 1}, counters

    monkeypatch.setattr(pool, "graph_route", lambda device, mode: False)
    eager = _frames(ts, ss, lvc.make_builder(ss))
    closest = "brute_closest" if mode == "brute" else "walk_closest"
    for (lv, s, _, n), (elv, es, ec, en), (klv, ks) in zip(got, eager, kept):
        assert ec == {}, ec
        assert n == en and n[closest] == LIGHT_DEPTH, (n, en)
        assert sum(n.values()) == LIGHT_DEPTH
        assert _equal(lv, elv)
        assert s.table_mode == es.table_mode == "mixture"
        assert s.has_weight_b and es.has_weight_b
        assert _equal(s, es)
        # nothing later wrote what this call returned
        assert _equal(lv, klv) and _equal(s, ks)
    for a, b in zip(got, got[1:]):
        assert not torch.equal(a[0].position, b[0].position)
        assert not torch.equal(a[1].table_idx, b[1].table_idx)
    assert bool(got[0][0].valid[1:].any())


@pytest.mark.parametrize("mode", MODES)
def test_light_pass_and_build_take_no_host_data(mode, graphed, monkeypatch):
    """A light pass and its build, captured and then replayed, make no
    tensor from host data (on the card: no copy from the host, which a
    capture cannot record and which would stall the host behind the
    graphs), and give the unguarded eager route's vertices and sampler."""
    ts = _scene(mode)
    ss = classify.synthetic_trained_state(ts, seed=0)
    build = lvc.make_builder(ss)
    with monkeypatch.context() as m:
        refuse_host_data(m)
        got = _frames(ts, ss, build, FRAMES[:2])
    with monkeypatch.context() as m:
        m.setattr(pool, "graph_route", lambda device, mode: False)
        eager = _frames(ts, ss, lvc.make_builder(ss), FRAMES[:2])
    assert [c for _, _, c, _ in got] == [
        {"light_trace.graph_captures": 1, "lvc.graph_captures": 1},
        {"light_trace.graph_replays": 1, "lvc.graph_replays": 1}]
    for (lv, s, _, _), (elv, es, _, _) in zip(got, eager):
        assert _equal(lv, elv) and _equal(s, es)


def test_sampler_tensors_are_those_a_build_makes():
    """SAMPLER_TENSORS (what the builder's graph computes) is every tensor
    field of a sampler but its input, `vertices`."""
    names = {f.name for f in dataclasses.fields(lvc.LVCSampler)}
    assert set(SAMPLER_TENSORS) == names - {"vertices", "table_mode",
                                            "has_weight_b"}


class _Inert:
    """A captured graph that holds no Python object, as a CUDA graph."""

    def replay(self):
        pass


def _inert_route(monkeypatch):
    def capture(step, dev):
        step()
        return _Inert(), {}
    monkeypatch.setattr(pool, "graph_route", lambda device, mode: True)
    monkeypatch.setattr(pool, "capture", capture)


@pytest.mark.parametrize("owner", ["scene", "state"])
def test_light_pass_is_dropped_with_its_owners(owner, monkeypatch):
    """A light pass of each key, a new key for another path count or depth
    cap; its buffers go when its scene or its subspace state does."""
    _inert_route(monkeypatch)
    ts = _scene("brute")
    ss = classify.synthetic_trained_state(ts, seed=0)
    ids = (id(ts), id(ss))

    def mine():
        return [k for k in light_trace._PASSES.pools if k[:2] == ids]
    for n, depth in ((LIGHT_PATHS, LIGHT_DEPTH), (LIGHT_PATHS, LIGHT_DEPTH),
                     (64, LIGHT_DEPTH), (64, 2)):
        light_trace.trace_light_paths(ts, ss, n, 1, max_depth=depth)
    assert [k[2:4] for k in mine()] == [(LIGHT_PATHS, LIGHT_DEPTH),
                                        (64, LIGHT_DEPTH), (64, 2)]
    if owner == "scene":
        del ts
    else:
        del ss
    gc.collect()
    assert not mine()


def test_builder_recaptures_for_new_shapes(monkeypatch):
    """A builder keeps one graph, fixed to the shapes of its light
    vertices: the same shapes replay it, other shapes capture anew."""
    _inert_route(monkeypatch)
    ts = _scene("brute")
    ss = classify.synthetic_trained_state(ts, seed=0)
    build = lvc.make_builder(ss)
    graphs = []
    for n in (LIGHT_PATHS, LIGHT_PATHS, 64):
        lv = light_trace.trace_light_paths(ts, ss, n, 1, max_depth=2)
        build(lv, 0)
        graphs.append(build.graphed)
    assert graphs[0] is graphs[1] and graphs[2] is not graphs[0]
    assert graphs[2].lv.valid.shape == (3, 64)

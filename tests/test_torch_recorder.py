"""The port's recorder of spans and counters (utils/profiling) at its sites
in the PT and SPCBPT pools and the light pass, on a small Cornell frame on
the CPU: nothing recorded while torch.profiler is off; under it, spans
nested under the right parents and frames, counters equal to independent
counts and repeated exactly, on the profiler's clock; and the program's
spans in device_trace's Chrome trace, the recorder emptied around its
block."""
import json
import os

import pytest
import torch

from spcbpt_tpu_torch.render import light_trace, lvc, pt_pool, spcbpt_pool
from spcbpt_tpu_torch.scene import scene as scene_mod
from spcbpt_tpu_torch.scene.cornell import default_scene_path
from spcbpt_tpu_torch.train import classify
from spcbpt_tpu_torch.utils import profiling

torch.set_num_threads(1)

SIDE = 12
N_POOL = 48
PT_DEPTH = 6
LIGHT_PATHS = 128
LIGHT_DEPTH = 4
EYE_DEPTH = 4
SUBFRAME = 3
EMPTY = {"spans": [], "counters": {}, "frames": 0, "dropped": 0}


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.collect()
    yield
    profiling.collect()


@pytest.fixture(scope="module")
def cornell():
    ts, _, cam = scene_mod.load_trace_scene(default_scene_path(), "cpu")
    cam.aspect = 1.0
    return ts, cam.uvw(), classify.synthetic_trained_state(ts, seed=0)


def _pt(cornell):
    ts, uvw, _ = cornell
    return pt_pool.render_pool(ts, uvw, SIDE, SIDE, 1, SUBFRAME,
                               n_pool=N_POOL, max_depth=PT_DEPTH)


def _spcbpt(cornell):
    """A progressive SPCBPT frame as the CLI runs it: the light pass, its
    sampler, the eye pool. Returns (film, counts)."""
    ts, uvw, ss = cornell
    lv = light_trace.trace_light_paths(ts, ss, LIGHT_PATHS, SUBFRAME + 7919,
                                       max_depth=LIGHT_DEPTH)
    sampler = lvc.make_builder(ss)(lv, SUBFRAME)
    return spcbpt_pool.render_pool(ts, ss, sampler, uvw, SIDE, SIDE, 1,
                                   SUBFRAME, n_pool=N_POOL,
                                   max_depth=EYE_DEPTH)


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _counting(fn, calls: list):
    """fn, counting its calls in calls[0]."""
    def call(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)
    return call


def test_off_records_nothing(cornell):
    _pt(cornell)
    _spcbpt(cornell)
    assert not profiling.is_recording()
    assert profiling.collect() == EMPTY


def test_spans_nest_and_counters_match_the_loops(cornell, monkeypatch):
    pt_calls, eye_calls = [0], [0]
    monkeypatch.setattr(pt_pool, "_path_step",
                        _counting(pt_pool._path_step, pt_calls))
    monkeypatch.setattr(spcbpt_pool, "_eye_bounce",
                        _counting(spcbpt_pool._eye_bounce, eye_calls))
    with _profiled():
        _pt(cornell)
        _spcbpt(cornell)
    got = profiling.collect()
    spans, c = got["spans"], got["counters"]
    assert got["frames"] == 2 and got["dropped"] == 0
    tops = [(s.name, s.frame) for s in spans if s.parent == -1]
    # the SPCBPT frame's light pass and sampler build precede its eye pool
    assert tops == [("pt_pool.render", 0), ("light_trace.paths", 1),
                    ("lvc.build", 1), ("spcbpt_pool.render", 1)]
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert p.frame == s.frame
            pool = s.name.split(".")[0]
            assert s.name in (f"{pool}.iteration", f"{pool}.sync")
            assert p.name == f"{pool}.render"
    assert set(c) == {"pt_pool.iterations", "spcbpt_pool.iterations"}
    for pool, frame, calls in (("pt_pool", 0, pt_calls),
                               ("spcbpt_pool", 1, eye_calls)):
        n = calls[0]
        assert n > 1
        assert c[f"{pool}.iterations"] == {frame: n}
        assert sum(s.name == f"{pool}.iteration" for s in spans) == n
        # one more read of the loop condition than passes of its body
        assert sum(s.name == f"{pool}.sync" for s in spans) == n + 1


def test_counters_repeat_exactly(cornell):
    def frames():
        with _profiled():
            _pt(cornell)
            _spcbpt(cornell)
        return profiling.collect()["counters"]
    first = frames()
    assert first == frames()
    assert first["pt_pool.iterations"][0] > 0


def test_the_profiler_turns_the_recorder_on(cornell):
    """The recorder reads torch's own flag of a running profiler
    (`torch.autograd.profiler._is_profiler_enabled`, private): this fails
    if a torch release renames it or stops setting it."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert not profiling.is_recording()
    with _profiled():
        assert profiling.is_recording()
        _pt(cornell)
    assert not profiling.is_recording()
    got = profiling.collect()
    assert got["frames"] == 1
    assert {s.name for s in got["spans"]} == {
        "pt_pool.render", "pt_pool.iteration", "pt_pool.sync"}


def test_span_contains_a_record_function_on_the_profilers_clock():
    with _profiled() as prof:
        with profiling.span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones(256, 256) @ torch.ones(256, 256)
    (outer,) = profiling.collect()["spans"]
    (inner,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "inner"]
    start = inner.start_ns()
    assert outer.start_ns <= start
    assert start + inner.duration_ns() <= outer.end_ns


def test_device_trace_holds_the_programs_spans(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir, "cpu"):
        with profiling.span("program.block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    (block,) = [e for e in events if e.get("cat") == "program"]
    assert block["name"] == "program.block" and block["ph"] == "X"
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name") in ("aten::mm", "aten::matmul")]
    assert ops
    for e in ops:
        assert block["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= block["ts"] + block["dur"] + 1e-3


def test_device_trace_collects_around_its_block(tmp_path):
    """A span recorded before the block (by another profiler, uncollected)
    is not written into the trace, and the recorder is empty after it."""
    with _profiled():
        with profiling.span("before"):
            pass
    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir, "cpu"):
        with profiling.span("inside"):
            pass
    assert profiling.collect() == EMPTY
    with open(os.path.join(logdir, "trace.json")) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "program"]
    assert names == ["inside"]


def test_phase_timer_records_its_span():
    timer = profiling.PhaseTimer()
    with timer.phase("untimed"):
        pass
    with _profiled():
        with timer.phase("light_trace") as h:
            h["fence"] = torch.ones(4)
            with profiling.span("inner"):
                pass
    spans = profiling.collect()["spans"]
    assert [(s.name, s.parent) for s in spans] == [("light_trace", -1),
                                                   ("inner", 0)]
    assert timer.counts == {"untimed": 1, "light_trace": 1}


def test_spans_beyond_the_cap_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    with _profiled():
        for _ in range(3):
            with profiling.span("render", ends_frame=True):
                profiling.count("n", 1)
    got = profiling.collect()
    # the third frame's span and its counter entry are not kept
    assert [s.frame for s in got["spans"]] == [0, 1]
    assert got["dropped"] == 2 and got["frames"] == 3
    assert got["counters"] == {"n": {0: 1, 1: 1}}

"""The per-layer metrics that read the program's own spans and counters
(`perfbench/harness/program.py`): the readers on a synthetic recording,
none in an untraced run or from a program without a recorder, an error
from a traced run the program did not record, a tiny cell's traced run on
the CPU, no recording in an untraced run, and on the card every traversal
launch inside a pool iteration's span on the profiler's clock."""
import pytest
import torch

from conftest import ROOT
from perfbench.harness import cell, inputs, manifest, program
from spcbpt_tpu_torch.utils import profiling
from spcbpt_tpu_torch.utils.profiling import Span

READERS = ("pool_iterations_per_spp", "pool_issue_ms_per_spp",
           "pool_sync_ms_per_spp")
MS = 1_000_000                          # ns
TRACED = {"profile": {"frames": cell.TRACE_FRAMES}}


def _quiet(*args, **kwargs):
    pass


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.collect()
    yield
    profiling.collect()


def _frame(frame: int, t0: int, pool: str, iterations: int) -> list:
    """A pool render of `iterations` passes, each 3 ms issuing and 1 ms in
    its sync, the last sync 1 ms; in frame `frame` from t0 (ns)."""
    spans = [Span(f"{pool}.render", t0, t0 + (4 * iterations + 1) * MS, -1,
                  frame)]
    t = t0
    for _ in range(iterations):
        spans.append(Span(f"{pool}.sync", t, t + MS, 0, frame))
        spans.append(Span(f"{pool}.iteration", t + MS, t + 4 * MS, 0, frame))
        t += 4 * MS
    spans.append(Span(f"{pool}.sync", t, t + MS, 0, frame))
    return spans


def _recording():
    """Three frames of 10, 20 and 40 iterations: the stretch's two, then
    the gap frame, which the readers leave out."""
    spans = (_frame(0, 0, "pt_pool", 10) + _frame(1, 10**9, "pt_pool", 20)
             + _frame(2, 2 * 10**9, "pt_pool", 40))
    return {"spans": spans,
            "counters": {"pt_pool.iterations": {0: 10, 1: 20, 2: 40},
                         "other": {0: 5, 1: 5, 2: 5}},
            "frames": 3, "dropped": 0}


def _read(name, rec=TRACED):
    return manifest.reader(name, ROOT).read(rec)


def test_readers_on_a_synthetic_recording(monkeypatch):
    monkeypatch.setattr(profiling, "collect", lambda clear=True: _recording())
    assert _read("pool_iterations_per_spp") == 15.0
    # (10 + 20) passes of 3 ms over 2 frames; (11 + 21) syncs of 1 ms
    assert _read("pool_issue_ms_per_spp") == pytest.approx(45.0)
    assert _read("pool_sync_ms_per_spp") == pytest.approx(16.0)
    p = program.stretch(TRACED)
    assert p["frames"] == 2
    assert p["counters"]["other"] == 10
    assert {s.frame for s in p["spans"]} == {0, 1}


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_recording(monkeypatch, name):
    """An untraced run, and a program without the recorder (a checkout
    from before it): no value, no error."""
    monkeypatch.setattr(profiling, "collect", lambda clear=True: _recording())
    assert _read(name, {"profile": None}) is None
    monkeypatch.delattr(profiling, "collect")
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_fail_on_a_traced_run_that_recorded_nothing(name):
    """A traced run whose program has the recorder but recorded no pool
    render (its profiler flag gone, say) fails, and gives no value."""
    with pytest.raises(RuntimeError, match="no pool render"):
        _read(name)


def test_readers_are_listed_with_their_entries(manifest_copy):
    by_name = {m["name"]: m for m in manifest_copy["per_layer"]}
    for name in READERS:
        m, mod = by_name[name], manifest.reader(name, ROOT)
        assert (m["layer"], m["source"], m["unit"], m["moves"]) == (
            mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES)
        assert m["workloads"] == ["cornell_pt_1920", "cornell_spcbpt_1920"]


@pytest.mark.parametrize("name", ["tiny_cornell_pt", "tiny_cornell_spcbpt"])
def test_tiny_traced_run_reads_the_program(tiny_root, name):
    """The traced stretch's frames are recorded (spans and host counters
    only, under the profiler), and the readers find them; the untraced
    run of the same cell records nothing."""
    out = cell.run(name, 2**31 + 777, 0.2, False, root=tiny_root,
                   device="cpu", log=_quiet)
    assert out["correct"]
    assert profiling.collect() == {"spans": [], "counters": {}, "frames": 0,
                                   "dropped": 0}
    out = cell.run(name, 2**31 + 777, 0.2, True, root=tiny_root,
                   device="cpu", log=_quiet)
    m = out["metrics"]
    assert set(READERS) <= set(m)
    assert m["pool_iterations_per_spp"]["value"] >= 1
    assert m["pool_issue_ms_per_spp"]["value"] > 0
    assert m["pool_sync_ms_per_spp"]["value"] > 0
    got = profiling.collect()
    # two stretch frames and the gap frame, counted by their pool's loop
    assert got["frames"] == cell.TRACE_FRAMES + 1
    pool = "pt_pool" if name.endswith("_pt") else "spcbpt_pool"
    assert list(got["counters"]) == [f"{pool}.iterations"]
    assert len(got["counters"][f"{pool}.iterations"]) == got["frames"]


@pytest.mark.card
def test_traversal_launches_lie_inside_pool_iteration_spans(card):
    """On the card, one PT frame traced on the device alone (as the
    benchmark's stretch is): every launch of a traversal kernel (K3 on
    the Cornell box) lies inside a `pt_pool.iteration` span of the
    program, on the profiler's clock."""
    from spcbpt_tpu_torch.kernels import build
    from spcbpt_tpu_torch.render import pt_pool
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    cfg = manifest.config(manifest.load(ROOT), "cornell", ROOT)
    ts, _, cam = load_trace_scene(inputs.scene_path(cfg, ROOT), card)
    build.load("brute_trace")
    cam.aspect = 1.0
    uvw = cam.uvw()
    pt_pool.render_pool(ts, uvw, 64, 64, 1, 0, n_pool=1024, max_depth=8)
    torch.cuda.synchronize(card)
    profiling.collect()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pt_pool.render_pool(ts, uvw, 256, 256, 1, 1, n_pool=1 << 14,
                            max_depth=8)
        torch.cuda.synchronize(card)
    spans = sorted((s.start_ns, s.end_ns) for s in profiling.collect()["spans"]
                   if s.name == "pt_pool.iteration")
    is_traversal = manifest.reader("traversal_kernel_ms_per_spp",
                                   ROOT).is_traversal
    events = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    kernels = {e.correlation_id() for e in events
               if e.device_type() != cpu and is_traversal(e.name())}
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events
                if e.device_type() == cpu and e.correlation_id() in kernels]
    assert kernels and spans
    assert len(launches) == len(kernels)
    outside = [(s, e) for s, e in launches
               if not any(a <= s and e <= b for a, b in spans)]
    assert not outside, (len(outside), len(launches))

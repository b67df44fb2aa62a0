"""The port's stage timers (apps/profile_pt.stage_breakdown) on the CPU: the
stages of a whole PT render are timed, their exclusive times and the rest
add up to the render, and every timed function is put back afterwards."""
import pytest
import torch

from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu_torch.apps import profile_pt
from spcbpt_tpu_torch.render import pt_pool
from spcbpt_tpu_torch.scene.scene import load_trace_scene

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)


def test_stage_breakdown_adds_up_and_restores():
    # Cornell in walk mode, so the row-walk stages run (plain versions)
    ts, _, cam = load_trace_scene(default_scene_path(), "cpu", mode="walk")
    cam.aspect = 1.0
    uvw = cam.uvw()
    before = [getattr(m, n) for m, n, _ in profile_pt.STAGES]
    out = profile_pt.stage_breakdown(
        lambda: pt_pool.render_pool(ts, uvw, 16, 16, 1, 0),
        torch.device("cpu"))
    assert [getattr(m, n) for m, n, _ in profile_pt.STAGES] == before
    st = out["stages"]
    for stage in ("row_entries", "sort key + argsort + pad",
                  "K1 plain version", "K2 plain version", "local_geometry",
                  "NEE without its shadow trace", "RR + BSDF bounce",
                  profile_pt.REST):
        assert st[stage]["calls"] > 0, stage
    assert "K1 closest kernel" not in st          # no kernel on the CPU
    # one closest-hit and one shadow trace per pool iteration
    assert st["K1 plain version"]["calls"] == st["K2 plain version"]["calls"]
    assert st["row_entries"]["calls"] == 2 * st["K1 plain version"]["calls"]
    assert all(v["ms"] >= 0 for k, v in st.items() if k != profile_pt.REST)
    assert sum(v["ms"] for v in st.values()) == pytest.approx(
        out["total_ms"], rel=1e-9)


def test_spcbpt_stage_breakdown_adds_up_and_restores():
    """The SPCBPT frame's stages (apps/profile_spcbpt) on a 16x16 Cornell
    frame with 300 light paths: every stage but the kernels runs, the
    exclusive times add up, and every timed function is put back."""
    from spcbpt_tpu_torch.apps import profile_spcbpt
    from spcbpt_tpu_torch.train import classify

    ts, _, cam = load_trace_scene(default_scene_path(), "cpu")
    cam.aspect = 1.0
    ss = classify.synthetic_trained_state(ts, seed=0)
    frame = profile_spcbpt.frame_fn(ts, ss, cam.uvw(), "spcbpt", dim=16,
                                    light_paths=300)
    stages = profile_spcbpt.STAGES
    before = [getattr(m, n) for m, n, _ in stages]
    out = profile_pt.stage_breakdown(frame, torch.device("cpu"), stages)
    assert [getattr(m, n) for m, n, _ in stages] == before
    st = out["stages"]
    for _, _, stage in stages:
        if stage.startswith("K3"):
            assert stage not in st                # no kernel on the CPU
        else:
            assert st[stage]["calls"] > 0, stage
    # one light trace per depth step, one eye trace per pool iteration
    assert st["light trace_closest wrapper"]["calls"] == profile_spcbpt.DEPTH
    assert st["eye trace_closest wrapper"]["calls"] == \
        st["eye bounce (the rest)"]["calls"]
    assert sum(v["ms"] for v in st.values()) == pytest.approx(
        out["total_ms"], rel=1e-9)


def test_tile_stage_breakdown_adds_up_and_restores():
    """The tile mode's stages (profile_pt.TILE_STAGES) on a 16x16 Cornell PT
    render on the CPU: the matmul walks run (no kernel, no round walk), one
    closest and one any trace per pool iteration, and the times add up."""
    ts, _, cam = load_trace_scene(default_scene_path(), "cpu", mode="tile")
    cam.aspect = 1.0
    uvw = cam.uvw()
    stages = profile_pt.TILE_STAGES
    before = [getattr(m, n) for m, n, _ in stages]
    out = profile_pt.stage_breakdown(
        lambda: pt_pool.render_pool(ts, uvw, 16, 16, 1, 0),
        torch.device("cpu"), stages)
    assert [getattr(m, n) for m, n, _ in stages] == before
    st = out["stages"]
    for stage in ("K4 round-walk kernel", "K5 any-hit kernel",
                  "pallas_any sort + pad + unsort"):
        assert stage not in st, stage
    closest = st["tile_closest sort + pad + unsort"]["calls"]
    assert closest > 0
    assert st["tile_any sort + pad + unsort"]["calls"] == closest
    assert st["visit-order sort + tile order"]["calls"] == 2 * closest
    assert st["tile_entries"]["calls"] == 2 * closest
    assert st["matmul closest walk"]["calls"] >= closest
    assert sum(v["ms"] for v in st.values()) == pytest.approx(
        out["total_ms"], rel=1e-9)

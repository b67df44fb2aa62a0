"""The port's stage timers (apps/profile_pt.stage_breakdown) on the CPU: the
stages of a whole PT render are timed, their exclusive times and the rest
add up to the render, and every timed function is put back afterwards."""
import pytest
import torch

from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu_torch.apps import profile_pt
from spcbpt_tpu_torch.render import pt_pool
from spcbpt_tpu_torch.scene.scene import load_trace_scene

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

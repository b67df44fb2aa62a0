"""Each traffic mix run at a tiny size on the CPU through the whole harness:
set-up, window, traced stretch, the check against the plain reference, and
one result line of the contract's shape."""
import json

import pytest

from conftest import TINY_CELLS
from perfbench import run as run_mod
from perfbench.harness import cell, manifest

CELLS = [c[0] for c in TINY_CELLS]


def _quiet(*args, **kwargs):
    pass


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_runs_and_prints_the_contract_line(tiny_root, name,
                                                     traced):
    out = cell.run(name, 2**31 + 12345, 0.2, traced, root=tiny_root,
                   device="cpu", log=_quiet)
    line = json.loads(run_mod.result_line(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert line["compared"]["mismatch_share"]["value"] == 0.0
    assert line["compared"]["count_errors"] == {"value": 0, "limit": 0}
    if "spcbpt" in name:
        assert line["compared"]["light_mismatch_share"]["value"] == 0.0
    man = manifest.load(tiny_root)
    wl = manifest.workload(man, name)
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in manifest.reported(man, wl, kind)}
    assert set(line["metrics"]) <= names
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        if "spcbpt" in name:
            assert {"light_pass_ms", "eye_pass_ms"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"ms_per_spp", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_same_seed_same_inputs(tiny_root):
    from perfbench.harness import check, inputs

    assert cell.first_subframe(7) == cell.first_subframe(7)
    a = check.pick_pixels(2**31 + 5, 256, "cpu", 64)
    b = check.pick_pixels(2**31 + 5, 256, "cpu", 64)
    assert (a == b).all() and len(set(a.tolist())) == 64
    geom = inputs.geometry(inputs.scene_path(
        manifest.config(manifest.load(tiny_root), "tiny_cornell", tiny_root),
        tiny_root))
    s1 = inputs.state_arrays(2**31 + 5, geom, "cpu")
    s2 = inputs.state_arrays(2**31 + 5, geom, "cpu")
    s3 = inputs.state_arrays(2**31 + 6, geom, "cpu")
    assert all((s1[k] == s2[k]).all() for k in ("gamma", "eye_pos", "q"))
    assert not (s1["gamma"] == s3["gamma"]).all()
    assert abs(float(s1["gamma"].sum(dim=1).mean()) - 1.0) < 1e-5


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "cornell_spcbpt_1920", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""

"""What a run loads, in a process of its own: no module of JAX or of the
JAX package (top-level names compared whole: the program's name begins
with the JAX package's), and none of the program in the plain reference.
Also the reference against the program directly, at a tiny size."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY_CELLS

RUN = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench.harness import cell
out = cell.run({name!r}, 2**31 + 3, 0.2, False, root={tiny!r},
               device="cpu", log=lambda *a, **k: None)
print(json.dumps({{"correct": out["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench.harness import check, inputs, manifest
man = manifest.load({tiny!r})
traffic = manifest.traffic("tiny_spcbpt", {tiny!r})
path = inputs.scene_path(manifest.config(man, "tiny_cornell", {tiny!r}),
                         {tiny!r})
arrays = inputs.host_copy(inputs.state_arrays(5, inputs.geometry(path),
                                              "cpu"))
pix = check.pick_pixels(5, 256, "cpu", 32)
out, lvs = check.reference_frames(traffic, path, 16, 16, [9], pix, arrays,
                                 torch.device("cpu"))
print(json.dumps({{"n": int(out[0].shape[0]),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

FORBIDDEN = {"jax", "jaxlib", "flax", "spcbpt_tpu"}


def _child(code: str) -> dict:
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tiny_root):
    out = _child(RUN.format(root=ROOT, tiny=tiny_root,
                            name=TINY_CELLS[2][0]))
    assert out["correct"] is True
    assert "spcbpt_tpu_torch" in out["top"]
    assert not FORBIDDEN & set(out["top"]), out["top"]


def test_the_reference_loads_no_program(tiny_root):
    out = _child(REFERENCE.format(root=ROOT, tiny=tiny_root))
    assert out["n"] == 32
    assert not (FORBIDDEN | {"spcbpt_tpu_torch"}) & set(out["top"]), \
        out["top"]


def test_reference_sources_import_nothing_of_the_program():
    ref = os.path.join(ROOT, "perfbench", "reference")
    for f in sorted(os.listdir(ref)):
        if f.endswith(".py"):
            with open(os.path.join(ref, f)) as fh:
                text = fh.read()
            for bad in ("spcbpt_tpu", "jax"):
                assert f"import {bad}" not in text, f
                assert f"from {bad}" not in text, f


@pytest.mark.parametrize("algorithm", ["pt", "spcbpt"])
def test_reference_equals_the_program_on_every_pixel(tiny_root, algorithm):
    """A whole tiny frame of the program (its pool) against the reference
    (one lane a pixel) on the CPU: equal to rounding on every pixel."""
    import torch

    from perfbench.harness import check, inputs, manifest
    from spcbpt_tpu_torch.render import (light_trace, lvc, pt_pool,
                                         spcbpt_pool)
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    man = manifest.load(tiny_root)
    cfg_name = "tiny_cornell"
    traffic = manifest.traffic(f"tiny_{algorithm}", tiny_root)
    path = inputs.scene_path(manifest.config(man, cfg_name, tiny_root),
                             tiny_root)
    ts, _, cam = load_trace_scene(path, "cpu")
    cam.aspect = 1.0
    uvw = cam.uvw()
    s = 41
    arrays = {}
    if algorithm == "pt":
        fs, ct = pt_pool.render_pool(ts, uvw, 16, 16, 1, s, n_pool=96,
                                     max_depth=30)
    else:
        arrays = inputs.state_arrays(11, inputs.geometry(path), "cpu")
        ss = inputs.program_state(arrays, "cpu")
        lv = light_trace.trace_light_paths(ts, ss, 512, s + 7919,
                                           max_depth=4)
        fs, ct = spcbpt_pool.render_pool(
            ts, ss, lvc.make_builder(ss)(lv, s), uvw, 16, 16, 1, s,
            n_pool=96, max_depth=4, connection_n=3)
    assert (ct == 1).all()
    pix = torch.arange(256)
    ref, ref_lvs = check.reference_frames(
        traffic, path, 16, 16, [s], pix, inputs.host_copy(arrays), "cpu")
    assert not check.departs(fs, ref[0], 1e-5, 1e-7).any()
    assert float(ref[0].abs().sum()) > 0
    if algorithm == "spcbpt":
        assert check.compare_light([lv], ref_lvs)["light_mismatched"] == 0

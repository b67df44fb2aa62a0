"""The Franka Kitchen (`perfbench/configs/franka_kitchen.json`, the files
under `perfbench/scenes/franka_kitchen/`) on the CPU at a small size: the
scene as the port loads it (walk mode, its parts), the camera wavefront's
hits and NEE occlusion, the port's PT samples against the benchmark's
plain reference, the closest-hit ties between them, the recorder's walk
spans, and the converter's files reproduced byte for byte."""
import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench.harness import check
from perfbench.reference import intersect
from perfbench.reference import render as ref_render
from perfbench.reference import scene as ref_scene
from spcbpt_tpu_torch.ops import lights
from spcbpt_tpu_torch.render import pt_pool
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene import scene as scene_mod
from spcbpt_tpu_torch.scene.cornell import default_scene_path
from spcbpt_tpu_torch.utils import profiling, vec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "perfbench", "configs", "franka_kitchen.json")
SCENES = os.path.join(ROOT, "perfbench", "scenes")
LIMITS = os.path.join(ROOT, "perfbench", "limits", "kitchen_pt_1920.json")
W, H = 64, 32
DEPTH = 3
SUBFRAMES = (5, 2_000_000_011)
# pixels of the frame compared, rays a wavefront of the tie count
PIXELS = 512
TIE_RAYS = 512


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cfg():
    return _json(CONFIG)


@pytest.fixture(scope="module")
def kitchen(cfg):
    path = os.path.join(ROOT, cfg["scene"]["file"])
    ts, _, cam = scene_mod.load_trace_scene(path, "cpu")
    cam.aspect = W / H
    return ts, cam.uvw(), path


@pytest.fixture(scope="module")
def reference(kitchen):
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        ts, _, cam = ref_scene.load_trace_scene(kitchen[2], "cpu")
    finally:
        torch.set_default_dtype(old)
    cam.aspect = W / H
    return ts, cam.uvw()


@pytest.fixture(scope="module")
def camera_hits(kitchen):
    """The camera wavefront of subframe 0 (pixel centres) and its hits."""
    ts, (eye, U, V, Wv), _ = kitchen
    o, d, state = camera_rays(eye, U, V, Wv, W, H, 0)
    o = o.contiguous()
    return o, d, state, scene_mod.trace_closest(ts, o, d, 1e-3, 1e30)


def test_scene_loads_in_walk_mode_with_its_parts(cfg, kitchen):
    ts = kitchen[0]
    assert ts.mode == "walk"
    assert ts.num_tris == cfg["triangles"]
    parts = len(ts.clusters_walk.parts)
    assert cfg["traversal"] == f"walk, {parts} parts"
    assert parts == 2
    assert ts.num_quad_lights == 4
    assert scene_mod.select_mode(ts.num_tris, "cuda") == "walk"


def test_camera_hits_and_nee_is_occluded(kitchen, camera_hits):
    """Most camera rays hit, and a fair share of NEE rays from the hits are
    blocked: the wavefronts the walk sees are not trivial."""
    ts = kitchen[0]
    o, d, state, hit = camera_hits
    hits = hit.tri >= 0
    assert hits.float().mean() >= 0.2
    g = scene_mod.local_geometry(ts, hit, o, d)
    ls, _ = lights.sample_light(ts, state)
    p = g["P"] + 1e-3 * g["Ng"] * torch.sign(
        -vec.dot(g["Ng"], d))[:, None]
    vis = scene_mod.visibility(ts, p, ls.position, mask=hits)
    occluded = (~vis & hits).sum() / hits.sum()
    assert occluded >= 0.2


def test_pt_samples_match_reference(kitchen, reference):
    """The port's PT samples (the pool, walk mode, its plain rows on the
    CPU) against the plain reference's at pixels drawn as the check draws
    them, at the check's tolerance: the share that departs is within the
    cell's limit."""
    ts, uvw, _ = kitchen
    rts, ruvw = reference
    limit = _json(LIMITS)["mismatch_share"]
    prog, ref = [], []
    for s in SUBFRAMES:
        pixels = check.pick_pixels(s, W * H, "cpu", count=PIXELS)
        fs, ct = pt_pool.render_pool(ts, uvw, W, H, 1, s, n_pool=W * H,
                                     max_depth=DEPTH)
        assert bool((ct == 1).all())
        prog.append(fs[pixels])
        ref.append(ref_render.pt_samples(rts, ruvw, W, H, pixels, s, DEPTH))
    got = check.compare(prog, ref)
    assert got["samples"] == len(SUBFRAMES) * PIXELS
    assert got["mismatch_share"] <= limit, got
    assert all(float(p.abs().sum()) > 0 for p in prog)


def _closest_and_ties(rts, o, d, tmin=1e-3):
    """The reference's brute-force closest t of each ray (back faces
    culled, as the closest trace culls them), and the rays whose closest t
    two or more triangles reach at a bit-equal t."""
    best = torch.full((o.shape[0],), 1e30)
    n_at = torch.zeros(o.shape[0], dtype=torch.int64)
    for _, p0, e1, e2 in intersect._chunks(rts.tri_p0, rts.tri_e1,
                                           rts.tri_e2, 8192):
        t, _, _, ok = intersect.tri_test(o[:, None], d[:, None], p0[None],
                                         e1[None], e2[None], True)
        t = torch.where(ok & (t > tmin) & (t < 1e30), t, 1e30)
        tj = t.amin(dim=1)
        nj = (t == tj[:, None]).sum(dim=1)
        n_at = torch.where(tj < best, nj, torch.where(tj == best,
                                                      n_at + nj, n_at))
        best = torch.minimum(best, tj)
    return best, (best < 1e30) & (n_at >= 2)


def test_closest_hit_ties_are_counted(kitchen, camera_hits):
    """Exact closest-hit ties (two triangles at bit-equal t) among rays of
    the camera wavefront and of a first (cosine) bounce from its hits,
    against the reference's brute force, whose closest t the walk's equals
    ray for ray. The counts are PERF.md's."""
    ts = kitchen[0]
    rts = ref_scene.load_trace_scene(kitchen[2], "cpu")[0]
    o, d, _, hit = camera_hits
    gen = torch.Generator().manual_seed(7)
    pick = torch.randperm(o.shape[0], generator=gen)[:TIE_RAYS]
    best0, ties0 = _closest_and_ties(rts, o[pick], d[pick])
    assert torch.equal(hit.t[pick], best0)
    keep = hit.tri >= 0
    g = scene_mod.local_geometry(ts, hit, o, d)
    n = g["Ns"][keep][:TIE_RAYS]
    r1, r2 = torch.rand((2, n.shape[0]), generator=gen)
    a = torch.where(n[:, :1].abs() < 0.9, torch.tensor([[1.0, 0, 0]]),
                    torch.tensor([[0, 1.0, 0]]))
    t1 = vec.normalize(vec.cross(a, n))
    t2 = vec.cross(n, t1)
    rad, phi = torch.sqrt(r1), 2 * torch.pi * r2
    d1 = vec.normalize(t1 * (rad * torch.cos(phi))[:, None]
                       + t2 * (rad * torch.sin(phi))[:, None]
                       + n * torch.sqrt(1 - r1)[:, None])
    o1 = g["P"][keep][:TIE_RAYS].contiguous()
    h1 = scene_mod.trace_closest(ts, o1, d1, 1e-3, 1e30)
    best1, ties1 = _closest_and_ties(rts, o1, d1)
    assert torch.equal(h1.t, best1)
    print(f"camera: {int((best0 < 1e30).sum())} hits of {TIE_RAYS} rays, "
          f"{int(ties0.sum())} ties; first bounce: "
          f"{int((best1 < 1e30).sum())} hits of {n.shape[0]}, "
          f"{int(ties1.sum())} ties")
    assert bool((best0 < 1e30).any()) and bool((best1 < 1e30).any())


def test_walk_spans_on_a_walk_scene_only(kitchen):
    """Under torch.profiler the walk's trace calls and their sort are
    spans on the kitchen, nested in the pool's iterations, and a Cornell
    frame records none."""
    ts, uvw, _ = kitchen
    cts, _, ccam = scene_mod.load_trace_scene(default_scene_path(), "cpu")
    ccam.aspect = 1.0
    profiling.collect()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pt_pool.render_pool(ts, uvw, 8, 4, 1, 3, n_pool=32, max_depth=2)
        pt_pool.render_pool(cts, ccam.uvw(), 8, 8, 1, 3, n_pool=32,
                            max_depth=2)
    got = profiling.collect()
    names = [s.name for s in got["spans"]]
    by_frame = {f: [s.name for s in got["spans"] if s.frame == f]
                for f in (0, 1)}
    for name in ("walk.closest", "walk.any", "walk.sort"):
        assert name in by_frame[0], names
        assert name not in by_frame[1]
    spans = got["spans"]
    for s in spans:
        if s.name.startswith("walk.") and s.name != "walk.sort":
            assert spans[s.parent].name == "pt_pool.iteration"
        if s.name == "walk.sort":
            assert spans[s.parent].name in ("walk.closest", "walk.any")
    n_sort = names.count("walk.sort")
    assert n_sort == names.count("walk.closest") + names.count("walk.any")


def test_converter_reproduces_the_files(tmp_path):
    """tools/mjcf_to_scene.py writes files byte-identical to the committed
    ones."""
    for mod in ("mujoco", "gymnasium_robotics"):
        if importlib.util.find_spec(mod) is None:
            pytest.skip(f"{mod} is not installed")
    out, conf = tmp_path / "franka_kitchen", tmp_path / "franka_kitchen.json"
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "mjcf_to_scene.py"),
         "--out", str(out), "--config", str(conf)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    ours = os.path.join(SCENES, "franka_kitchen")
    names = sorted(os.listdir(ours))
    assert sorted(os.listdir(out)) == names
    match, mismatch, errors = filecmp.cmpfiles(ours, out, names,
                                               shallow=False)
    assert not mismatch and not errors
    assert filecmp.cmp(CONFIG, conf, shallow=False)

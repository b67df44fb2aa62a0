"""The Franka Kitchen (`perfbench/configs/franka_kitchen.json`, the files
under `perfbench/scenes/franka_kitchen/`) on the CPU at a small size: the
scene as the port loads it (walk mode, its parts), the camera wavefront's
hits and NEE occlusion, the port's PT and SPCBPT samples and light
vertices against the benchmark's plain reference, the closest-hit ties
between them, the recorder's walk and light-pass spans and the readers
of the light pass's, and the converter's files reproduced byte for
byte."""
import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench.harness import check, inputs, manifest
from perfbench.harness.frames import LIGHT_FRAME_OFFSET
from perfbench.reference import intersect
from perfbench.reference import render as ref_render
from perfbench.reference import scene as ref_scene
from spcbpt_tpu_torch.config import CULL_BACKFACE, SCENE_EPSILON
from spcbpt_tpu_torch.ops import lights
from spcbpt_tpu_torch.render import light_trace, lvc, pt_pool, spcbpt_pool
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene import scene as scene_mod
from spcbpt_tpu_torch.scene.cornell import default_scene_path
from spcbpt_tpu_torch.utils import profiling
from spcbpt_tpu_torch.utils import rng as rng_mod
from spcbpt_tpu_torch.utils import vec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "perfbench", "configs", "franka_kitchen.json")
SCENES = os.path.join(ROOT, "perfbench", "scenes")
LIMITS = os.path.join(ROOT, "perfbench", "limits", "kitchen_pt_1920.json")
SPCBPT_LIMITS = os.path.join(ROOT, "perfbench", "limits",
                             "kitchen_spcbpt_1920.json")
W, H = 64, 32
DEPTH = 3
SUBFRAMES = (5, 2_000_000_011)
# pixels of the frame compared, rays a wavefront of the tie count
PIXELS = 512
TIE_RAYS = 512
# rays at the coplanar wall faces (about 2.5% meet a tie)
TIE_WALL_RAYS = 512
# SPCBPT against the reference: a small frame, every pixel compared, at the
# traffic's 3 connections; seeds of the benchmark's state (one large, as
# the benchmark's are)
SPCBPT_W, SPCBPT_H = 16, 8
SPCBPT_LIGHT_PATHS = 256
SPCBPT_LIGHT_DEPTH = 3
SPCBPT_EYE_DEPTH = 4
SPCBPT_CONNECTIONS = 3
SPCBPT_SEEDS = (27, 2**31 + 2700)


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
def states(kitchen):
    """The benchmark's subspace state of a seed: (the program's, the
    reference's), drawn once a seed by the harness's own functions."""
    geom = inputs.geometry(kitchen[2])
    made = {}

    def get(seed):
        if seed not in made:
            arrays = inputs.state_arrays(seed, geom, "cpu")
            made[seed] = (inputs.program_state(arrays, "cpu"),
                          ref_render.subspace_state(
                              inputs.host_copy(arrays), "cpu"))
        return made[seed]
    return get


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


def test_spcbpt_configuration_is_the_kitchen_at_upstream_settings(cfg):
    """`franka_kitchen_spcbpt` renders the kitchen's own files and numbers,
    with SPCBPT's subspaces, under the SPCBPT traffic."""
    man = manifest.load()
    wl = manifest.workload(man, "kitchen_spcbpt_1920")
    spc = manifest.config(man, wl["config"])
    assert spc["name"] == "franka_kitchen_spcbpt"
    assert {k: v for k, v in spc.items()
            if k not in ("name", "source", "subspaces", "estimator")} \
        == {k: v for k, v in cfg.items() if k not in ("name", "source")}
    assert spc["subspaces"] == inputs.NUM_SUBSPACE
    entries = {c["name"]: c for c in man["configs"]}
    assert entries[spc["name"]]["reduced"] == entries[cfg["name"]]["reduced"]
    assert manifest.traffic(wl["traffic"])["algorithm"] == "spcbpt"


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


@pytest.mark.parametrize("seed", SPCBPT_SEEDS)
def test_spcbpt_samples_and_light_vertices_match_reference(kitchen,
                                                           reference,
                                                           states, seed):
    """A progressive SPCBPT frame as the benchmark renders it (the light
    pass, its sampler, the eye pool; walk mode, its plain rows on the CPU)
    against the plain reference's own light pass, sampler and eye pass,
    from the benchmark's state of the seed: every pixel's sample and every
    light vertex at the check's tolerance, within the cell's limits."""
    ts, uvw, _ = kitchen
    rts, ruvw = reference
    w, h = SPCBPT_W, SPCBPT_H
    assert w / h == W / H              # the fixtures' cameras
    ss, rss = states(seed)
    limits = _json(SPCBPT_LIMITS)
    s = 2 + seed % (1 << 30)
    lv = light_trace.trace_light_paths(ts, ss, SPCBPT_LIGHT_PATHS,
                                       s + LIGHT_FRAME_OFFSET,
                                       max_depth=SPCBPT_LIGHT_DEPTH)
    sampler = lvc.make_builder(ss)(lv, s)
    fs, ct = spcbpt_pool.render_pool(
        ts, ss, sampler, uvw, w, h, 1, s, n_pool=w * h,
        max_depth=SPCBPT_EYE_DEPTH, connection_n=SPCBPT_CONNECTIONS)
    assert bool((ct == 1).all())
    rlv = ref_render.light_pass(rts, rss, s + LIGHT_FRAME_OFFSET,
                                SPCBPT_LIGHT_PATHS, SPCBPT_LIGHT_DEPTH)
    ref = ref_render.spcbpt_samples(rts, rss, ruvw, w, h,
                                    torch.arange(w * h), s, rlv,
                                    SPCBPT_EYE_DEPTH, SPCBPT_CONNECTIONS)
    got = check.compare([fs], [ref])
    got.update(check.compare_light([lv], [rlv]))
    assert got["samples"] == w * h
    assert got["mismatch_share"] == 0, got
    assert got["light_mismatch_share"] == 0, got
    assert got["mismatch_share"] <= limits["mismatch_share"]
    assert got["light_mismatch_share"] <= limits["light_mismatch_share"]
    # light sub-paths reach the kitchen, and some pixels gather light
    assert int(lv.valid[1:].sum()) > 0
    assert int((fs.abs().sum(dim=1) > 0).sum()) > 0


def _closest_and_ties(rts, o, d, tmin=1e-3, cull=True):
    """The reference's brute-force closest t of each ray (back faces
    culled where `cull`, as the camera's and the eye's closest traces cull
    them; the light pass culls none), the rays whose closest t two or
    more triangles reach at a bit-equal t, and the triangle the reference
    keeps there (the first in the file; -1 on a miss)."""
    best = torch.full((o.shape[0],), 1e30)
    n_at = torch.zeros(o.shape[0], dtype=torch.int64)
    tri = torch.full((o.shape[0],), -1, dtype=torch.int64)
    for base, p0, e1, e2 in intersect._chunks(rts.tri_p0, rts.tri_e1,
                                              rts.tri_e2, 8192):
        t, _, _, ok = intersect.tri_test(o[:, None], d[:, None], p0[None],
                                         e1[None], e2[None], cull)
        t = torch.where(ok & (t > tmin) & (t < 1e30), t, 1e30)
        tj = t.amin(dim=1)
        nj = (t == tj[:, None]).sum(dim=1)
        n_at = torch.where(tj < best, nj, torch.where(tj == best,
                                                      n_at + nj, n_at))
        tri = torch.where(tj < best, base + (t == tj[:, None]).int().argmax(
            dim=1), tri)
        best = torch.minimum(best, tj)
    return best, (best < 1e30) & (n_at >= 2), tri


def test_closest_hit_ties_are_counted(kitchen, camera_hits):
    """Exact closest-hit ties (two triangles at bit-equal t) among rays of
    the camera wavefront, of a first (cosine) bounce from its hits, and of
    the light pass's first wavefront (its sub-paths' start rays, drawn as
    `trace_light_paths` draws them, no face culled), against the
    reference's brute force, whose closest t the walk's equals ray for
    ray. The counts are PERF.md's."""
    ts = kitchen[0]
    rts = ref_scene.load_trace_scene(kitchen[2], "cpu")[0]
    o, d, _, hit = camera_hits
    gen = torch.Generator().manual_seed(7)
    pick = torch.randperm(o.shape[0], generator=gen)[:TIE_RAYS]
    best0, ties0, _ = _closest_and_ties(rts, o[pick], d[pick])
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
    best1, ties1, _ = _closest_and_ties(rts, o1, d1)
    assert torch.equal(h1.t, best1)
    lane = torch.arange(TIE_RAYS, dtype=torch.int64)
    lstate = rng_mod.seed((lane + 0x9E37) & 0xFFFFFFFF,
                          SUBFRAMES[0] + LIGHT_FRAME_OFFSET)
    ls, lstate = lights.sample_light(ts, lstate)
    dl, ol, _, _ = lights.trace_mode(ts, ls, lstate)
    ol = ol.contiguous()
    hl = scene_mod.trace_closest(ts, ol, dl, SCENE_EPSILON, 1e30,
                                 CULL_BACKFACE)
    bestl, tiesl, _ = _closest_and_ties(rts, ol, dl, SCENE_EPSILON,
                                     CULL_BACKFACE)
    assert torch.equal(hl.t, bestl)
    print(f"camera: {int((best0 < 1e30).sum())} hits of {TIE_RAYS} rays, "
          f"{int(ties0.sum())} ties; first bounce: "
          f"{int((best1 < 1e30).sum())} hits of {n.shape[0]}, "
          f"{int(ties1.sum())} ties; light pass: "
          f"{int((bestl < 1e30).sum())} hits of {TIE_RAYS}, "
          f"{int(tiesl.sum())} ties")
    assert bool((best0 < 1e30).any()) and bool((best1 < 1e30).any())
    assert bool((bestl < 1e30).any())


def test_walk_keeps_the_file_order_at_coplanar_ties(kitchen, reference):
    """`wall_blue` and `wall_white` share coplanar faces: rays from the
    light quads to points of those faces (no face culled, as the light
    pass traces) reach two triangles at a bit-equal t. The walk over the
    scene's parts keeps the one earlier in the file, as the reference's
    brute force does, on every ray, ties included."""
    ts = kitchen[0]
    rts = reference[0]
    names = list(ref_scene.load_scene(kitchen[2]).materials)
    walls = torch.nonzero((rts.tri_mat == names.index("wall_blue"))
                          | (rts.tri_mat == names.index("wall_white")))[:, 0]
    g = torch.Generator().manual_seed(27)
    n = TIE_WALL_RAYS
    tri = walls[torch.randint(walls.shape[0], (n,), generator=g)]
    a, b = torch.rand(n, generator=g), torch.rand(n, generator=g)
    a, b = torch.where(a + b > 1, 1 - a, a), torch.where(a + b > 1, 1 - b, b)
    to = (rts.tri_p0[tri] + a[:, None] * rts.tri_e1[tri]
          + b[:, None] * rts.tri_e2[tri])
    lq = ts.lights
    li = torch.randint(lq.corner.shape[0], (n,), generator=g)
    o = (lq.corner[li] + torch.rand(n, 1, generator=g) * lq.u[li]
         + torch.rand(n, 1, generator=g) * lq.v[li])
    d = vec.normalize(to - o)
    best, ties, ref_tri = _closest_and_ties(rts, o, d, SCENE_EPSILON, False)
    hit = scene_mod.trace_closest(ts, o, d, SCENE_EPSILON, 1e30, False)
    file = ts.clusters_walk.whole.tri_file.long()
    got = torch.where(hit.tri >= 0, file[hit.tri.clamp(min=0)], -1)
    print(f"wall rays: {int((best < 1e30).sum())} hits of {n}, "
          f"{int(ties.sum())} ties")
    assert int(ties.sum()) >= 5
    assert torch.equal(hit.t, best)
    assert torch.equal(got, ref_tri)


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


def _spcbpt_frame(ts, ss, uvw, side):
    """A tiny progressive SPCBPT frame as the benchmark runs it."""
    lv = light_trace.trace_light_paths(ts, ss, 64, 3 + LIGHT_FRAME_OFFSET,
                                       max_depth=2)
    sampler = lvc.make_builder(ss)(lv, 3)
    spcbpt_pool.render_pool(ts, ss, sampler, uvw, side[0], side[1], 1, 3,
                            n_pool=32, max_depth=2)


def _light_readers(frames):
    """The light pass's two readers over a traced stretch of `frames`
    frames, the recorder's last frame left out as the gap frame."""
    return [manifest.reader(name, ROOT).read({"profile": {"frames": frames}})
            for name in ("light_trace_ms_per_spp", "lvc_build_ms_per_spp")]


def test_light_pass_spans(kitchen, states):
    """Under torch.profiler an SPCBPT frame's light pass and sampler build
    are spans of the frame its eye pool renders, the light pass's walk
    calls nest in its span, and it adds no counter; a Cornell frame
    records the two spans and no walk span; outside the profiler nothing
    is recorded. The benchmark's two light-pass readers find the spans,
    and find none in path-traced frames."""
    ts, uvw, _ = kitchen
    ss = states(SPCBPT_SEEDS[0])[0]
    cts, _, ccam = scene_mod.load_trace_scene(default_scene_path(), "cpu")
    ccam.aspect = 1.0
    css = inputs.program_state(inputs.state_arrays(
        SPCBPT_SEEDS[0], inputs.geometry(default_scene_path()), "cpu"),
        "cpu")
    profiling.collect()
    _spcbpt_frame(ts, ss, uvw, (8, 4))
    assert profiling.collect() == {"spans": [], "counters": {}, "frames": 0,
                                   "dropped": 0}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _spcbpt_frame(ts, ss, uvw, (8, 4))
        _spcbpt_frame(cts, css, ccam.uvw(), (8, 8))
        pt_pool.render_pool(cts, ccam.uvw(), 8, 8, 1, 3, n_pool=32,
                            max_depth=2)
    readers = _light_readers(2)
    got = profiling.collect()
    spans = got["spans"]
    assert got["frames"] == 3 and got["dropped"] == 0
    tops = [(s.name, s.frame) for s in spans if s.parent == -1]
    assert tops == [("light_trace.paths", 0), ("lvc.build", 0),
                    ("spcbpt_pool.render", 0), ("light_trace.paths", 1),
                    ("lvc.build", 1), ("spcbpt_pool.render", 1),
                    ("pt_pool.render", 2)]
    light = [i for i, s in enumerate(spans) if s.name == "light_trace.paths"]
    inside = [s.name for s in spans if s.parent == light[0]]
    assert "walk.closest" in inside and set(inside) == {"walk.closest"}
    assert not [s for s in spans if s.parent == light[1]]
    for s in spans:
        if s.name == "walk.sort":
            assert spans[s.parent].name in ("walk.closest", "walk.any")
    assert not [s for s in spans if s.frame == 1
                and s.name.startswith("walk.")]
    assert set(got["counters"]) == {"spcbpt_pool.iterations",
                                    "pt_pool.iterations"}
    assert all(v is not None and v > 0 for v in readers)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            pt_pool.render_pool(cts, ccam.uvw(), 8, 8, 1, 3, n_pool=32,
                                max_depth=2)
    assert _light_readers(2) == [None, None]
    profiling.collect()


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

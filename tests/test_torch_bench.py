"""The port's traversal benchmark (apps/bench) against the measurement of
the JAX package's root bench.py on the same inputs, on the CPU: the
metric's cluster set and camera wavefront on the scale-4 interior (32,576
triangles, tile clusters of at most 16), the secondary wavefront's rays,
the 1:4 subdivision and the parts of its first level; then the app itself
at a small size, its budget gates, and its refusal to run without a card.

bench.py's measurement lives inside its child process's main, so the
steps of bench.py:303-317 and :339-345 are restated here from it."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import bsdf as jbsdf
from spcbpt_tpu.ops import bvh as jbvh
from spcbpt_tpu.ops import clusters as jclusters
from spcbpt_tpu.ops import tile_trace as jtt
from spcbpt_tpu.render.common import camera_rays as jcamera_rays
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu.utils import rng as jrng
from spcbpt_tpu_torch.apps import bench
from spcbpt_tpu_torch.ops import tile_trace as ttt
from spcbpt_tpu_torch.scene import scene as tscene

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

SIDE = 64            # camera wavefront side: 4,096 rays
JAX_TILE = 1024      # bench.py's tile
N_SECONDARY = 4096
# JAX's matmul walk against the port's (use_kernel=False) and against the
# port's round walk (use_kernel=True): triangle agreement and t where the
# triangles agree, as tests/test_torch_tile_trace.py's TRI_AGREE / T_ATOL
TRI_AGREE = {False: 0.98, True: 0.999}
T_RTOL = 1e-5
T_ATOL = {False: 1e-5, True: 0.0}
# The secondary wavefront: the same triangles on every lane, u/v within an
# ulp; the BSDF sample's transcendentals (XLA's against torch's) move
# directions by up to 1.6e-6 absolute (measured: 7 of 12,288 components,
# all below 0.08 in size, off by more than 1e-5 relative), so directions,
# unit vectors, also take an absolute 1e-5 (ATOL_MT of test_torch_tile_trace)
RAYS_RTOL = 1e-5
DIRS_ATOL = 1e-5
AREA_RTOL = 1e-5
# the app's small run: 64^2 headline, 32^2 for the rest, 1,024 bounce rays
SMALL_ARGV = ["--device", "cpu", "--dim", "64", "--scale", "1", "--rays",
              "1024"]
KEPT = ("metric", "value", "unit", "backend", "wavefront", "bench_seconds",
        "secondary_mrays_walk")
ADDED = ("device", "tile", "kernel", "skipped")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The scale-4 interior in both packages (the JAX one in its CPU mode,
    the port's in walk mode, as the app loads it), cameras square."""
    path = interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=4)
    jts, _, jcam = jscene.load_trace_scene(path)
    ts, _, cam = tscene.load_trace_scene(path, "cpu", mode="walk")
    jcam.aspect = cam.aspect = 1.0
    for a, b in ((jts.tri_p0, ts.tri_p0), (jts.tri_e1, ts.tri_e1)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jts, jcam, ts, cam


@pytest.fixture(scope="module")
def tile_sets(scenes):
    """The metric's K=16 cluster set, built as bench.py:171-175 does."""
    jts, _, ts, _ = scenes
    p0, e1, e2 = (np.asarray(a) for a in (jts.tri_p0, jts.tri_e1,
                                           jts.tri_e2))
    flat = jbvh.build_bvh(p0, e1, e2)
    o = flat.order
    jcs = jclusters.build_clusters(flat, p0[o], e1[o], e2[o], max_tris=16)
    return jcs, bench.tile_clusters(ts)


def test_tile_clusters_match_jax(tile_sets):
    jcs, cs = tile_sets
    assert cs.num_clusters == jcs.cmin.shape[0] == 2640
    assert cs.tri_k == jcs.tri_k == bench.TRI_K
    for f in ("cmin", "cmax", "tri_begin", "coeff"):
        np.testing.assert_array_equal(getattr(cs, f).numpy(),
                                      np.asarray(getattr(jcs, f)), f)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_camera_wavefront_matches_jax(scenes, tile_sets, use_kernel):
    """Frame 0 of the metric's camera wavefront through JAX's matmul walk
    at tile 1,024 (bench.py:218) and through the port's walks: the matmul
    walk at tile 1,024 and the bench's round walk at tile 256 (K4's plain
    version here)."""
    _, jcam, _, cam = scenes
    jcs, cs = tile_sets
    n = SIDE * SIDE
    eye, U, V, W = jcam.uvw()
    jo, jd, _ = jcamera_rays(eye, U, V, W, SIDE, SIDE, 0, block=32)
    ref = jtt.tile_closest(jcs, jo, jd, jnp.full((n,), 1e-3),
                           jnp.full((n,), 1e16), True, tile=JAX_TILE)
    o, d = bench.camera_wavefront(cam, SIDE, 0, 32, "cpu")
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    tmn = torch.full((n,), 1e-3)
    tmx = torch.full((n,), 1e16)
    tile = bench.TILE if use_kernel else JAX_TILE
    got = ttt.tile_closest(cs, o, d, tmn, tmx, True, tile=tile,
                           use_kernel=use_kernel)
    ref_tri, ref_t = np.asarray(ref.tri), np.asarray(ref.t)
    same = got.tri.numpy() == ref_tri
    assert same.mean() >= TRI_AGREE[use_kernel], same.mean()
    assert (ref_tri >= 0).mean() > bench.HIT_SHARE
    np.testing.assert_allclose(got.t.numpy()[same], ref_t[same],
                               rtol=T_RTOL, atol=T_ATOL[use_kernel])


def test_secondary_wavefront_matches_jax(scenes):
    """bench.py:303-317 at nb = 4,096: camera 512^2 in 16x16 blocks, its
    hits, BSDF samples from rng.seed(lane, 7), RandomState(0)'s shuffle."""
    jts, jcam, ts, cam = scenes
    nb = N_SECONDARY
    eye, U, V, W = jcam.uvw()
    o1, d1, _ = jcamera_rays(eye, U, V, W, 512, 512, 0, block=16)
    o1, d1 = o1[:nb], d1[:nb]
    hit = jscene.trace_closest(jts, o1, d1, 1e-3, 1e16, True)
    geom = jscene.local_geometry(jts, hit, o1, d1)
    st = jrng.seed(jnp.arange(nb, dtype=jnp.uint32), jnp.uint32(7))
    mat = jbsdf.gather_mat(jts.mats, geom["mat_id"], geom["base_color"])
    nd, _ = jbsdf.sample_bsdf(mat, geom["Ns"], -d1, st)
    perm = np.random.RandomState(0).permutation(nb)
    ref_o, ref_d = np.asarray(geom["P"])[perm], np.asarray(nd)[perm]
    o2, d2 = bench.secondary_wavefront(ts, cam, nb, 512)
    assert o2.shape == d2.shape == (nb, 3)
    np.testing.assert_allclose(o2.numpy(), ref_o, rtol=RAYS_RTOL)
    np.testing.assert_allclose(d2.numpy(), ref_d, rtol=RAYS_RTOL,
                               atol=DIRS_ATOL)


def _jax_subdiv(p0, e1, e2):
    """bench.py:339-345, as written there."""
    A, B, C = p0, p0 + e1, p0 + e2
    mab, mac, mbc = (A + B) / 2, (A + C) / 2, (B + C) / 2
    sp0 = np.concatenate([A, mab, mac, mbc])
    sp1 = np.concatenate([mab, B, mbc, mac])
    sp2 = np.concatenate([mac, mbc, C, mab])
    return sp0, sp1 - sp0, sp2 - sp0


def _area(e1, e2) -> float:
    return 0.5 * np.linalg.norm(np.cross(np.asarray(e1, np.float64),
                                         np.asarray(e2, np.float64)),
                                axis=1).sum()


def test_subdivide_matches_jax(scenes):
    _, _, ts, _ = scenes
    tris = bench.triangles(ts)
    got = bench.subdivide(*tris)
    for a, b in zip(got, _jax_subdiv(*tris)):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == 4 * len(tris[0]) == 130_304
    np.testing.assert_allclose(_area(*got[1:]), _area(*tris[1:]),
                               rtol=AREA_RTOL)


def test_parts_of_level_one_match_jax(scenes):
    """The level-1 interior's row-walk set: JAX's build_cluster_parts at
    bench.py:352-356 gives 2 parts, and so does the port, cluster for
    cluster (the port's cap of one K1 block's clusters does not bind)."""
    _, _, ts, _ = scenes
    sp = bench.subdivide(*bench.triangles(ts))
    parts = bench.cluster_parts(*sp, "cpu")
    flat = jbvh.build_bvh(*sp)
    o = flat.order
    jparts = jclusters.build_cluster_parts(
        flat, sp[0][o], sp[1][o], sp[2][o], max_tris=128,
        part_max_tris=bench.PART_MAX_TRIS, with_coeff=False)
    assert len(parts.parts) == len(jparts) == 2
    for p, jp in zip(parts.parts, jparts):
        assert p.num_clusters == jp.cmin.shape[0]
        np.testing.assert_array_equal(p.cmin.numpy(), np.asarray(jp.cmin))
        np.testing.assert_array_equal(p.tri_begin.numpy(),
                                      np.asarray(jp.tri_begin) + jp.tri_base)


def _lines(capsys) -> list:
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


def test_main_prints_the_bench_lines_on_the_cpu(capsys, monkeypatch):
    """The three lines at a small size; the camera wavefronts go through
    K4's walk (its plain version here) at the frozen metric's tile of 256
    rays, and mrays_tile1024 through the same at JAX's tile of 1,024."""
    tiles = []
    closest = ttt.tile_closest

    def spy(cs, o, *a, **k):
        tiles.append((o.shape[0], k["tile"], k["use_kernel"]))
        return closest(cs, o, *a, **k)
    monkeypatch.setattr(ttt, "tile_closest", spy)
    assert bench.main(SMALL_ARGV) == 0
    first, merged, final = _lines(capsys)
    assert first["wavefront"] == "32x32" and merged["wavefront"] == "64x64"
    assert merged["mrays_32"] == first["value"]
    assert final["value"] == merged["value"]
    for key in KEPT + ADDED + ("mrays_32", "pt_ms_per_spp_32", "hits"):
        assert key in final, key
    assert final["metric"] == bench.METRIC
    assert final["backend"] == final["device"] == "cpu"
    assert final["tile"] == 256 and final["tris"] == 2264
    assert final["skipped"] == []
    assert final["hits"] > bench.HIT_SHARE
    parts = sorted(k for k in final if k.startswith("mrays_parts_"))
    assert parts == ["mrays_parts_36k_p1", "mrays_parts_9k_p1"]
    numbers = [final[k] for k in parts + ["value", "mrays_32",
                                          "secondary_mrays_walk",
                                          "pt_ms_per_spp_32",
                                          "mrays_tile1024"]]
    assert all(np.isfinite(x) and x > 0 for x in numbers), numbers
    # warm frame and SMALL_ITERS at 32^2, then BIG_ITERS each at 64^2 in
    # tiles of 256 and of 1,024
    frames = lambda n, side, tile: [(side * side, tile, True)] * (n + 1)
    assert tiles[:bench.SMALL_ITERS + 2 * bench.BIG_ITERS + 3] == (
        frames(bench.SMALL_ITERS, 32, 256) + frames(bench.BIG_ITERS, 64, 256)
        + frames(bench.BIG_ITERS, 64, 1024))


def test_frozen_metric_keeps_its_tile():
    """K4 takes tiles up to 1,024 rays, JAX's bench tile; the frozen
    metric stays at the 256 it was first measured at."""
    from spcbpt_tpu_torch.kernels import tile_walk

    assert bench.TILE == 256
    assert bench.JAX_TILE == JAX_TILE == tile_walk.MAX_ROUND_LANES


def test_budget_gates_list_the_stages_they_skip(capsys):
    """With no budget left after the first wavefront every later stage is
    skipped, and each is named."""
    assert bench.main(SMALL_ARGV + ["--budget", "0"]) == 0
    first, final = _lines(capsys)
    assert final["skipped"] == ["headline", "tile1024", "secondary",
                                "parts_level1", "parts_level2", "pt"]
    assert final["value"] == first["value"]
    assert not any(k.startswith(("mrays_", "secondary", "pt_"))
                   for k in final)


def test_bench_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = bench.build_argparser().parse_args([])
    assert (args.device, args.dim, args.scale, args.rays, args.budget) == \
        ("cuda", 1024, 4, 1 << 17, 420.0)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.run(args)

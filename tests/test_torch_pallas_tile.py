"""The port's direct Moller-Trumbore tile walks (ops/pallas_tile: the round
of kernel K4 and the fused walk of kernel K5, plain versions on CPU tensors)
against the JAX package's Pallas kernels of ops/pallas_tile.py in interpret
mode, on the scale=1 interior and on Cornell, both cull settings, with dead
lanes and ray counts that are not a multiple of the tile."""
import importlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu_torch.kernels import tile_walk as kernels
from spcbpt_tpu_torch.ops import clusters as tclusters
from spcbpt_tpu_torch.ops import intersect as tint
from spcbpt_tpu_torch.ops import pallas_tile
from spcbpt_tpu_torch.ops import tile_trace as ttt
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene import scene as tscene

import tile_designs
from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

N_RAYS = 1500        # not a multiple of the 128-ray tile or 1,024 lanes
# t/u/v: XLA's CPU compiler contracts the Moller-Trumbore multiply-adds of
# the interpreted kernels into FMAs, torch rounds every product (measured up
# to 2.7e-7 relative in t, 1e-6 in u/v on the interior); held to 1e-5,
# triangle ids, slots and occlusion exactly.
RTOL, ATOL = 1e-5, 1e-5
# Against brute force (the same arithmetic): an exact tie at an edge shared
# by two clusters goes to the earlier-visited cluster in the walk and to the
# smaller id in brute force.
TRI_AGREE = 0.999


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def pallas_interpret():
    """ops.pallas_tile reloaded with pallas_call forced to interpret mode
    (as tests/test_pallas.py runs the Pallas kernels on the CPU)."""
    from jax.experimental import pallas as pl
    import spcbpt_tpu.ops.pallas_tile as P

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        importlib.reload(P)
        yield P
    finally:
        pl.pallas_call = orig
        importlib.reload(P)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Tile-mode scenes in both packages with N_RAYS rays each: camera rays
    then incoherent rays from their hits, a fifth of the lanes dead, and
    segment ends for the any hit."""
    path = interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=1)
    out = {}
    for name, p in (("interior", path), ("cornell", default_scene_path())):
        jts, _, cam = jscene.load_trace_scene(p, mode="tile")
        cam.aspect = 1.0
        ts = tscene.from_jax_scene(jts, "cpu")
        o, d, _ = camera_rays(*cam.uvw(), 32, 32, 0, block=8)
        hit = tint.brute_force_closest(o, d, ts.tri_p0, ts.tri_e1, ts.tri_e2,
                                       torch.full((1024,), 1e-3),
                                       torch.full((1024,), 1e16), False)
        rng = np.random.default_rng(7)
        p_hit = (o + torch.clamp(hit.t, max=10.0)[:, None] * d).numpy()
        nd = rng.normal(size=(1024, 3)).astype(np.float32)
        nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
        orig = np.concatenate([o.numpy(), p_hit[rng.permutation(1024)]])
        dirs = np.concatenate([d.numpy(), nd])
        orig, dirs = orig[:N_RAYS], dirs[:N_RAYS]
        tmin = np.full(N_RAYS, 1e-3, np.float32)
        tmax = np.full(N_RAYS, 1e16, np.float32)
        tmax[rng.permutation(N_RAYS)[:N_RAYS // 5]] = -1.0
        seg = np.where(tmax < 0, -1.0, rng.uniform(0.05, 3.0, N_RAYS))
        out[name] = dict(jts=jts, ts=ts, rays=(orig, dirs, tmin, tmax),
                         seg=seg.astype(np.float32))
    return out


def _round_inputs(case, r):
    """Round r of the interior's round walk, as ops/tile_trace prepares it:
    (o_t, d_t, tmin_t, tmax_t, cid, run) over the 256-ray tiles."""
    cs = case["ts"].clusters
    o, d, tmin, tmax = map(_t, case["rays"])
    args = ttt._pad_rays(o, d, tmin, tmax, 256)[:4]
    entries_s, ids_s, o_t, d_t, tmin_t, tmax_t, _, _ = ttt._prepare(
        cs, *args, 256)
    run = entries_s[:, r] < 1e30
    return o_t, d_t, tmin_t, tmax_t, ids_s[:, r].contiguous(), run


@pytest.mark.parametrize("cull", [True, False])
def test_mt_round_matches_jax(cases, pallas_interpret, cull):
    """The plain round on gathered blocks against JAX's round kernel."""
    case = cases["interior"]
    cs = case["ts"].clusters
    o_t, d_t, tmin_t, tmax_t, cid, run = _round_inputs(case, 1)
    tris = cs.tri_block[cid.long()]
    got = pallas_tile.mt_round_plain(o_t, d_t, tris, tmin_t, tmax_t, cull)
    ref = pallas_interpret.mt_round(*map(_j, (o_t, d_t, tris, tmin_t,
                                               tmax_t)), cull)
    t, u, v, dn, slot = (a.numpy() for a in got)
    np.testing.assert_array_equal(slot, np.asarray(ref[4]))
    np.testing.assert_array_equal(dn, np.asarray(ref[3]))
    np.testing.assert_allclose(t, np.asarray(ref[0]), rtol=RTOL)
    np.testing.assert_allclose(u, np.asarray(ref[1]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v, np.asarray(ref[2]), rtol=RTOL, atol=ATOL)
    hit = slot < 128
    assert 0.05 < hit.mean() < 0.95 and (t[~hit] == np.float32(1e30)).all()


def test_round_reads_blocks_in_place(cases):
    """K4's plain version: running tiles equal the round on gathered blocks,
    tiles that do not run report a miss."""
    case = cases["interior"]
    cs = case["ts"].clusters
    o_t, d_t, tmin_t, tmax_t, cid, run = _round_inputs(case, 1)
    run[1::2] = False
    got = pallas_tile.mt_round(o_t, d_t, cs.tri_block, cid, run, tmin_t,
                               tmax_t, cs.tri_k, False)
    ref = pallas_tile.mt_round_plain(o_t, d_t, cs.tri_block[cid.long()],
                                     tmin_t, tmax_t, False)
    for a, b in zip(got, ref):
        assert torch.equal(a[run], b[run])
    t, u, v, dn, slot = got
    idle = ~run
    assert (t[idle] == 1e30).all() and (slot[idle] == 128).all()
    assert (u[idle] == 0).all() and (v[idle] == 0).all()
    assert (dn == 1).all() and (slot[run] < 128).any()


@pytest.mark.parametrize("name", ["interior", "cornell"])
@pytest.mark.parametrize("cull", [True, False])
def test_pallas_closest_matches_jax(cases, pallas_interpret, name, cull):
    case = cases[name]
    args = case["rays"]
    ref = pallas_interpret.pallas_closest(case["jts"].clusters,
                                          *map(_j, args), cull)
    got = pallas_tile.pallas_closest(case["ts"].clusters, *map(_t, args),
                                     cull)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=RTOL)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   atol=ATOL)
    tri = got.tri.numpy()
    assert (tri[args[3] < 0] == -1).all()          # dead lanes never hit
    assert (tri >= 0).mean() > 0.5


@pytest.mark.parametrize("name", ["interior", "cornell"])
def test_pallas_any_matches_jax(cases, pallas_interpret, name):
    case = cases[name]
    o, d, tmin, _ = case["rays"]
    args = (o, d, tmin, case["seg"])
    ref = pallas_interpret.pallas_any(case["jts"].clusters, *map(_j, args))
    got = pallas_tile.pallas_any(case["ts"].clusters, *map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < got.numpy().mean() < 0.6
    assert not got.numpy()[case["rays"][3] < 0].any()


@pytest.mark.parametrize("sort_rays", [False, True])
def test_pallas_walks_match_brute_force(cases, sort_rays):
    """The fused walk's plain version against the port's brute force, and
    sorted against unsorted (the any hit does not depend on lane order)."""
    case = cases["interior"]
    ts = case["ts"]
    o, d, tmin, tmax = map(_t, case["rays"])
    tris = (ts.tri_p0, ts.tri_e1, ts.tri_e2)
    ref = tint.brute_force_closest(o, d, *tris, tmin, tmax, False)
    got = pallas_tile.pallas_closest(ts.clusters, o, d, tmin, tmax, False,
                                     sort_rays=sort_rays)
    assert (got.tri.numpy() == ref.tri.numpy()).mean() >= TRI_AGREE
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-5)
    seg = _t(case["seg"])
    np.testing.assert_array_equal(
        pallas_tile.pallas_any(ts.clusters, o, d, tmin, seg,
                               sort_rays=sort_rays).numpy(),
        tint.brute_force_any(o, d, *tris, tmin, seg).numpy())


@pytest.mark.parametrize("name", ["interior", "cornell"])
@pytest.mark.parametrize("sort_rays", [False, True])
def test_any_tile_design_matches_plain(cases, name, sort_rays):
    """The transcription of K5 any's walk (tests/tile_designs.py), on the
    rays as pallas_any prepares them, equals any_tiles_plain lane for lane;
    each tile's candidate list is exactly the finite part of its row of
    tile_trace.tile_entries, ids and entries; and its visits, tile by tile
    and in order, are the plain walk's (clusters.VISIT_LOG)."""
    case = cases[name]
    cs = case["ts"].clusters
    o, d, tmin, _ = map(_t, case["rays"])
    qo, qd, qtn, qtx, n, _ = pallas_tile.prepare(cs, o, d, tmin,
                                                 _t(case["seg"]), sort_rays)
    rec = {}
    got = tile_designs.any_tile_walk(cs, qo, qd, qtn, qtx, rec)
    log = []
    tclusters.VISIT_LOG = log
    try:
        ref = pallas_tile.any_tiles_plain(cs, qo, qd, qtn, qtx)
    finally:
        tclusters.VISIT_LOG = None
    assert torch.equal(got, ref)
    assert 0.05 < got.numpy()[:n].mean() < 0.6
    rows = ttt.tile_entries(cs, qo, qd, qtn, qtx, pallas_tile.TILE).numpy()
    assert len(rows) == len(rec["lists"])
    for row, (ids, e) in zip(rows, rec["lists"]):
        finite = np.nonzero(row < 1e30)[0]
        np.testing.assert_array_equal(ids, finite)
        np.testing.assert_array_equal(e, row[finite])
    visits = rec["visits"]
    expected = [[v[r] for v in visits if len(v) > r]
                for r in range(max(map(len, visits)))]
    assert all(lanes == pallas_tile.TILE for lanes, _ in log)
    assert [cid.tolist() for _, cid in log] == expected


def test_cpu_tensors_take_plain_versions(cases):
    """CPU tensors go through the plain versions: no launch is counted, and
    the scene's CPU route never reaches the fused walk."""
    case = cases["cornell"]
    cs = case["ts"].clusters
    o, d, tmin, tmax = map(_t, case["rays"])
    kernels.reset_launches()
    pallas_tile.pallas_closest(cs, o, d, tmin, tmax)
    pallas_tile.pallas_any(cs, o, d, tmin, _t(case["seg"]))
    ttt.tile_closest(cs, o, d, tmin, tmax, tile=256, use_kernel=True)
    assert kernels.LAUNCHES == {"tile_round_walk": 0, "tile_round": 0,
                                "tile_walk_closest": 0, "tile_walk_any": 0}


def test_kernel_bindings_refuse_cpu_tensors(cases):
    """No fallback: each binding raises on CPU tensors before anything is
    built or launched."""
    cs = cases["cornell"]["ts"].clusters
    o = torch.zeros((128, 3))
    t = torch.zeros((128,))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.walk_closest(o, o, t, t, cs.cmin, cs.cmax, cs.tri_begin,
                             cs.tri_block, cs.tri_k, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.walk_any(o, o, t, t, cs.cmin, cs.cmax, cs.tri_block,
                         cs.tri_count, cs.tri_k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.tile_round(o[None], o[None], t[None], t[None],
                           torch.zeros((1,), dtype=torch.int32),
                           torch.ones((1,), dtype=torch.bool), cs.tri_block,
                           cs.tri_k, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.round_walk(o[None], o[None], t[None], t[None],
                           torch.zeros((1, cs.num_clusters)),
                           torch.zeros((1, cs.num_clusters),
                                       dtype=torch.int32),
                           cs.tri_block, cs.tri_begin, cs.tri_count,
                           cs.tri_k, True)
    assert not any(kernels.LAUNCHES.values())


def test_tile_kernel_module_imports_without_nvcc():
    """Importing the tile modules builds nothing (no nvcc here)."""
    code = ("import spcbpt_tpu_torch.kernels.tile_walk as k, "
            "spcbpt_tpu_torch.kernels.build as b, "
            "spcbpt_tpu_torch.ops.pallas_tile; "
            "assert not b._LIBS and not b.BUILD_LOG; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_HOME": "/none",
                              "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

"""Multi-device rendering and training (spcbpt_tpu_torch/parallel/) on the
CPU: the mesh layout, the sequential route against JAX's shard_map on its
8-device virtual CPU mesh, gloo worlds of 2 and 4 ranks against the
sequential route, the data-parallel Gamma step, the dry run and the
multi-device benchmark app.

NCCL cannot take two ranks on one card, so worlds larger than 1 run here
with gloo only (chip_smoke.py runs the mesh at world size 1 on NCCL)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spcbpt_tpu.parallel import tile as jtile
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.train import gamma_train as jgt
from spcbpt_tpu_torch.apps import multichip_bench
from spcbpt_tpu_torch.parallel import dryrun, launch
from spcbpt_tpu_torch.parallel import tile as ttile
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.train import gamma_train as tgt

import parallel_ranks as pr
from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

# The sequential route against JAX's shard_map, with the port's frame
# tolerances (tests/test_torch_pt.py, test_torch_spcbpt.py): PT >= 99% of
# pixels within 1e-4 and the mean within 1e-4; BDPT/SPCBPT (each device
# traces its own light paths, so vertex ulps may move a pick) >= 98% of
# pixels within 1e-3, the mean within 1e-4 (measured: every pixel within
# 1e-3, means within 6e-6).
PT_RTOL, PT_SHARE = 1e-4, 0.99
SPC_RTOL, SPC_SHARE = 1e-3, 0.98
MEAN_RTOL = 1e-4
# Gloo against the sequential route: spp=1 is a pure gather (equal);
# spp>1 sums streams in gloo's order.
SUM_RTOL = 1e-6
# The data-parallel step against one process on the whole batch (sums in
# another order) and against JAX's on its mesh.
DP_LOSS_RTOL = 1e-6
DP_JAX_RTOL = 1e-5
THETA_ATOL = 1e-6
RANK_TIMEOUT_S = 300.0


def _share_within(a, b, rtol):
    err = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return float((np.where(a == b, 0.0, err) <= rtol).all(axis=-1).mean())


@pytest.mark.parametrize("n,tile,spp,want", [
    (1, None, None, (1, 1)), (2, None, None, (1, 2)), (8, None, None, (4, 2)),
    (3, None, None, (3, 1)), (8, 8, None, (8, 1)), (8, None, 4, (2, 4))])
def test_mesh_shape_defaults_like_jax(n, tile, spp, want):
    assert ttile.mesh_shape(n, tile, spp) == want
    mesh = jtile.make_mesh(jax.devices("cpu")[:n], tile=tile, spp=spp)
    assert (mesh.shape["tile"], mesh.shape["spp"]) == want


def test_mesh_shape_and_world_checks():
    with pytest.raises(ValueError, match="3x2"):
        ttile.mesh_shape(4, 3, 2)
    with pytest.raises(RuntimeError, match="initialised"):
        ttile.make_mesh()
    m = ttile.sequential_mesh(2, 3)
    assert m.shape == {"tile": 2, "spp": 3} and m.size == 6 and m.rank is None


@pytest.mark.parametrize("ti,si,sub", [(0, 0, 0), (1, 1, 3), (3, 0, 7),
                                       (2, 5, 70000)])
def test_block_camera_rays_equal_jax(ti, si, sub):
    _, _, cam = jload(default_scene_path())
    cam.aspect = 2.0
    eye, U, V, W = [np.asarray(x, np.float32) for x in cam.uvw()]
    jo, jd, js = jtile._block_camera_rays(
        jnp.asarray(eye), jnp.asarray(U), jnp.asarray(V), jnp.asarray(W),
        64, 32, 8, jnp.asarray(ti), jnp.asarray(si), sub)
    to, td, ts = ttile._block_camera_rays(eye, U, V, W, 64, 32, 8, ti, si,
                                          sub)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.fixture(scope="module")
def scenes():
    jts, _, cam = jload(default_scene_path())
    cam.aspect = pr.WIDTH / pr.HEIGHT
    jss = jcls.synthetic_trained_state(jts, seed=3)
    return jts, jss, cam.uvw(), from_jax_scene(jts, "cpu"), \
        tcls.from_jax_state(jss, "cpu")


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_sequential_route_matches_jax_shard_map(scenes, shape):
    """The same per-(ti, si) bodies run one after another against JAX's
    shard_map on its virtual CPU mesh: PT, BDPT and SPCBPT (the synthetic
    trained state), 32x8, depth 3, 256 light paths a device."""
    jts, jss, uvw, ts, tss = scenes
    t, s = shape
    jmesh = jtile.make_mesh(jax.devices("cpu")[:t * s], tile=t, spp=s)
    mesh = ttile.sequential_mesh(t, s)
    W, H, D = pr.WIDTH, pr.HEIGHT, pr.DEPTH
    j = np.asarray(jax.jit(lambda: jtile.sharded_pt_render(
        jts, uvw, W, H, 1, jmesh, max_depth=D))())
    g = ttile.sharded_pt_render(ts, uvw, W, H, 1, mesh, max_depth=D).numpy()
    assert g.shape == (W * H, 3) and np.isfinite(g).all()
    assert _share_within(g, j, PT_RTOL) >= PT_SHARE
    assert abs(g.mean() - j.mean()) <= MEAN_RTOL * abs(j.mean())
    kw = dict(light_paths_per_chip=pr.LIGHT_PATHS, light_depth=D,
              max_depth=D)
    for uniform in (True, False):
        j = np.asarray(jax.jit(lambda: jtile.sharded_spcbpt_render(
            jts, jss, uvw, W, H, 1, jmesh, uniform=uniform, **kw))())
        g = ttile.sharded_spcbpt_render(ts, tss, uvw, W, H, 1, mesh,
                                        uniform=uniform, **kw).numpy()
        assert np.isfinite(g).all() and g.mean() > 0.01
        assert _share_within(g, j, SPC_RTOL) >= SPC_SHARE, uniform
        assert abs(g.mean() - j.mean()) <= MEAN_RTOL * abs(j.mean())


def test_sub_blocks_are_exact():
    """Sequential row blocks from one sampler change no pixel."""
    one = pr.renders(ttile.sequential_mesh(2, 1))
    four = pr.renders(ttile.sequential_mesh(2, 1), sub_blocks=2)
    for alg in ("bdpt", "spcbpt"):
        np.testing.assert_array_equal(four[alg], one[alg], err_msg=alg)
    with pytest.raises(ValueError, match="sub_blocks"):
        pr.renders(ttile.sequential_mesh(2, 1), sub_blocks=3)


@pytest.fixture(scope="module")
def gloo():
    """Worlds of 2 (2x1) and 4 (2x2) gloo ranks, each rank's results, and
    the sequential route on the same meshes."""
    out = {}
    for t, s in ((2, 1), (2, 2)):
        ranks = launch.spawn(pr.mesh_rank, t * s, args=(t, s),
                             timeout_s=RANK_TIMEOUT_S)
        mesh = ttile.sequential_mesh(t, s)
        seq = pr.renders(mesh)
        seq["loss"], seq["theta"] = pr.dp_step(pr.gamma_inputs(16 * t * s),
                                               mesh)
        out[(t, s)] = (ranks, seq)
    return out


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_gloo_mesh_layout(gloo, shape):
    ranks, _ = gloo[shape]
    t, s = shape
    for r, res in enumerate(ranks):
        ti, si = divmod(r, s)
        assert tuple(res["coords"]) == (ti, si)
        assert res["shape"] == {"tile": t, "spp": s}
        assert res["row"] == [ti * s + k for k in range(s)]
        assert res["col"] == [k * s + si for k in range(t)]


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("alg", ["pt", "bdpt", "spcbpt"])
def test_gloo_renders_equal_sequential_route(gloo, shape, alg):
    """Every rank holds the whole image, equal to the sequential route's
    (spp=1: equal; spp=2: within SUM_RTOL)."""
    ranks, seq = gloo[shape]
    for res in ranks:
        assert res[alg].shape == (pr.WIDTH * pr.HEIGHT, 3)
        if shape[1] == 1:
            np.testing.assert_array_equal(res[alg], seq[alg])
        else:
            np.testing.assert_allclose(res[alg], seq[alg], rtol=SUM_RTOL,
                                       atol=0)
    assert seq[alg].mean() > 0.01


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_gloo_dp_gamma_step_equals_sequential_route(gloo, shape):
    ranks, seq = gloo[shape]
    for res in ranks:
        np.testing.assert_allclose(res["loss"], seq["loss"], rtol=SUM_RTOL)
        np.testing.assert_allclose(res["theta"], seq["theta"], rtol=0,
                                   atol=THETA_ATOL)
        np.testing.assert_array_equal(res["theta"], ranks[0]["theta"])


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2)])
def test_dp_gamma_step_matches_one_process_and_jax(shape):
    """The sharded sums divided on the totals equal one step on the whole
    batch (loss DP_LOSS_RTOL, theta after Adam THETA_ATOL), and JAX's
    dp_gamma_train_step on its mesh (DP_JAX_RTOL)."""
    t, s = shape
    arrays = pr.gamma_inputs(16 * t * s, seed=t * 10 + s)
    loss, theta = pr.dp_step(arrays, ttile.sequential_mesh(t, s))
    # one process, the whole batch, the same Adam
    batch = tgt.GammaTrainData(*[torch.from_numpy(arrays[k])
                                 for k in tgt.GammaTrainData._fields])
    th = torch.from_numpy(arrays["theta"]).clone().requires_grad_(True)
    opt = torch.optim.Adam([th], lr=pr.LR, betas=(0.9, 0.999), eps=1e-8)
    one = tgt.loss_fn(th, batch)
    one.backward()
    opt.step()
    np.testing.assert_allclose(loss, float(one.detach()), rtol=DP_LOSS_RTOL)
    np.testing.assert_allclose(theta, th.detach().numpy(), rtol=0,
                               atol=THETA_ATOL)
    # JAX on its virtual mesh
    jmesh = jtile.make_mesh(jax.devices("cpu")[:t * s], tile=t, spp=s)
    jbatch = jgt.GammaTrainData(*[jnp.asarray(arrays[k])
                                  for k in jgt.GammaTrainData._fields])
    jopt = optax.adam(pr.LR)
    jtheta = jnp.asarray(arrays["theta"])
    jth2, _, jloss = jax.jit(lambda a, o, b: jtile.dp_gamma_train_step(
        a, o, b, jopt, jmesh))(jtheta, jopt.init(jtheta), jbatch)
    np.testing.assert_allclose(loss, float(jloss), rtol=DP_JAX_RTOL)
    np.testing.assert_allclose(theta, np.asarray(jth2), rtol=0,
                               atol=THETA_ATOL)


def test_dryrun_multichip_four_ranks(tmp_path, capsys):
    out = dryrun.dryrun_multichip(4, timeout_s=RANK_TIMEOUT_S,
                                  rendezvous_dir=str(tmp_path))
    assert len(out) == 4 and out[0]["mesh"] == {"tile": 2, "spp": 2}
    assert out[0]["shape"] == (32 * 8, 3) and np.isfinite(out[0]["loss"])
    assert "dryrun_multichip OK" in capsys.readouterr().out


def _fails(rank, world):
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    import torch.distributed as dist
    dist.barrier()   # rank 0 waits here until its peer is gone


def test_spawn_stops_every_rank_on_a_failure(tmp_path):
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        launch.spawn(_fails, 2, timeout_s=60, rendezvous_dir=str(tmp_path))


def test_multichip_bench_cpu(tmp_path):
    out = tmp_path / "mc.json"
    assert multichip_bench.main([
        "--device", "cpu", "--world", "2", "--meshes", "1x1,2x1,2x2",
        "--dim", "16x8", "--light-paths-per-chip", "512", "--json",
        str(out)]) == 0
    res = json.loads(out.read_text())
    assert set(res["meshes"]) == {"1x1", "2x1"}     # 2x2 needs 4 ranks
    for shape, e in res["meshes"].items():
        assert e["pt"]["mean_vs_smallest_mesh"] < multichip_bench.PT_DEV
        for alg in ("bdpt", "spcbpt"):
            assert e[alg]["finite"] and e[alg]["mean"] > 0
            assert e[alg]["lanes_per_chip"] == 128 // int(shape[0])


def test_multichip_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        multichip_bench.main(["--meshes", "1x1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(_fails, 1, device="cuda")

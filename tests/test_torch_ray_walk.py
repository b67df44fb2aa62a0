"""The port's row walk (plain version on CPU) against the JAX Pallas row walk
run in interpret mode, on the same rays.

Rays and triangles are made with numpy from fixed seeds and given to both
packages. The CUDA kernels themselves run only on the card (chip_smoke.py
compares them with the plain version there); here the wrappers must take
the plain version for CPU tensors and never count a launch."""
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spcbpt_tpu.ops import bvh as bvh_mod
from spcbpt_tpu.ops import clusters as jcl
from spcbpt_tpu.ops import intersect as jint
from spcbpt_tpu.ops import ray_walk as jrw
from spcbpt_tpu.scene import interior
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch.kernels import ray_walk as kernels
from spcbpt_tpu_torch.ops import clusters as tcl
from spcbpt_tpu_torch.ops import intersect as tint
from spcbpt_tpu_torch.ops import ray_walk as trw
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene.scene import from_jax_scene

# the tensors here are small: one thread per xdist worker avoids
# oversubscribing the cores
torch.set_num_threads(1)

# t/u/v: XLA's CPU compiler contracts multiply-adds of the JAX
# Moller-Trumbore into FMAs, torch rounds every product. The few-ulp
# difference grows where the sums cancel (grazing rays, hits near an edge):
# measured up to 5.5e-6 relative in t on the interior camera rays. So t is
# held to 1e-5 relative and u/v (which pass through 0) to 1e-5 absolute;
# triangle ids must be equal.
RTOL, ATOL_UV = 1e-5, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def synthetic():
    """The 700-triangle set of tests/test_ray_walk.py, 300 rays."""
    rng = np.random.default_rng(11)
    nt = 700
    p0 = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (nt, 3)).astype(np.float32)
    flat = bvh_mod.build_bvh(p0, e1, e2)
    order = flat.order
    p0, e1, e2 = p0[order], e1[order], e2[order]
    jcs = jcl.build_clusters(flat, p0, e1, e2, max_tris=128, with_coeff=False)
    tcs = tcl.build_clusters(flat, p0, e1, e2, max_tris=128)
    n = 300
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmn = np.full((n,), 1e-3, np.float32)
    tmx = np.full((n,), 1e16, np.float32)
    tmx[::7] = -1.0          # dead lanes
    return dict(jcs=jcs, tcs=tcs, tris=(p0, e1, e2), o=o, d=d, tmn=tmn,
                tmx=tmx)


@pytest.fixture(scope="module")
def interior_rays(tmp_path_factory):
    """scale=1 interior (2,264 triangles, 30 clusters): 256 coherent camera
    rays and 256 incoherent bounce rays from their hits, a quarter dead."""
    root = tmp_path_factory.mktemp("interior")
    jts, desc, cam = jload(interior.generate(str(root), scale=1),
                           mode="walk")
    cam.aspect = 1.0
    ts = from_jax_scene(jts, "cpu")
    o, d, _ = camera_rays(*cam.uvw(), 16, 16, 0, block=8)
    hit = tint.brute_force_closest(o, d, ts.tri_p0, ts.tri_e1, ts.tri_e2,
                                   torch.full((256,), 1e-3),
                                   torch.full((256,), 1e16), False)
    assert (hit.tri >= 0).all()
    rng = np.random.default_rng(5)
    p = (o + hit.t[:, None] * d).numpy()
    nd = rng.normal(size=(256, 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
    perm = rng.permutation(256)
    tmx = np.full((256,), 1e16, np.float32)
    tmx[rng.permutation(256)[:64]] = -1.0
    return dict(jcs=jts.clusters_walk, tcs=ts.clusters_walk,
                tris=tuple(a.numpy() for a in (ts.tri_p0, ts.tri_e1,
                                               ts.tri_e2)),
                camera=(o.numpy(), d.numpy(), np.full((256,), 1e16,
                                                      np.float32)),
                bounce=(p[perm], nd, tmx))


def _closest_pair(case, o, d, tmn, tmx, cull, sort_rays):
    ref = jrw.walk_closest(case["jcs"], jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tmn), jnp.asarray(tmx), cull,
                           sort_rays=sort_rays, interpret=True)
    got = trw.walk_closest(case["tcs"], _t(o), _t(d), _t(tmn), _t(tmx), cull,
                           sort_rays=sort_rays)
    return ref, got


def _assert_same_hits(ref, got):
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=RTOL)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), rtol=RTOL,
                               atol=ATOL_UV)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref.v), rtol=RTOL,
                               atol=ATOL_UV)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("sort_rays", [False, True])
def test_closest_synthetic_matches_jax(synthetic, cull, sort_rays):
    s = synthetic
    ref, got = _closest_pair(s, s["o"], s["d"], s["tmn"], s["tmx"], cull,
                             sort_rays)
    _assert_same_hits(ref, got)
    assert (got.tri.numpy() >= 0).sum() > 20
    assert (got.tri.numpy()[::7] == -1).all()       # dead lanes never hit


@pytest.mark.parametrize("sort_rays", [False, True])
def test_any_synthetic_matches_jax(synthetic, sort_rays):
    s = synthetic
    tseg = np.where(s["tmx"] < 0, -1.0, 1.5).astype(np.float32)
    ref = jrw.walk_any(s["jcs"], jnp.asarray(s["o"]), jnp.asarray(s["d"]),
                       jnp.asarray(s["tmn"]), jnp.asarray(tseg),
                       sort_rays=sort_rays, interpret=True)
    got = trw.walk_any(s["tcs"], _t(s["o"]), _t(s["d"]), _t(s["tmn"]),
                       _t(tseg), sort_rays=sort_rays)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy().sum() > 10


@pytest.mark.parametrize("rays,cull,sort_rays", [
    ("camera", True, False), ("camera", False, True),
    ("bounce", False, True), ("bounce", True, False)])
def test_closest_interior_matches_jax(interior_rays, rays, cull, sort_rays):
    o, d, tmx = interior_rays[rays]
    tmn = np.full_like(tmx, 1e-3)
    ref, got = _closest_pair(interior_rays, o, d, tmn, tmx, cull, sort_rays)
    _assert_same_hits(ref, got)
    assert (got.tri.numpy() >= 0).mean() > 0.5


@pytest.mark.parametrize("sort_rays", [False, True])
def test_any_interior_matches_jax(interior_rays, sort_rays):
    o, d, tmx = interior_rays["bounce"]
    tmn = np.full_like(tmx, 1e-3)
    tseg = np.where(tmx < 0, -1.0, 2.0).astype(np.float32)
    ref = jrw.walk_any(interior_rays["jcs"], jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(tmn), jnp.asarray(tseg),
                       sort_rays=sort_rays, interpret=True)
    got = trw.walk_any(interior_rays["tcs"], _t(o), _t(d), _t(tmn), _t(tseg),
                       sort_rays=sort_rays)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_empty_rows(synthetic):
    """Rays that overlap nothing terminate with misses."""
    s = synthetic
    o_far = _t(s["o"] + 100.0)
    got = trw.walk_closest(s["tcs"], o_far, _t(s["d"]), _t(s["tmn"]),
                           _t(s["tmx"]), True)
    assert (got.tri.numpy() == -1).all()
    assert (got.t.numpy() == 1e30).all()
    assert (got.u.numpy() == 0).all() and (got.v.numpy() == 0).all()
    occ = trw.walk_any(s["tcs"], o_far, _t(s["d"]), _t(s["tmn"]),
                       torch.full((300,), 5.0))
    assert not occ.any()


def test_walk_matches_brute(synthetic):
    """The port's walk against the port's brute force (the oracle)."""
    s = synthetic
    p0, e1, e2 = (_t(a) for a in s["tris"])
    o, d, tmn, tmx = _t(s["o"]), _t(s["d"]), _t(s["tmn"]), _t(s["tmx"])
    ref = tint.brute_force_closest(o, d, p0, e1, e2, tmn, tmx, False,
                                   chunk=128)
    got = trw.walk_closest(s["tcs"], o, d, tmn, tmx, False, sort_rays=True)
    np.testing.assert_array_equal(got.tri.numpy(), ref.tri.numpy())
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=RTOL)
    tseg = torch.where(tmx < 0, -1.0, 1.5)
    np.testing.assert_array_equal(
        trw.walk_any(s["tcs"], o, d, tmn, tseg).numpy(),
        tint.brute_force_any(o, d, p0, e1, e2, tmn, tseg, chunk=128).numpy())


@pytest.mark.parametrize("cull", [True, False])
def test_brute_matches_jax(synthetic, cull):
    s = synthetic
    args = [s["o"], s["d"], *s["tris"], s["tmn"], s["tmx"]]
    ref = jint.brute_force_closest(*map(jnp.asarray, args), cull, chunk=128)
    got = tint.brute_force_closest(*map(_t, args), cull, chunk=128)
    _assert_same_hits(ref, got)
    tseg = np.full_like(s["tmx"], 1.5)
    args[-1] = tseg
    np.testing.assert_array_equal(
        tint.brute_force_any(*map(_t, args), chunk=128).numpy(),
        np.asarray(jint.brute_force_any(*map(jnp.asarray, args), chunk=128)))


def test_row_entries_matches_jax(synthetic):
    s = synthetic
    n = 296                                  # a multiple of the 8-ray row
    args = [s["o"][:n], s["d"][:n], s["tmn"][:n], s["tmx"][:n]]
    jcs, tcs = s["jcs"], s["tcs"]
    ref = jrw.row_entries(jcs.cmin, jcs.cmax, *map(jnp.asarray, args))
    got = trw.row_entries(tcs.cmin, tcs.cmax, *map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cpu_tensors_take_plain_version(synthetic):
    """CPU tensors go through the plain version: no launch is counted."""
    s = synthetic
    kernels.reset_launches()
    trw.walk_closest(s["tcs"], _t(s["o"]), _t(s["d"]), _t(s["tmn"]),
                     _t(s["tmx"]), False, sort_rays=True)
    trw.walk_any(s["tcs"], _t(s["o"]), _t(s["d"]), _t(s["tmn"]),
                 _t(s["tmx"]), sort_rays=True)
    assert kernels.LAUNCHES == {"walk_closest": 0, "walk_any": 0}


def test_kernel_binding_rejects_cpu_tensors(synthetic):
    """The kernel binding itself takes only CUDA tensors: it raises before
    anything is built or launched."""
    s = synthetic
    n = 128
    o = torch.zeros((n, 3))
    row_e = torch.zeros((n // 8, s["tcs"].num_clusters))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.closest(o, o, o[:, 0], o[:, 0], row_e, s["tcs"].tri_begin,
                        s["tcs"].tri_slots, True)
    assert kernels.LAUNCHES["walk_closest"] == 0


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel modules builds nothing (no nvcc here)."""
    code = ("import spcbpt_tpu_torch.kernels.ray_walk as k, "
            "spcbpt_tpu_torch.kernels.build as b, "
            "spcbpt_tpu_torch.ops.ray_walk; "
            "assert not b._LIBS and not b.BUILD_LOG; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_HOME": "/none",
                              "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_tri_slots_repack_keeps_slot_numbering(synthetic):
    """The kernels' slot-major table holds the same triangle in each slot as
    the JAX package's (C, 16, 128) block."""
    cs = synthetic["tcs"]
    blk = cs.tri_block
    slots = cs.tri_slots.numpy().reshape(cs.num_clusters, 128, 3, 4)
    np.testing.assert_array_equal(slots[..., :3].reshape(-1, 128, 9),
                                  blk[:, :9, :].transpose(0, 2, 1))
    assert (slots[..., 3] == 0).all()

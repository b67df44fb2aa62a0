"""The port's brute-force traversal (ops/brute_trace, the plain version of
kernel K3 on CPU tensors) against the JAX package: the Pallas kernels of
ops/pallas_trace.py in interpret mode and the XLA brute force of
ops/intersect.py, on Cornell, both cull settings, with dead lanes."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import intersect as jintersect
from spcbpt_tpu.render.common import camera_rays as jcamera_rays
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch.kernels import brute_trace as kernels
from spcbpt_tpu_torch.ops import brute_trace
from spcbpt_tpu_torch.scene import scene as tscene
from spcbpt_tpu_torch.scene.scene import from_jax_scene

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

SIDE = 32            # 1024 camera rays
# t, u, v on hit lanes: XLA's CPU compiler contracts the Moller-Trumbore
# multiply-adds into FMAs and torch does not, so they differ in the last
# bits (up to ~5e-6 relative at grazing hits); triangle ids are exact.
RTOL = 1e-5
ATOL = 1e-6


@pytest.fixture(scope="module")
def pallas_interpret():
    """ops.pallas_trace reloaded with pallas_call forced to interpret mode
    (as tests/test_pallas.py runs it on the CPU)."""
    from jax.experimental import pallas as pl
    import spcbpt_tpu.ops.pallas_trace as P

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
def rays():
    """Cornell scene in both packages and 1024 camera rays, every fourth
    lane dead (tmax < tmin)."""
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    eye, U, V, W = cam.uvw()
    o, d, _ = jcamera_rays(jnp.asarray(eye), jnp.asarray(U), jnp.asarray(V),
                           jnp.asarray(W), SIDE, SIDE, 3)
    n = SIDE * SIDE
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[::4] = -1.0
    return jts, from_jax_scene(jts, "cpu"), np.array(o), np.array(d), \
        tmin, tmax


def _tris_j(jts):
    return jts.tri_p0, jts.tri_e1, jts.tri_e2


def _tris_t(ts):
    return ts.tri_p0, ts.tri_e1, ts.tri_e2


def _port_closest(ts, o, d, tmin, tmax, cull):
    t = torch.from_numpy
    return brute_trace.brute_closest(t(o), t(d), t(tmin), t(tmax),
                                     *_tris_t(ts), cull)


@pytest.mark.parametrize("cull", [True, False])
def test_closest_matches_pallas(pallas_interpret, rays, cull):
    jts, ts, o, d, tmin, tmax = rays
    P = pallas_interpret
    jt, jtri, ju, jv = (np.asarray(a) for a in P.pallas_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
        *_tris_j(jts), cull))
    got = _port_closest(ts, o, d, tmin, tmax, cull)
    tri = got.tri.numpy()
    np.testing.assert_array_equal(tri, jtri)
    hit = tri >= 0
    assert 0.5 < hit.mean() < 0.75         # a quarter dead, some misses
    assert not hit[::4].any()
    for a, b in ((got.t, jt), (got.u, ju), (got.v, jv)):
        np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=RTOL,
                                   atol=ATOL)
    # miss convention: the port keeps t=1e30, u=v=0 (the trace API's);
    # Pallas leaves t=min(tmax, 1e30)
    assert (got.t.numpy()[~hit] == np.float32(1e30)).all()
    assert (got.u.numpy()[~hit] == 0).all() and (got.v.numpy()[~hit] == 0).all()
    np.testing.assert_array_equal(jt[~hit], np.minimum(tmax[~hit], 1e30))


@pytest.mark.parametrize("cull", [True, False])
def test_closest_matches_jax_brute_force(rays, cull):
    jts, ts, o, d, tmin, tmax = rays
    ref = jintersect.brute_force_closest(
        jnp.asarray(o), jnp.asarray(d), *_tris_j(jts), jnp.asarray(tmin),
        jnp.asarray(tmax), cull, chunk=32)
    got = _port_closest(ts, o, d, tmin, tmax, cull)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   atol=ATOL)


def test_any_matches_pallas_and_jax_brute_force(pallas_interpret, rays):
    """Segments ending just short of the closest hit, and at 2x past it:
    occlusion exactly as both JAX versions give it, dead lanes never
    occluded."""
    jts, ts, o, d, tmin, tmax = rays
    ref = _port_closest(ts, o, d, tmin, tmax, False)
    t_hit = np.where(ref.tri.numpy() >= 0, ref.t.numpy(), 10.0)
    lanes = np.arange(len(t_hit))
    seg = np.where(lanes % 2 == 0, 0.99 * t_hit, 2.0 * t_hit)
    seg = np.where(tmax < 0, -1.0, seg).astype(np.float32)
    got = brute_trace.brute_any(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(tmin),
                                torch.from_numpy(seg), *_tris_t(ts)).numpy()
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    pal = np.asarray(pallas_interpret.pallas_any(
        jo, jd, jnp.asarray(tmin), jnp.asarray(seg), *_tris_j(jts)))
    xla = np.asarray(jintersect.brute_force_any(
        jo, jd, *_tris_j(jts), jnp.asarray(tmin), jnp.asarray(seg), chunk=32))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, xla)
    assert not got[tmax < 0].any()
    assert 0.1 < got.mean() < 0.6


def test_scene_brute_mode_routes_through_brute_trace(rays, monkeypatch):
    """trace_closest/trace_any of a brute-mode scene go through
    ops/brute_trace (which launches K3 on CUDA tensors)."""
    _, ts, o, d, tmin, tmax = rays
    assert ts.mode == "brute"
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(brute_trace, name, wrapped)

    spy("brute_closest", brute_trace.brute_closest)
    spy("brute_any", brute_trace.brute_any)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hit = tscene.trace_closest(ts, o, d, 1e-3, torch.from_numpy(tmax), True)
    occ = tscene.trace_any(ts, o, d, 1e-3, 0.5)
    assert calls == ["brute_closest", "brute_any"]
    assert (hit.tri >= 0).any() and occ.dtype == torch.bool


def test_kernel_binding_refuses_what_it_cannot_take(rays):
    """No fallback: the K3 binding raises on CPU tensors and on more
    triangles than its shared-memory table holds."""
    _, ts, o, d, tmin, tmax = rays
    args = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.closest(*args, *_tris_t(ts), True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.any_hit(*args, *_tris_t(ts))
    big = torch.zeros((kernels.MAX_TRIS + 1, 3))
    with pytest.raises(ValueError, match="triangles"):
        kernels.closest(*args, big, big, big, True)

"""The port's camera rays, Disney BSDF and light sampling against the JAX
package on the same inputs (Cornell box; rtol 1e-5, atol 1e-6).

Inputs are made with numpy from fixed seeds; the rng state is the same
uint32 stream in both packages, so sampled directions and lights match."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spcbpt_tpu.ops import bsdf as jbsdf
from spcbpt_tpu.ops import lights as jlights
from spcbpt_tpu.render import common as jcommon
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.utils import rng as jrng
from spcbpt_tpu_torch.ops import bsdf as tbsdf
from spcbpt_tpu_torch.ops import lights as tlights
from spcbpt_tpu_torch.render import common as tcommon
from spcbpt_tpu_torch.scene.scene import from_jax_scene
from spcbpt_tpu_torch.utils import rng as trng

# the tensors here are small: one thread per xdist worker avoids
# oversubscribing the cores

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def cornell():
    jts, _, cam = jload(default_scene_path(glossy=True))
    cam.aspect = 1.0
    return jts, from_jax_scene(jts, "cpu"), cam.uvw()


def _unit(rng, n):
    x = rng.normal(size=(n, 3)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def lanes():
    """Random materials covering every lobe, normals and directions in the
    hemisphere (plus some below it)."""
    rng = np.random.default_rng(21)
    u = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, N).astype(np.float32)
    mat = dict(base_color=rng.uniform(0, 1, (N, 3)).astype(np.float32),
               metallic=u(), roughness=u(0.0, 1.0), specular=u(),
               specular_tint=u(), subsurface=u(), sheen=u(), sheen_tint=u(),
               clearcoat=u(), clearcoat_gloss=u(),
               brdf=rng.uniform(size=N) < 0.2)
    n = _unit(rng, N)
    v = _unit(rng, N)
    l = _unit(rng, N)
    v = np.where((v * n).sum(-1, keepdims=True) < 0, -v, v)
    l[N // 8:] = np.where((l[N // 8:] * n[N // 8:]).sum(-1, keepdims=True)
                          < 0, -l[N // 8:], l[N // 8:])
    return mat, n, v, l


def _both(mat):
    jm = {k: jnp.asarray(a) for k, a in mat.items()}
    tm = {k: torch.from_numpy(np.asarray(a)) for k, a in mat.items()}
    return jm, tm


@pytest.mark.parametrize("subframe,block", [(0, 0), (3, 0), (0, 8), (5, 8)])
def test_camera_rays(cornell, subframe, block):
    _, _, (eye, U, V, W) = cornell
    jo, jd, js = jcommon.camera_rays(eye, U, V, W, 32, 32, subframe,
                                     block=block)
    to, td, tst = tcommon.camera_rays(eye, U, V, W, 32, 32, subframe,
                                      block=block)
    _close(to, jo)
    _close(td, jd)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(js).astype(np.int64))


def test_accumulate():
    rng = np.random.default_rng(2)
    acc = rng.uniform(size=(64, 3)).astype(np.float32)
    s = rng.uniform(0, 20, size=(64, 3)).astype(np.float32)
    for clamp in (None, 4.0):
        ref = jcommon.accumulate(jnp.asarray(acc), jnp.asarray(s), 5, clamp)
        got = tcommon.accumulate(torch.from_numpy(acc), torch.from_numpy(s),
                                 5, clamp)
        _close(got, ref)


@pytest.mark.parametrize("fn", ["eval_bsdf", "pdf_bsdf"])
def test_bsdf_value_and_pdf(lanes, fn):
    mat, n, v, l = lanes
    jm, tm = _both(mat)
    ref = getattr(jbsdf, fn)(jm, *map(jnp.asarray, (n, v, l)))
    got = getattr(tbsdf, fn)(tm, *map(torch.from_numpy, (n, v, l)))
    _close(got, ref)
    assert np.asarray(ref).any()


def test_pdf_bsdf_pair(lanes):
    mat, n, v, l = lanes
    jm, tm = _both(mat)
    ref = jbsdf.pdf_bsdf_pair(jm, *map(jnp.asarray, (n, v, l)))
    got = tbsdf.pdf_bsdf_pair(tm, *map(torch.from_numpy, (n, v, l)))
    for g, r in zip(got, ref):
        _close(g, r)


def test_sample_bsdf(lanes):
    mat, n, v, _ = lanes
    jm, tm = _both(mat)
    lane = np.arange(N, dtype=np.uint32)
    jd, js = jbsdf.sample_bsdf(jm, jnp.asarray(n), jnp.asarray(v),
                               jrng.seed(jnp.asarray(lane), jnp.uint32(9)))
    tstate = trng.seed(torch.from_numpy(lane.astype(np.int64)), 9)
    td, ts = tbsdf.sample_bsdf(tm, torch.from_numpy(n), torch.from_numpy(v),
                               tstate)
    _close(td, jd)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))


def test_rr_rate(lanes):
    mat = lanes[0]
    c = mat["base_color"] * 1.5
    _close(tbsdf.rr_rate(torch.from_numpy(c), 0.3),
           jbsdf.rr_rate(jnp.asarray(c), 0.3))


def test_gather_mat(cornell):
    jts, ts, _ = cornell
    ids = np.random.default_rng(4).integers(0, ts.mats.metallic.shape[0], 64)
    ref = jbsdf.gather_mat(jts.mats, jnp.asarray(ids, jnp.int32))
    got = tbsdf.gather_mat(ts.mats, torch.from_numpy(ids.astype(np.int32)))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_sample_light(cornell):
    jts, ts, _ = cornell
    lane = np.arange(N, dtype=np.uint32)
    jls, jst = jlights.sample_light(jts, jrng.seed(jnp.asarray(lane),
                                                   jnp.uint32(3)))
    tls, tst = tlights.sample_light(ts, trng.seed(
        torch.from_numpy(lane.astype(np.int64)), 3))
    for f in ("position", "emission", "direction", "normal", "uv", "pdf"):
        _close(getattr(tls, f), getattr(jls, f))
    for f in ("subspace_id", "light_id", "is_env"):
        np.testing.assert_array_equal(getattr(tls, f).numpy(),
                                      np.asarray(getattr(jls, f)))
    np.testing.assert_array_equal(tst.numpy(),
                                  np.asarray(jst).astype(np.int64))


def test_reverse_sample_quad(cornell):
    jts, ts, _ = cornell
    rng = np.random.default_rng(8)
    uv = rng.uniform(size=(N, 2)).astype(np.float32)
    lid = np.zeros(N, np.int32)
    ref = jlights.reverse_sample_quad(jts, jnp.asarray(lid), jnp.asarray(uv))
    got = tlights.reverse_sample_quad(ts, torch.from_numpy(lid),
                                      torch.from_numpy(uv))
    for f in ("position", "emission", "normal", "pdf"):
        _close(getattr(got, f), getattr(ref, f))
    np.testing.assert_array_equal(got.subspace_id.numpy(),
                                  np.asarray(ref.subspace_id))

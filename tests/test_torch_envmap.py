"""The port's HDR loader and environment map (scene/hdr.py,
scene/envmap.py) against the JAX package's: the host halves bit for bit,
the device functions to 1e-5 with the texel each direction lands in
compared lane by lane (atan2/acos/asin may round differently in torch and
XLA and put a direction on the other side of a texel edge)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.scene import envmap as jem
from spcbpt_tpu.scene.hdr import load_hdr as jload_hdr
from spcbpt_tpu_torch.scene import envmap as tem
from spcbpt_tpu_torch.scene import hdr as thdr

from sky_scene import sky_raster

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TEXEL_AGREE = 0.999
N_DIRS = 20_000


@pytest.mark.parametrize("rle", [False, True])
def test_load_hdr_matches_jax(tmp_path, rle):
    """Both scanline forms: the port's loader equals JAX's bit for bit, and
    both read back the encoder's values."""
    rgb = sky_raster(seed=3, h=12, w=40)
    rgb[:, 5:30] = 0.25          # long runs for the RLE encoder
    rgb[2, 7] = 0.0
    path = os.path.join(tmp_path, "sky.hdr")
    thdr.write_hdr(path, rgb, rle=rle)
    with open(path, "rb") as f:
        body = f.read().split(b"+X 40\n", 1)[1]
    assert (body[:2] == b"\x02\x02") == rle
    got = thdr.load_hdr(path)
    np.testing.assert_array_equal(got, jload_hdr(path))
    rgbe = thdr.encode_rgbe(rgb)
    scale = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)
    np.testing.assert_array_equal(
        got, (rgbe[..., :3] * np.where(rgbe[..., 3:] == 0, 0.0, scale[..., None])
              ).astype(np.float32))
    # 8-bit mantissas rounded down: within 1/128 of the largest channel
    assert (np.abs(got - rgb) <= rgb.max(axis=-1, keepdims=True) / 128).all()


def test_write_hdr_refuses_a_flat_row_read_as_rle(tmp_path):
    rgb = np.full((2, 16, 3), 0.5, np.float32)
    rgb[1, 0] = (2.0 / 128, 2.0 / 128, 1.0)   # encodes as (2, 2, 128, 129)
    assert tuple(thdr.encode_rgbe(rgb)[1, 0, :2]) == (2, 2)
    with pytest.raises(ValueError, match="RLE"):
        thdr.write_hdr(os.path.join(tmp_path, "x.hdr"), rgb, rle=False)
    thdr.write_hdr(os.path.join(tmp_path, "x.hdr"), rgb, rle=True)


def _envs(dir_lights=(), env_factor=1.0, seed=0):
    raster = sky_raster(seed)
    center, diag = np.array([0.5, 1.0, -0.25], np.float32), 9.5
    return (jem.build_envmap(raster, center, diag, dir_lights, env_factor),
            tem.build_envmap(raster, center, diag, dir_lights, env_factor))


def _assert_env_equal(t, j):
    for f in ("tex", "cmf", "center", "r", "valid"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert (t.height, t.width, t.size) == (j.height, j.width, j.size)


@pytest.mark.parametrize("case", ["plain", "direction_lights"])
def test_build_envmap_matches_jax(case):
    """Raster, CMF (float64 cumsum, diamond neighbourhood, 25% uniform),
    centre, radius: bit-equal; with two Direction lights baked in and
    env_lum 0.7."""
    kw = {} if case == "plain" else dict(
        dir_lights=[((0.3, -1.0, 0.4), (3.0, 2.5, 2.0)),
                    ((-1.0, -0.2, 0.0), (0.5, 0.5, 0.5))], env_factor=0.7)
    j, t = _envs(**kw)
    _assert_env_equal(t, j)
    if kw:
        plain = tem.build_envmap(sky_raster(0), np.zeros(3), 1.0)
        assert (t.tex.sum() > 0.7 * plain.tex.sum()).item()
        assert not torch.equal(t.cmf, plain.cmf)


def test_dummy_envmap_matches_jax():
    _assert_env_equal(tem.dummy_envmap(), jem.dummy_envmap())


def _dirs(seed=1, n=N_DIRS):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _texels(env, uv):
    x, y = tem.uv2coord(uv, env.height, env.width)
    return (x + y * env.width).numpy()


def test_device_functions_match_jax():
    """dir2uv/uv2dir to 1e-5; the texel index agrees on >= 99.9% of lanes,
    and where it does, colour, pdf and label are equal."""
    j, t = _envs(dir_lights=[((0.3, -1.0, 0.4), (3.0, 2.5, 2.0))])
    d = _dirs()
    td, jd = torch.from_numpy(d), jnp.asarray(d)
    uv, juv = tem.dir2uv(td), np.array(jem.dir2uv(jd))
    np.testing.assert_allclose(uv.numpy(), juv, rtol=RTOL, atol=ATOL)
    same = _texels(t, uv) == _texels(t, torch.from_numpy(juv))
    print(f"texel agreement {same.mean():.6f} over {N_DIRS} directions")
    assert same.mean() >= TEXEL_AGREE
    for tf, jf in ((tem.env_color, jem.env_color), (tem.env_pdf, jem.env_pdf),
                   (tem.env_label, jem.env_label)):
        np.testing.assert_array_equal(tf(t, td).numpy()[same],
                                      np.asarray(jf(j, jd))[same],
                                      err_msg=tf.__name__)
    np.testing.assert_allclose(tem.uv2dir(uv).numpy(),
                               np.asarray(jem.uv2dir(jnp.asarray(juv))),
                               rtol=RTOL, atol=ATOL)
    lab = tem.env_label(t, td).numpy()
    assert lab.min() >= 1000 - tem.ENV_DIV_LEVEL ** 2 and lab.max() <= 999
    assert float(tem.env_project_pdf(t)) == float(jem.env_project_pdf(j))


def test_env_sample_matches_jax():
    """The same uniforms: the CMF search (right-sided, clipped) picks the
    same texel, and direction, pdf, colour, label and the projected-disk
    origin agree."""
    j, t = _envs(dir_lights=[((0.3, -1.0, 0.4), (3.0, 2.5, 2.0))])
    r = np.random.default_rng(2).uniform(size=(5, N_DIRS)).astype(np.float32)
    r[0, :4] = [0.0, 1.0 - 2 ** -24, float(t.cmf[0]), float(t.cmf[100])]
    tr, jr = torch.from_numpy(r), jnp.asarray(r)
    got = tem.env_sample(t, tr[0], tr[1], tr[2])
    ref = [np.asarray(x) for x in jem.env_sample(j, jr[0], jr[1], jr[2])]
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=RTOL, atol=ATOL)
    idx = torch.searchsorted(t.cmf, tr[0], right=True).clamp(max=t.size - 1)
    same = _texels(t, tem.dir2uv(got[0])) == idx.numpy()
    assert same.mean() >= TEXEL_AGREE
    for g, rf in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy()[same], rf[same])
    pos = tem.env_sample_project_pos(t, got[0], tr[3], tr[4])
    jpos = jem.env_sample_project_pos(j, jnp.asarray(got[0].numpy()), jr[3],
                                      jr[4])
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=RTOL,
                               atol=1e-5)
    # the sun texel (the Direction light) draws far more than its area
    hot = (got[2].sum(-1) > 50).numpy().mean()
    assert hot > 0.2, hot


def test_env_pdf_integrates_to_one():
    """The texels are equal-area (v = (1 + sin(elevation)) / 2), so the
    solid-angle pdf at every texel centre times 4 pi / size sums to 1, and
    E[1 / pdf] over sampled directions is 4 pi."""
    _, t = _envs(dir_lights=[((0.3, -1.0, 0.4), (3.0, 2.5, 2.0))])
    h, w = t.height, t.width
    v, u = torch.meshgrid((torch.arange(h) + 0.5) / h,
                          (torch.arange(w) + 0.5) / w, indexing="ij")
    centres = tem.uv2dir(torch.stack([u, v], -1).reshape(-1, 2))
    total = (tem.env_pdf(t, centres).double() * (4 * np.pi / t.size)).sum()
    assert abs(total.item() - 1.0) < 1e-4, total.item()
    assert abs(float(t.cmf[-1]) - 1.0) < 1e-6
    assert (torch.diff(t.cmf) >= 0).all()
    r = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(3, 100_000)).astype(np.float32))
    _, pdf, _, _ = tem.env_sample(t, r[0], r[1], r[2])
    est = (1.0 / pdf.double()).mean().item() / (4 * np.pi)
    assert abs(est - 1.0) < 0.05, est

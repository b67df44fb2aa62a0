"""The port's jax-free scene build against the JAX package's, array by array,
and the shading gathers on primary hits."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spcbpt_tpu.scene import cornell, interior
from spcbpt_tpu.scene import scene as jscene
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.parser import load_scene
from spcbpt_tpu_torch.render.common import camera_rays
from spcbpt_tpu_torch.scene import scene as tscene
from spcbpt_tpu_torch.utils.image import write_png

# the tensors here are small: one thread per xdist worker avoids
# oversubscribing the cores

from jax_native import native_jax_route  # noqa: F401 (autouse)
from sky_scene import write_sky_floor

torch.set_num_threads(1)

_GEOM = ("tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_uv", "tri_mat",
         "tri_light", "textures", "tex_h", "tex_w", "bvh_min", "bvh_max",
         "bvh_skip", "bvh_leaf_start", "bvh_leaf_count")
_CLUSTERS = ("cmin", "cmax", "tri_block", "tri_begin")


def _assert_scene_equal(ts, jts):
    for f in _GEOM:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(jts, f)), err_msg=f)
    for group in ("mats", "lights"):
        tg, jg = getattr(ts, group), getattr(jts, group)
        for f in dataclasses.fields(tg):
            np.testing.assert_array_equal(getattr(tg, f.name).numpy(),
                                          np.asarray(getattr(jg, f.name)),
                                          err_msg=f"{group}.{f.name}")
    for f in ("num_lights", "num_quad_lights", "has_env", "mode",
              "world_scale"):
        assert getattr(ts, f) == getattr(jts, f), f
    for f in ("tex", "cmf", "center", "r", "valid"):
        np.testing.assert_array_equal(getattr(ts.env, f).numpy(),
                                      np.asarray(getattr(jts.env, f)),
                                      err_msg=f"env.{f}")
    if ts.mode == "walk":
        for f in _CLUSTERS:
            x = getattr(ts.clusters_walk, f)   # tri_block lives on the host
            np.testing.assert_array_equal(
                x.numpy() if torch.is_tensor(x) else x,
                np.asarray(getattr(jts.clusters_walk, f)), err_msg=f)


@pytest.fixture(scope="module")
def interior_path(tmp_path_factory):
    return interior.generate(str(tmp_path_factory.mktemp("interior")),
                             scale=1)


@pytest.fixture(scope="module")
def scenes(interior_path):
    """(jax scene, port scene) pairs: Cornell in brute mode, the scale=1
    interior (2,264 triangles) in walk mode."""
    out = {}
    for name, path, mode in (("cornell", default_scene_path(), "brute"),
                             ("interior", interior_path, "walk")):
        jts = jscene.build_scene(load_scene(path), mode=mode)
        ts = tscene.build_scene(load_scene(path), "cpu")
        out[name] = (jts, ts, path)
    return out


@pytest.mark.parametrize("name", ["cornell", "interior"])
def test_build_scene_matches_jax(scenes, name):
    jts, ts, _ = scenes[name]
    assert ts.mode == {"cornell": "brute", "interior": "walk"}[name]
    _assert_scene_equal(ts, jts)


def test_interior_cluster_counts(scenes):
    _, ts, _ = scenes["interior"]
    assert ts.num_tris == 2264
    assert ts.clusters_walk.num_clusters == 30


@pytest.mark.parametrize("name", ["cornell", "interior"])
def test_from_jax_scene_matches_build(scenes, name):
    jts, ts, _ = scenes[name]
    _assert_scene_equal(tscene.from_jax_scene(jts, "cpu"), jts)


def test_mode_selection():
    assert tscene.select_mode(512, "cuda") == "brute"
    assert tscene.select_mode(513, "cuda") == "walk"
    assert tscene.select_mode(1024, "cpu") == "brute"
    assert tscene.select_mode(1025, "cpu") == "walk"


def test_unported_modes_raise(scenes):
    """An unknown mode name raises; `bvh` builds, its arrays JAX's."""
    _, _, path = scenes["cornell"]
    with pytest.raises(ValueError):
        tscene.build_scene(load_scene(path), "cpu", mode="kd-tree")
    ts = tscene.build_scene(load_scene(path), "cpu", mode="bvh")
    jts = jscene.build_scene(load_scene(path), mode="bvh")
    assert ts.mode == "bvh"
    _assert_scene_equal(ts, jts)


def test_envmap_raises(scenes, tmp_path):
    """An env_file no longer raises: the Cornell box under a sky (RLE
    scanlines) with a Direction light builds as JAX's does, one light more
    and the quads' subspace blocks from 100."""
    from spcbpt_tpu_torch.scene.hdr import write_hdr
    from sky_scene import sky_raster

    _, _, path = scenes["cornell"]
    sky = str(tmp_path / "sky.hdr")
    write_hdr(sky, sky_raster(seed=5, h=32, w=64), rle=True)
    built = []
    for build in (lambda d: jscene.build_scene(d, mode="brute"),
                  lambda d: tscene.build_scene(d, "cpu")):
        desc = load_scene(path)
        desc.env_file = sky      # absolute: joined to the scene's root as is
        desc.env_factor = 0.5
        desc.lights.append(dataclasses.replace(
            desc.lights[0], light_type="Direction", direction=(0.0, 0.0, 1.0),
            emission=(2.0, 2.0, 2.0)))
        built.append(build(desc))
    jts, ts = built
    _assert_scene_equal(ts, jts)
    assert ts.has_env and ts.num_lights == ts.num_quad_lights + 1 == 2
    assert int(ts.lights.ss_base[0]) == 100
    assert abs(float(ts.env.r) - tscene.TARGET_DIAG) < 1e-3


@pytest.fixture(scope="module")
def sky_floor(tmp_path_factory):
    root = tmp_path_factory.mktemp("sky_floor")
    return {name: write_sky_floor(str(root / name), **kw) for name, kw in (
        ("sky", {}), ("sky_direction", dict(direction=True)),
        ("direction_only", dict(direction=True, sky=False)),
        ("bare", dict(sky=False)))}


@pytest.mark.parametrize("name", ["sky", "sky_direction"])
def test_sky_scene_build_and_from_jax_match_jax(sky_floor, name):
    """The sky-lit floor: build_scene equals JAX's (the env's raster, CMF,
    centre and radius, num_lights, ss_base 100), and from_jax_scene carries
    the env across."""
    desc = lambda: load_scene(sky_floor[name])
    jts = jscene.build_scene(desc(), mode="brute")
    ts = tscene.build_scene(desc(), "cpu")
    _assert_scene_equal(ts, jts)
    assert ts.has_env and ts.num_lights == 2
    assert int(ts.lights.ss_base[0]) == 100
    _assert_scene_equal(tscene.from_jax_scene(jts, "cpu"), jts)


def test_direction_light_without_sky_is_dropped(sky_floor):
    """A Direction light lives in the sky's raster: without an env_file the
    scene is the one without the light, in both packages."""
    got = tscene.build_scene(load_scene(sky_floor["direction_only"]), "cpu")
    bare = tscene.build_scene(load_scene(sky_floor["bare"]), "cpu")
    jts = jscene.build_scene(load_scene(sky_floor["direction_only"]),
                             mode="brute")
    _assert_scene_equal(got, jts)
    _assert_scene_equal(bare, jts)
    assert not got.has_env and got.num_lights == 1
    assert int(got.lights.ss_base[0]) == 0


def test_load_trace_scene_camera(scenes):
    _, _, path = scenes["interior"]
    _, _, jcam = jscene.load_trace_scene(path, mode="walk")
    _, _, tcam = tscene.load_trace_scene(path, "cpu")
    for a, b in zip(tcam.uvw(), jcam.uvw()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["cornell", "interior"])
def test_primary_hit_shading_matches_jax(scenes, name):
    """trace_closest + local_geometry + visibility on the same primary rays
    (JAX in brute mode as the reference)."""
    jts, ts, path = scenes[name]
    jts_b = jscene.build_scene(load_scene(path), mode="brute")
    _, _, cam = jscene.load_trace_scene(path, mode="brute")
    cam.aspect = 1.0
    o, d, _ = camera_rays(*cam.uvw(), 24, 24, 1)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    jhit = jscene.trace_closest(jts_b, jo, jd, 1e-3, 1e16, False)
    hit = tscene.trace_closest(ts, o, d, 1e-3, 1e16, False)
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(jhit.tri))
    assert (hit.tri.numpy() >= 0).mean() > 0.8
    jg = jscene.local_geometry(jts_b, jhit, jo, jd)
    g = tscene.local_geometry(ts, hit, o, d)
    for k in ("P", "Ns", "Ng", "uv", "base_color"):
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("mat_id", "light_id"):
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(jg[k]))
    # visibility from the hits toward the first light's centre, a third of
    # the lanes masked off (their value is unspecified)
    target = ts.lights.corner[0] + 0.5 * (ts.lights.u[0] + ts.lights.v[0])
    pa = g["P"] + 1e-3 * g["Ns"]
    pb = target.expand(pa.shape)
    mask = torch.arange(pa.shape[0]) % 3 != 0
    jvis = jscene.visibility(jts_b, jnp.asarray(pa.numpy()),
                             jnp.asarray(pb.numpy()))
    vis = tscene.visibility(ts, pa, pb, mask=mask)
    np.testing.assert_array_equal(vis.numpy()[mask.numpy()],
                                  np.asarray(jvis)[mask.numpy()])
    assert 0 < np.asarray(jvis).mean() < 1


def test_png_textures_match_jax(tmp_path):
    """A generated Cornell scene whose White and Red materials reference
    `albedoTex` PNGs of different sizes, written with the port's zlib PNG
    writer: the decoded, linearised and padded texture stack, its per-texture
    sizes and the materials' texture ids equal the JAX package's, and so do
    the texture-modulated base colours at primary hits."""
    path = cornell.generate(str(tmp_path), False)
    rng = np.random.default_rng(3)
    for name, (h, w) in (("white", (6, 4)), ("red", (3, 5))):
        write_png(str(tmp_path / "cornell" / f"{name}.png"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    with open(path) as f:
        text = f.read()
    for mat, name in (("White", "white"), ("Red", "red")):
        block = f"material {mat}\n{{\n"
        assert block in text
        text = text.replace(
            block, f"{block}    albedoTex cornell/{name}.png\n")
    with open(path, "w") as f:
        f.write(text)

    jts = jscene.build_scene(load_scene(path), mode="brute")
    ts = tscene.build_scene(load_scene(path), "cpu")
    assert ts.textures.shape == (2, 6, 5, 3)
    np.testing.assert_array_equal(ts.tex_h.numpy(), [6, 3])
    np.testing.assert_array_equal(ts.tex_w.numpy(), [4, 5])
    assert sorted(ts.mats.tex_id.numpy().tolist())[-2:] == [0, 1]
    assert (ts.textures.numpy()[1, 3:] == 0).all()      # padding of the stack
    _assert_scene_equal(ts, jts)
    _assert_scene_equal(tscene.from_jax_scene(jts, "cpu"), jts)

    _, _, cam = jscene.load_trace_scene(path, mode="brute")
    cam.aspect = 1.0
    o, d, _ = camera_rays(*cam.uvw(), 16, 16, 1)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    jhit = jscene.trace_closest(jts, jo, jd, 1e-3, 1e16, False)
    hit = tscene.trace_closest(ts, o, d, 1e-3, 1e16, False)
    jg = jscene.local_geometry(jts, jhit, jo, jd)
    g = tscene.local_geometry(ts, hit, o, d)
    np.testing.assert_allclose(g["base_color"].numpy(),
                               np.asarray(jg["base_color"]), rtol=1e-5,
                               atol=1e-5)
    # the textures modulate what the untextured scene shows
    plain = tscene.build_scene(load_scene(default_scene_path()), "cpu")
    g0 = tscene.local_geometry(plain, hit, o, d)
    assert not np.allclose(g["base_color"].numpy(), g0["base_color"].numpy())

"""The port's own copies of the JAX package's host modules (config, scene
parsing and generation, OBJ loading, camera, BVH build, native loader)
against the originals. Everything here is exact: the copies run the same
numpy and C++ code on the same inputs, so constants, parsed descriptions,
arrays and generated files must be equal, bit for bit and byte for byte."""
import dataclasses
import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from spcbpt_tpu import config as jconfig
from spcbpt_tpu.native import loader as jloader
from spcbpt_tpu.ops import bvh as jbvh
from spcbpt_tpu.scene import camera as jcamera
from spcbpt_tpu.scene import cornell as jcornell
from spcbpt_tpu.scene import interior as jinterior
from spcbpt_tpu.scene import obj as jobj
from spcbpt_tpu.scene import parser as jparser
from spcbpt_tpu_torch import config as tconfig
from spcbpt_tpu_torch.native import loader as tloader
from spcbpt_tpu_torch.ops import bvh as tbvh
from spcbpt_tpu_torch.scene import camera as tcamera
from spcbpt_tpu_torch.scene import cornell as tcornell
from spcbpt_tpu_torch.scene import interior as tinterior
from spcbpt_tpu_torch.scene import obj as tobj
from spcbpt_tpu_torch.scene import parser as tparser

from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

_BVH_FIELDS = ("bounds_min", "bounds_max", "skip", "leaf_start",
               "leaf_count", "order", "max_depth")


def _assert_same_files(a: str, b: str) -> None:
    """Two directory trees hold the same file names with the same bytes."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for sub in cmp.common_dirs:
        _assert_same_files(os.path.join(a, sub), os.path.join(b, sub))


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Cornell (plain and glossy) and the scale=1 interior (three lighting
    modes), written by each package into a directory of its own."""
    out = {}
    for pkg, cornell, interior in (("jax", jcornell, jinterior),
                                   ("port", tcornell, tinterior)):
        root = str(tmp_path_factory.mktemp(f"scenes_{pkg}"))
        paths = {"cornell": cornell.generate(root),
                 "cornell_glossy": cornell.generate(root, glossy=True)}
        for mode in ("interior", "lit", "cove"):
            paths[f"interior_{mode}"] = interior.generate(root, scale=1,
                                                          mode=mode)
        out[pkg] = (root, paths)
    return out


def _random_tris(n: int, seed: int):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    p0 = c + rs.normal(0, 0.3, (n, 3)).astype(np.float32)
    e1 = rs.normal(0, 0.4, (n, 3)).astype(np.float32)
    e2 = rs.normal(0, 0.4, (n, 3)).astype(np.float32)
    return p0, e1, e2


def test_config_equals_jax():
    """Every public constant and config dataclass of the JAX config."""
    names = [n for n in vars(jconfig) if not n.startswith("_")
             and n not in ("annotations", "dataclasses")]
    assert "NUM_SUBSPACE" in names and "RenderConfig" in names
    for name in names:
        j, t = getattr(jconfig, name), getattr(tconfig, name)
        if dataclasses.is_dataclass(j):
            assert [f.name for f in dataclasses.fields(j)] == \
                [f.name for f in dataclasses.fields(t)], name
            assert dataclasses.asdict(j()) == dataclasses.asdict(t()), name
        else:
            assert type(j) is type(t) and j == t, name


@pytest.mark.parametrize("name", ["cornell", "cornell_glossy",
                                  "interior_interior", "interior_lit",
                                  "interior_cove"])
def test_generated_scene_files_are_byte_equal(generated, name):
    (jroot, jpaths), (troot, tpaths) = generated["jax"], generated["port"]
    assert os.path.relpath(jpaths[name], jroot) == \
        os.path.relpath(tpaths[name], troot)
    _assert_same_files(os.path.dirname(jpaths[name]),
                       os.path.dirname(tpaths[name]))


def test_default_scene_paths_point_at_the_repo():
    """The copies sit at the JAX modules' depth: both resolve the repo's
    scenes/ directory to the same path (nothing is generated here)."""
    for j, t in ((jcornell, tcornell), (jinterior, tinterior)):
        jdir = os.path.dirname(os.path.abspath(j.__file__))
        tdir = os.path.dirname(os.path.abspath(t.__file__))
        assert os.path.abspath(os.path.join(jdir, "..", "..")) == \
            os.path.abspath(os.path.join(tdir, "..", ".."))


@pytest.mark.parametrize("name", ["cornell", "cornell_glossy",
                                  "interior_interior", "interior_cove"])
def test_parsed_scene_desc_equals_jax(generated, name):
    path = generated["port"][1][name]
    jd, td = jparser.load_scene(path), tparser.load_scene(path)
    # the dataclasses are the packages' own: compare them field by field
    # (assert_equal walks the dicts and lists and compares arrays exactly)
    np.testing.assert_equal(dataclasses.asdict(td), dataclasses.asdict(jd))
    assert td.meshes and td.lights


@pytest.mark.parametrize("name", ["cornell", "interior_interior"])
def test_obj_arrays_equal_jax(generated, name):
    """Each mesh of the scene through both load_obj routes (the native parser
    here, g++ being on the PATH) and both pure-Python parsers."""
    path = generated["port"][1][name]
    desc = tparser.load_scene(path)
    for mesh in desc.meshes:
        f = os.path.join(desc.root_dir, mesh.file)
        j, t = jobj.load_obj(f), tobj.load_obj(f)
        jp, tp = jobj.load_obj_python(f), tobj.load_obj_python(f)
        for field in ("positions", "normals", "uvs"):
            for a, b in ((j, t), (jp, tp)):
                x, y = getattr(a, field), getattr(b, field)
                assert x.dtype == y.dtype and x.shape == y.shape, field
                np.testing.assert_array_equal(x, y, err_msg=f"{f} {field}")
        assert len(t.positions) > 0


def test_camera_uvw_equals_jax(generated):
    desc = tparser.load_scene(generated["port"][1]["interior_interior"])
    kw = dict(eye=np.asarray(desc.eye), lookat=np.asarray(desc.lookat),
              up=np.asarray(desc.up), fov_y=desc.fov, aspect=1.5)
    for a, b in zip(jcamera.Camera(**kw).uvw(), tcamera.Camera(**kw).uvw()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _scene_tris(path):
    """(p0, e1, e2) of every mesh of a scene file, as the scene build makes
    them (without the light quads and unit scaling)."""
    desc = tparser.load_scene(path)
    pos = np.concatenate([tobj.load_obj(os.path.join(desc.root_dir,
                                                     m.file)).positions
                          for m in desc.meshes])
    return pos[:, 0], pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]


@pytest.mark.parametrize("case", ["random500", "random5000", "interior"])
def test_build_bvh_equals_jax(generated, case):
    """build_bvh takes the JAX package's route on this host (native where
    g++ is on the PATH) and gives its tree, array for array; the numpy
    routes agree too (the two routes give different trees)."""
    if case == "interior":
        tris = _scene_tris(generated["port"][1]["interior_interior"])
    else:
        tris = _random_tris(int(case[len("random"):]), seed=len(case))
    j, t = jbvh.build_bvh(*tris), tbvh.build_bvh(*tris)
    expected = "native" if tloader.compiler() else "numpy"
    assert tbvh.BUILD_ROUTE == expected
    assert (jloader.get_lib() is not None) == (expected == "native")
    jn, tn = jbvh.build_bvh_numpy(*tris), tbvh.build_bvh_numpy(*tris)
    for f in _BVH_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(tn, f), getattr(jn, f),
                                      err_msg=f)
    assert sorted(t.order.tolist()) == list(range(len(tris[0])))


def test_both_packages_take_the_native_route():
    """In this process, after the module's native_jax_route fixture: where
    g++ is on the PATH the JAX package's native library is loaded and the
    port builds its trees natively (both take numpy's route without g++).
    A regression of the parity fixtures fails here, naming the route,
    rather than as parity failures on mismatched trees."""
    tris = _random_tris(300, seed=11)
    j, t = jbvh.build_bvh(*tris), tbvh.build_bvh(*tris)
    native = shutil.which("g++") is not None
    assert (jloader._LIB is not None) == native, \
        f"JAX native library loaded: {jloader._LIB is not None}, g++: {native}"
    assert tbvh.BUILD_ROUTE == ("native" if native else "numpy")
    for f in _BVH_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)


def test_native_route_guard_fails_legibly(monkeypatch):
    """Where g++ exists and the JAX package's library never loads (a
    failed in-place build), the parity fixture fails the test and names
    the numpy route as the cause, after its wait."""
    import jax_native

    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler on this host: the numpy route is taken")
    monkeypatch.setattr(jloader, "_TRIED", jloader._TRIED)
    monkeypatch.setattr(jloader, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native, "WAIT_S", 1.0)
    with pytest.raises(pytest.fail.Exception, match="numpy trees"):
        jax_native.require_native_jax()


def test_native_library_builds_outside_the_sources():
    """The native library is built at first use under kernels/build, keyed
    by a hash of its sources and flags; nothing lands in native/."""
    if tloader.compiler() is None:
        pytest.skip("no C++ compiler on this host: the numpy route is taken")
    lib = tloader.get_lib()
    so = os.path.abspath(lib._name)
    assert os.path.dirname(so) == os.path.abspath(tloader.BUILD_DIR)
    assert os.path.basename(so).startswith("libspcbpt_native-")
    native_dir = os.path.dirname(os.path.abspath(tloader.__file__))
    assert not [f for f in os.listdir(native_dir) if f.endswith(".so")]


def test_failed_native_build_raises(monkeypatch):
    """A compiler that fails is an error, not a silent switch to numpy."""
    if tloader.compiler() is None:
        pytest.skip("no C++ compiler on this host: the numpy route is taken")
    monkeypatch.setattr(tloader, "CXX_FLAGS", ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tloader._build(tloader.compiler())


def test_numpy_route_without_a_compiler():
    """With no g++ on the PATH the BVH and OBJ routes are numpy's, and the
    tree equals build_bvh_numpy's."""
    code = (
        "import numpy as np\n"
        "from spcbpt_tpu_torch.native import loader\n"
        "from spcbpt_tpu_torch.ops import bvh\n"
        "assert loader.compiler() is None and loader.get_lib() is None\n"
        "rs = np.random.RandomState(3)\n"
        "p0, e1, e2 = (rs.normal(size=(300, 3)).astype(np.float32)\n"
        "              for _ in range(3))\n"
        "a, b = bvh.build_bvh(p0, e1, e2), bvh.build_bvh_numpy(p0, e1, e2)\n"
        "assert bvh.BUILD_ROUTE == 'numpy'\n"
        "assert all(np.array_equal(getattr(a, f), getattr(b, f))\n"
        f"           for f in {_BVH_FIELDS!r})\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/nonexistent",
                              "PYTHONPATH": ":".join(sys.path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

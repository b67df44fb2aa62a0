"""The port imports torch and never jax, and nothing of the JAX package:
every module of spcbpt_tpu_torch imports in a fresh interpreter with no jax,
flax or optax loaded, neither the port nor chip_smoke.py names any
spcbpt_tpu module (the port keeps its own copies of the host modules), and
the port builds and traces scenes with every spcbpt_tpu import blocked."""
import ast
import os
import pkgutil
import subprocess
import sys

import spcbpt_tpu_torch

PKG_DIR = os.path.dirname(spcbpt_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
# modules of the JAX package the port may import: none
ALLOWED = set()
FORBIDDEN = ("jax", "flax", "optax")


def _port_modules():
    names = ["spcbpt_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], "spcbpt_tpu_torch."):
        names.append(info.name)
    return sorted(names)


SMOKE = os.path.join(REPO, "chip_smoke.py")


def _sources():
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield SMOKE


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "spcbpt_tpu_torch.ops.ray_walk" in mods
    assert "spcbpt_tpu_torch.apps.render_cli" in mods
    assert "spcbpt_tpu_torch.apps.bench" in mods
    assert "spcbpt_tpu_torch.apps.time_frames" in mods
    # modules present before the port is imported (a site hook may preload
    # some) are not the port's doing
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in set(sys.modules) - before\n"
        f"       if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_names_only_jax_free_host_modules():
    """No module of the port, and not chip_smoke.py, names a spcbpt_tpu
    module: `import M` would need M allowed, `from M import a` M or M.a
    allowed, and nothing is."""
    found = 0
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                pairs = [(a.name, None) for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                pairs = [(node.module, a.name) for a in node.names]
            else:
                continue
            for mod, attr in pairs:
                top = mod.split(".")[0]
                assert top not in FORBIDDEN, f"{path} imports {mod}"
                if top != "spcbpt_tpu":
                    continue
                assert path != SMOKE, f"chip_smoke.py imports {mod}"
                found += 1
                ok = mod in ALLOWED or (attr is not None
                                        and f"{mod}.{attr}" in ALLOWED)
                assert ok, f"{path} imports {mod} {attr or ''}"
    assert found == 0


def test_port_runs_with_the_jax_package_blocked(tmp_path):
    """With a finder that raises on any spcbpt_tpu import, every port module
    and chip_smoke import, the port generates the Cornell box and the
    scale=1 interior, builds both scenes (BVH, clusters, the walk mode) and
    traces rays on the CPU."""
    mods = _port_modules()
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'spcbpt_tpu' or name.startswith('spcbpt_tpu.'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import torch\n"
        "from spcbpt_tpu_torch.render.common import camera_rays\n"
        "from spcbpt_tpu_torch.scene import cornell, interior\n"
        "from spcbpt_tpu_torch.scene.scene import load_trace_scene, "
        "trace_closest, trace_any\n"
        f"root = {str(tmp_path)!r}\n"
        "for path, mode in ((cornell.generate(root), 'brute'),\n"
        "                   (interior.generate(root, scale=1), 'walk')):\n"
        "    ts, _, cam = load_trace_scene(path, 'cpu', mode=mode)\n"
        "    cam.aspect = 1.0\n"
        "    o, d, _ = camera_rays(*cam.uvw(), 8, 8, 0)\n"
        "    hit = trace_closest(ts, o, d, 1e-3, 1e16, False)\n"
        "    assert (hit.tri >= 0).float().mean() > 0.8, mode\n"
        "    occ = trace_any(ts, o, d, 1e-3, 0.5 * hit.t)\n"
        "    assert not occ[hit.tri >= 0].any(), mode\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'spcbpt_tpu']\n"
        "assert not bad, bad\n"
        "try:\n"
        "    import spcbpt_tpu.config\n"
        "    raise AssertionError('the finder let spcbpt_tpu through')\n"
        "except ImportError:\n"
        "    pass\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")

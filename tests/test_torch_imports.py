"""The port imports torch and never jax: every module of spcbpt_tpu_torch
imports in a fresh interpreter with no jax, flax or optax loaded, the only
spcbpt_tpu modules it names are the jax-free host modules, and
chip_smoke.py names none at all (it reaches them through the port)."""
import ast
import os
import pkgutil
import subprocess
import sys

import spcbpt_tpu_torch

PKG_DIR = os.path.dirname(spcbpt_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
# jax-free host modules of the JAX package that the port shares
ALLOWED = {"spcbpt_tpu.config", "spcbpt_tpu.scene.parser",
           "spcbpt_tpu.scene.obj", "spcbpt_tpu.scene.camera",
           "spcbpt_tpu.scene.cornell", "spcbpt_tpu.scene.interior",
           "spcbpt_tpu.scene.hdr", "spcbpt_tpu.ops.bvh",
           "spcbpt_tpu.native.loader"}
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
    """`import M` needs M allowed; `from M import a` needs M allowed (a is
    then an attribute) or M.a allowed (a is a module). chip_smoke.py may
    name no spcbpt_tpu module."""
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
    assert found

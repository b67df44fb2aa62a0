"""Text `.scene` file parser.

The benchmark's plain reference: a frozen copy of
`spcbpt_tpu_torch/scene/parser.py` (what the rendered configurations use;
skies, textures and the close-set network left out), importing
nothing of the program. Float tensors take torch's default dtype,
so that the control runs it in bfloat16.

The port's own copy of spcbpt_tpu/scene/parser.py.

Grammar-compatible with the reference loader (reference:
src/OptiXPathTracer/sceneLoader.cpp:47-308): block keywords `material NAME`,
`light`, `properties`, `cameraSetting`, `mesh`, each followed by `{ key value* }`
lines; `#` comments; Windows-style `\\` path separators tolerated.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MaterialDesc:
    # Parsed fields (sceneLoader.cpp:88-107). NOTE: like the reference's
    # Material_shift (scene_shift.cpp:70-75), only color/metallic/roughness/brdf
    # and the albedo texture actually reach the device material; the other
    # Disney knobs fall back to device defaults (MaterialData.h:40-57).
    name: str = ""
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 0.5
    specularTint: float = 0.0
    roughness: float = 0.5
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheenTint: float = 0.5
    clearcoat: float = 0.0
    clearcoatGloss: float = 1.0
    brdf: int = 0           # "pure brdf" (specular) flag
    albedo_tex: Optional[str] = None


@dataclasses.dataclass
class LightDesc:
    light_type: str = "None"     # Quad | Sphere | Direction | Env
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    normal: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 0.0
    v1: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    v2: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    div_level: int = 1
    # derived for quads (sceneLoader.cpp:160-167): u/v vectors from corners
    u: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    area: float = 0.0


@dataclasses.dataclass
class MeshDesc:
    file: str = ""
    material: str = ""
    uv_file: Optional[str] = None


@dataclasses.dataclass
class SceneDesc:
    materials: Dict[str, MaterialDesc] = dataclasses.field(default_factory=dict)
    lights: List[LightDesc] = dataclasses.field(default_factory=list)
    meshes: List[MeshDesc] = dataclasses.field(default_factory=list)
    width: int = 1920
    height: int = 1001
    eye: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov: float = 35.0
    use_geometry_normal: bool = False
    env_file: str = ""
    env_factor: float = 1.0
    has_camera: bool = False
    root_dir: str = ""

    def has_envmap(self) -> bool:
        return bool(self.env_file)


def _tokens(line: str) -> List[str]:
    line = line.split("#", 1)[0]
    return line.replace("\\", "/").split()


def _read_block(lines, i):
    """Collect key/value token lines until '}' (brace-per-line or trailing)."""
    block = []
    # skip until '{'
    while i < len(lines) and "{" not in lines[i]:
        i += 1
    i += 1
    while i < len(lines) and "}" not in lines[i]:
        t = _tokens(lines[i])
        if t:
            block.append(t)
        i += 1
    return block, i + 1


def load_scene(path: str) -> SceneDesc:
    with open(path, "r", errors="replace") as f:
        raw = f.readlines()
    lines = [ln.rstrip("\n") for ln in raw]
    scene = SceneDesc()
    scene.root_dir = os.path.dirname(os.path.dirname(os.path.abspath(path)))

    i = 0
    while i < len(lines):
        stripped = lines[i].strip()
        if not stripped or stripped.startswith("#"):
            i += 1
            continue
        t = _tokens(lines[i])
        if not t:
            i += 1
            continue
        key = t[0]
        if key == "material" and len(t) >= 2:
            block, i = _read_block(lines, i)
            m = MaterialDesc(name=t[1])
            for b in block:
                k = b[0]
                if k == "color":
                    m.color = tuple(map(float, b[1:4]))
                elif k == "emission":
                    m.emission = tuple(map(float, b[1:4]))
                elif k == "albedoTex":
                    m.albedo_tex = b[1]
                elif k in ("metallic", "subsurface", "specular", "specularTint",
                           "roughness", "anisotropic", "sheen", "sheenTint",
                           "clearcoat", "clearcoatGloss"):
                    setattr(m, k, float(b[1]))
                elif k == "brdf":
                    m.brdf = int(b[1])
            scene.materials[m.name] = m
        elif key == "light":
            block, i = _read_block(lines, i)
            li = LightDesc()
            for b in block:
                k = b[0]
                if k == "position":
                    li.position = tuple(map(float, b[1:4]))
                elif k == "emission":
                    li.emission = tuple(map(float, b[1:4]))
                elif k == "normal":
                    li.normal = tuple(map(float, b[1:4]))
                elif k == "direction":
                    li.direction = tuple(map(float, b[1:4]))
                elif k == "radius":
                    li.radius = float(b[1])
                elif k == "v1":
                    li.v1 = tuple(map(float, b[1:4]))
                elif k == "v2":
                    li.v2 = tuple(map(float, b[1:4]))
                elif k == "type":
                    li.light_type = b[1]
                elif k == "divLevel":
                    li.div_level = int(b[1])
            if li.light_type == "Quad":
                # u/v edge vectors from absolute corner points (sceneLoader.cpp:160-166)
                pos = np.array(li.position, np.float64)
                li.u = np.array(li.v1, np.float64) - pos
                li.v = np.array(li.v2, np.float64) - pos
                n = np.cross(li.u, li.v)
                li.area = float(np.linalg.norm(n))
                li.normal = tuple((n / max(np.linalg.norm(n), 1e-30)).tolist())
            elif li.light_type == "Sphere":
                li.area = 4.0 * np.pi * li.radius * li.radius
            elif li.light_type == "Direction":
                d = np.array(li.direction, np.float64)
                li.direction = tuple((d / max(np.linalg.norm(d), 1e-30)).tolist())
            scene.lights.append(li)
        elif key == "properties":
            block, i = _read_block(lines, i)
            for b in block:
                if b[0] == "width":
                    scene.width = int(b[1])
                elif b[0] == "height":
                    scene.height = int(b[1])
        elif key == "cameraSetting":
            block, i = _read_block(lines, i)
            scene.has_camera = True
            for b in block:
                k = b[0]
                if k == "eye":
                    scene.eye = tuple(map(float, b[1:4]))
                elif k == "lookat":
                    scene.lookat = tuple(map(float, b[1:4]))
                elif k == "up":
                    scene.up = tuple(map(float, b[1:4]))
                elif k == "fov":
                    scene.fov = float(b[1])
                elif k == "geo_normal":
                    scene.use_geometry_normal = bool(int(b[1]))
                elif k == "env_file":
                    scene.env_file = b[1]
                elif k == "env_lum":
                    scene.env_factor = float(b[1])
        elif key == "mesh":
            block, i = _read_block(lines, i)
            mesh = MeshDesc()
            for b in block:
                if b[0] == "file":
                    mesh.file = b[1]
                elif b[0] == "uv_file":
                    mesh.uv_file = b[1]
                elif b[0] == "material":
                    mesh.material = b[1]
            if mesh.file:
                scene.meshes.append(mesh)
        else:
            i += 1
    return scene

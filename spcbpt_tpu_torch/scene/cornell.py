"""Built-in Cornell-box scene generator (benchmark configs 1/2 of BASELINE.md).

The reference repo bundles only the "house" scene; the baseline configs call
for a Cornell box, so we generate the classic one (plus a glossy variant) as
.obj + .scene files compatible with our parser (same grammar as the reference
sceneLoader.cpp).

The port's own copy of spcbpt_tpu/scene/cornell.py: both write the same
bytes to the repo's scenes/, so either package may generate them first.
"""
from __future__ import annotations

import os

_SHORT_BLOCK = [
    # quads (a, b, c, d), outward winding
    [(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)],
    [(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)],
    [(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)],
    [(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)],
    [(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)],
]
_TALL_BLOCK = [
    [(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)],
    [(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)],
    [(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)],
    [(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)],
    [(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)],
]

_X, _Y, _Z = 556.0, 548.8, 559.2


def _wall_quads():
    # (corner, corner+e1, corner+e1+e2, corner+e2) with inward normals
    return {
        "floor": [(0, 0, 0), (0, 0, _Z), (_X, 0, _Z), (_X, 0, 0)],
        "ceiling": [(0, _Y, 0), (_X, _Y, 0), (_X, _Y, _Z), (0, _Y, _Z)],
        "back": [(0, 0, _Z), (0, _Y, _Z), (_X, _Y, _Z), (_X, 0, _Z)],
        "left": [(0, 0, 0), (0, _Y, 0), (0, _Y, _Z), (0, 0, _Z)],
        "right": [(_X, 0, 0), (_X, 0, _Z), (_X, _Y, _Z), (_X, _Y, 0)],
    }


def _write_obj(path, quads):
    lines = []
    vi = 0
    for q in quads:
        for p in q:
            lines.append(f"v {p[0]} {p[1]} {p[2]}")
        lines.append(f"f {vi+1} {vi+2} {vi+3}")
        lines.append(f"f {vi+1} {vi+3} {vi+4}")
        vi += 4
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def generate(root: str, glossy: bool = False) -> str:
    """Write scene files under root/cornell[_glossy]; returns the .scene path."""
    name = "cornell_glossy" if glossy else "cornell"
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    walls = _wall_quads()
    _write_obj(os.path.join(d, "white.obj"),
               [walls["floor"], walls["ceiling"], walls["back"]])
    _write_obj(os.path.join(d, "left.obj"), [walls["left"]])
    _write_obj(os.path.join(d, "right.obj"), [walls["right"]])
    _write_obj(os.path.join(d, "short.obj"), _SHORT_BLOCK)
    _write_obj(os.path.join(d, "tall.obj"), _TALL_BLOCK)

    tall_mat = "Mirror" if glossy else "White"
    scene = f"""
properties
{{
    width 512
    height 512
}}

cameraSetting
{{
    eye 278 273 -800
    lookat 278 273 -799
    up 0 1 0
    fov 39.3
    geo_normal 1
}}

material White
{{
    color 0.725 0.71 0.68
    roughness 0.5
    metallic 0.0
    specular 0.5
}}

material Red
{{
    color 0.63 0.065 0.05
    roughness 0.5
    metallic 0.0
    specular 0.5
}}

material Green
{{
    color 0.14 0.45 0.091
    roughness 0.5
    metallic 0.0
    specular 0.5
}}

material Mirror
{{
    color 0.9 0.9 0.9
    roughness 0.05
    metallic 1.0
    specular 0.5
}}

light
{{
    position 213 548.78 227
    v1 343 548.78 227
    v2 213 548.78 332
    emission 18.4 15.6 8.0
    type Quad
    divLevel 8
}}

mesh
{{
    file {name}/white.obj
    material White
}}

mesh
{{
    file {name}/left.obj
    material Red
}}

mesh
{{
    file {name}/right.obj
    material Green
}}

mesh
{{
    file {name}/short.obj
    material White
}}

mesh
{{
    file {name}/tall.obj
    material {tall_mat}
}}
"""
    path = os.path.join(d, f"{name}.scene")
    with open(path, "w") as f:
        f.write(scene)
    return path


def default_scene_path(repo_root: str = None, glossy: bool = False) -> str:
    """Generate (if needed) and return the bundled cornell scene path."""
    if repo_root is None:
        repo_root = os.path.join(os.path.dirname(__file__), "..", "..")
    root = os.path.abspath(os.path.join(repo_root, "scenes"))
    os.makedirs(root, exist_ok=True)
    name = "cornell_glossy" if glossy else "cornell"
    path = os.path.join(root, name, f"{name}.scene")
    if not os.path.exists(path):
        return generate(root, glossy)
    return path

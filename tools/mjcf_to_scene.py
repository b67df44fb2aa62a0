"""Converts the Franka Kitchen (Gymnasium-Robotics' `kitchen_franka`, the
kitchen of Gupta et al. 2019, "Relay Policy Learning", Apache-2.0) from
MuJoCo's model into this renderer's `.scene` and OBJ files, and writes the
benchmark's configuration file beside them.

    python tools/mjcf_to_scene.py [--out DIR] [--config FILE]

Defaults: `perfbench/scenes/franka_kitchen/` and
`perfbench/configs/franka_kitchen.json`. Needs `mujoco` and
`gymnasium_robotics`; nothing of the renderer imports this file. The same
installed packages give byte-identical files on every run.

What is taken from the model, at keyframe 0 after `mj_forward`:

* every geom of groups 0-2 (those MuJoCo renders by default; the
  collision groups 3-4 are left out): each mesh's own vertices and faces,
  moved by `geom_xpos` / `geom_xmat`; each primitive tessellated at
  `SEGMENTS` around (spheres and capsule ends in `SPHERE_BANDS` and
  `CAP_BANDS` latitude bands, cylinder caps as fans); the plane as 2
  triangles at its half-sizes. No triangle is dropped, merged or moved.
* one OBJ a material: a geom's material, or, where the geom's `rgba` is not
  MuJoCo's default, that material under the geom's `rgba` (MuJoCo's rule);
  a geom without material under its `rgba`.
* materials: `color` = rgba (times the texture's mean linear colour where
  the material is textured), `specular` = MuJoCo `specular`, `roughness`
  = 1 - `shininess`, `metallic` = `reflectance`. Alpha is not rendered.
* lights: each directional light a square quad of side `DIR_SIDE` at
  `DIR_DISTANCE` from the model's centre (`stat.center`) against its
  direction, facing along it, whose irradiance at the scene (small-source
  approximation, E = L A / R^2) is its `diffuse`; the spot light a square
  quad of side `SPOT_SIDE` on its axis, `SPOT_DROP` below the lamp panel
  under its position (the panel would hide it), facing its direction, whose
  on-axis irradiance at the first surface below it (`mj_ray`) is its
  `diffuse`. `divLevel` DIV_LEVEL: four lights' 4 x 7^2 = 196 subspaces
  fit the renderer's 200.
* the camera `left_cap`: its position, the point one unit along its
  view axis (-z of its frame), its frame's y as up, its vertical `fovy`;
  the frame 1920x1000.
* left out: the textures (each textured material takes its mean colour)
  and the skybox (the background is black).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import gymnasium_robotics
import mujoco
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "franka_kitchen"
XML = "envs/assets/kitchen_franka/kitchen_assets/kitchen_env_model.xml"
CAMERA = "left_cap"
WIDTH, HEIGHT = 1920, 1000
GROUPS = (0, 1, 2)
# tessellation of the primitives
SEGMENTS = 32
SPHERE_BANDS = 8
CAP_BANDS = 4
# the lights' quads (metres)
DIR_DISTANCE = 10.0
DIR_SIDE = 1.0
SPOT_SIDE = 0.2
SPOT_DROP = 1e-3
DIV_LEVEL = 7
# MuJoCo's default geom rgba, and its material defaults for a geom with none
DEFAULT_RGBA = (0.5, 0.5, 0.5, 1.0)
NO_MATERIAL = dict(specular=0.5, shininess=0.5, reflectance=0.0)
# the renderer reads textures with this gamma (scene/scene.py)
TEX_GAMMA = 2.2
SOURCE = ("Gymnasium-Robotics 1.4.1 gymnasium_robotics/" + XML
          + " (Franka Kitchen, Gupta et al. 2019), keyframe 0, camera "
          + CAMERA)

NOTICE = """\
The Franka Kitchen: meshes, materials, lights and camera converted by
tools/mjcf_to_scene.py from Gymnasium-Robotics 1.4.1,
gymnasium_robotics/envs/assets/kitchen_franka/ (kitchen_env_model.xml at
keyframe 0, camera left_cap).

Copyright 2020 Google LLC. The Franka arm's assets are modified from
https://github.com/vikashplus/franka (Vikash Kumar).

Licensed under the Apache License, Version 2.0 (the "License"); you may
not use these files except in compliance with the License. You may obtain
a copy of the License at

    https://www.apache.org/licenses/LICENSE-2.0

Unless required by applicable law or agreed to in writing, software
distributed under the License is distributed on an "AS IS" BASIS, WITHOUT
WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied. See the
License for the specific language governing permissions and limitations
under the License.

Changed from the source: the textures are replaced by their mean colours,
the skybox is left out, the lights are replaced by quad lights, and the
primitives are tessellated.
"""


def _fmt(x: float) -> str:
    s = f"{x:.6f}"
    return "0.000000" if s == "-0.000000" else s


def _num(x: float) -> float:
    """A float rounded for the files (6 significant digits)."""
    return float(f"{x:.6g}")


# ---------------------------------------------------------------------------
# tessellation: (vertices (V, 3), faces (F, 3)) in the geom's frame, faces
# counter-clockwise seen from outside
# ---------------------------------------------------------------------------

def lathe(profile):
    """The surface of revolution about z of `profile`, a list of (r, z)
    from the bottom to the top; a point with r = 0 is a pole (one vertex).
    Bands between two rings take 2 SEGMENTS triangles, bands at a pole
    SEGMENTS."""
    n = SEGMENTS
    ang = 2.0 * np.pi * np.arange(n) / n
    verts, rings = [], []
    for r, z in profile:
        if r == 0.0:
            rings.append([len(verts)])
            verts.append((0.0, 0.0, z))
        else:
            rings.append(list(range(len(verts), len(verts) + n)))
            verts.extend((r * np.cos(a), r * np.sin(a), z) for a in ang)
    faces = []
    for lo, hi in zip(rings[:-1], rings[1:]):
        for k in range(n):
            k1 = (k + 1) % n
            if len(lo) == 1:
                faces.append((lo[0], hi[k1], hi[k]))
            elif len(hi) == 1:
                faces.append((lo[k], lo[k1], hi[0]))
            else:
                faces.append((lo[k], lo[k1], hi[k1]))
                faces.append((lo[k], hi[k1], hi[k]))
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _arc(radius, z0, bands, upper):
    """(r, z) of a hemisphere's rings about z0, pole excluded, equator
    included; from the bottom up."""
    th = np.pi / 2 * np.arange(bands) / bands      # from the pole
    pts = [(radius * np.sin(t), z0 - radius * np.cos(t)) for t in th[1:]]
    pts.append((radius, z0))
    if upper:
        pts = [(r, 2 * z0 - z) for r, z in reversed(pts)]
    return pts


def sphere(radius):
    half = SPHERE_BANDS // 2
    prof = [(0.0, -radius)] + _arc(radius, 0.0, half, False)
    prof += _arc(radius, 0.0, half, True)[1:] + [(0.0, radius)]
    return lathe(prof)


def capsule(radius, half_len):
    prof = [(0.0, -half_len - radius)] + _arc(radius, -half_len, CAP_BANDS,
                                              False)
    prof += _arc(radius, half_len, CAP_BANDS, True) + [(0.0,
                                                        half_len + radius)]
    return lathe(prof)


def cylinder(radius, half_len):
    return lathe([(0.0, -half_len), (radius, -half_len), (radius, half_len),
                  (0.0, half_len)])


def box(half):
    hx, hy, hz = half
    v = np.array([[sx * hx, sy * hy, sz * hz] for sz in (-1, 1)
                  for sy in (-1, 1) for sx in (-1, 1)], np.float64)
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3),
             (0, 4, 6, 2), (1, 3, 7, 5)]
    f = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    return v, np.asarray(f, np.int64)


def plane(half):
    hx, hy = half[0], half[1]
    v = np.array([[-hx, -hy, 0], [hx, -hy, 0], [hx, hy, 0], [-hx, hy, 0]],
                 np.float64)
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def load_model():
    path = os.path.join(os.path.dirname(gymnasium_robotics.__file__), XML)
    m = mujoco.MjModel.from_xml_path(path)
    d = mujoco.MjData(m)
    mujoco.mj_resetDataKeyframe(m, d, 0)
    mujoco.mj_forward(m, d)
    return m, d


def geom_shape(m, g):
    """The geom's (vertices, faces) in its own frame."""
    t, size = m.geom_type[g], m.geom_size[g].astype(np.float64)
    gt = mujoco.mjtGeom
    if t == gt.mjGEOM_MESH:
        mid = m.geom_dataid[g]
        va, vn = m.mesh_vertadr[mid], m.mesh_vertnum[mid]
        fa, fn = m.mesh_faceadr[mid], m.mesh_facenum[mid]
        return (m.mesh_vert[va:va + vn].astype(np.float64),
                m.mesh_face[fa:fa + fn].astype(np.int64))
    if t == gt.mjGEOM_SPHERE:
        return sphere(size[0])
    if t == gt.mjGEOM_CAPSULE:
        return capsule(size[0], size[1])
    if t == gt.mjGEOM_CYLINDER:
        return cylinder(size[0], size[1])
    if t == gt.mjGEOM_BOX:
        return box(size)
    if t == gt.mjGEOM_PLANE:
        return plane(size)
    raise ValueError(f"geom {g}: type {t} has no tessellation here")


def _tex_mean(m, tex):
    """The texture's mean linear colour (the renderer's gamma)."""
    a, w, h, c = (m.tex_adr[tex], m.tex_width[tex], m.tex_height[tex],
                  m.tex_nchannel[tex])
    px = m.tex_data[a:a + w * h * c].reshape(-1, c)[:, :3]
    lin = np.power(px.astype(np.float64) / 255.0, TEX_GAMMA)
    return lin.mean(axis=0)


def _rgba_tag(rgba):
    return "rgba_" + "_".join(f"{x:.3g}" for x in rgba[:3])


def look(m, g):
    """(name, material dict) of geom g's look."""
    rgba = tuple(float(x) for x in m.geom_rgba[g])
    mat = m.geom_matid[g]
    if mat < 0:
        return _rgba_tag(rgba), dict(rgba=rgba, tex=None, **NO_MATERIAL)
    name = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_MATERIAL, mat)
    tex = int(max(m.mat_texid[mat]))
    desc = dict(rgba=tuple(float(x) for x in m.mat_rgba[mat]),
                tex=tex if tex >= 0 else None,
                specular=float(m.mat_specular[mat]),
                shininess=float(m.mat_shininess[mat]),
                reflectance=float(m.mat_reflectance[mat]))
    if not np.allclose(rgba, DEFAULT_RGBA):
        name, desc["rgba"] = f"{name}__{_rgba_tag(rgba)}", rgba
    return name, desc


def _axes(n):
    """Two unit vectors u, v with cross(u, v) = n (unit)."""
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else \
        np.array([0.0, 1.0, 0.0])
    u = np.cross(a, n)
    u /= np.linalg.norm(u)
    return u, np.cross(n, u)


def quad(centre, normal, side):
    """(corner, v1, v2): a square of `side` about `centre` whose
    normalize(cross(v1 - corner, v2 - corner)) is `normal`."""
    u, v = _axes(normal)
    corner = centre - 0.5 * side * (u + v)
    return corner, corner + side * u, corner + side * v


def _ray(m, d, p, dirn) -> tuple:
    """(distance, geom) of the first geom of GROUPS on the ray."""
    groups = np.array([int(k in GROUPS) for k in range(6)], np.uint8)
    gid = np.zeros(1, np.int32)
    dist = mujoco.mj_ray(m, d, p, dirn, groups, 1, -1, gid)
    return float(dist), int(gid[0])


def lights(m, d):
    """The quad lights: [(corner, v1, v2, emission, what)]."""
    out = []
    for i in range(m.nlight):
        pos = d.light_xpos[i].astype(np.float64)
        dirn = d.light_xdir[i].astype(np.float64)
        dirn /= np.linalg.norm(dirn)
        diffuse = m.light_diffuse[i].astype(np.float64)
        if m.light_type[i] == mujoco.mjtLightType.mjLIGHT_DIRECTIONAL:
            centre = m.stat.center - DIR_DISTANCE * dirn
            side, dist = DIR_SIDE, DIR_DISTANCE
            what = (f"directional light {i} (dir {np.round(dirn, 4).tolist()}"
                    f", diffuse {np.round(diffuse, 4).tolist()})")
        else:
            # the light sits above its lamp's panel: its quad goes 1 mm
            # below the panel's underside, on its axis
            near, g = _ray(m, d, pos, dirn)
            exit_, g2 = _ray(m, d, pos + (near + 1e-4) * dirn, dirn)
            assert g2 == g, "the spot's axis does not leave its lamp panel"
            centre = pos + (near + 1e-4 + exit_ + SPOT_DROP) * dirn
            dist, _ = _ray(m, d, centre, dirn)
            side = SPOT_SIDE
            what = (f"spot light {i} (pos {np.round(pos, 4).tolist()}, dir "
                    f"{np.round(dirn, 4).tolist()}, diffuse "
                    f"{np.round(diffuse, 4).tolist()}; quad "
                    f"{_num(near + 1e-4 + exit_ + SPOT_DROP)} m along its "
                    f"axis, below its lamp panel; first surface below it at "
                    f"{_num(dist)} m)")
        radiance = diffuse * dist * dist / (side * side)
        out.append((*quad(centre, dirn, side), radiance, what))
    return out


def camera(m, d):
    c = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_CAMERA, CAMERA)
    eye = d.cam_xpos[c].astype(np.float64)
    rot = d.cam_xmat[c].reshape(3, 3).astype(np.float64)
    return eye, eye - rot[:, 2], rot[:, 1], float(m.cam_fovy[c])


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------

def convert(m, d):
    """{file name: text} of the scene, and the summary for the
    configuration."""
    looks, meshes, counts = {}, {}, {}
    for g in range(m.ngeom):
        if m.geom_group[g] not in GROUPS:
            continue
        name, desc = look(m, g)
        looks.setdefault(name, desc)
        v, f = geom_shape(m, g)
        world = v @ d.geom_xmat[g].reshape(3, 3).astype(np.float64).T \
            + d.geom_xpos[g].astype(np.float64)
        meshes.setdefault(name, []).append((world, f))
        kind = mujoco.mjtGeom(m.geom_type[g]).name[len("mjGEOM_"):].lower()
        counts[kind] = counts.get(kind, 0) + len(f)

    files, n_tris = {}, 0
    for name, parts in meshes.items():
        lines, base = [f"# {name}: {len(parts)} geoms\n"], 1
        for world, f in parts:
            lines += [f"v {_fmt(x)} {_fmt(y)} {_fmt(z)}\n"
                      for x, y, z in world]
            lines += [f"f {a + base} {b + base} {c + base}\n"
                      for a, b, c in f]
            base += len(world)
            n_tris += len(f)
        files[f"{name}.obj"] = "".join(lines)

    sc = ["# The Franka Kitchen (Gymnasium-Robotics kitchen_franka), written "
          "by tools/mjcf_to_scene.py\n\n",
          f"properties\n{{\n    width {WIDTH}\n    height {HEIGHT}\n}}\n\n"]
    eye, lookat, up, fovy = camera(m, d)
    vec = lambda a: " ".join(_fmt(x) for x in a)
    sc.append(f"cameraSetting\n{{\n    eye {vec(eye)}\n    lookat "
              f"{vec(lookat)}\n    up {vec(up)}\n    fov {_num(fovy)}\n"
              f"    geo_normal 1\n}}\n\n")
    for name, desc in looks.items():
        col = np.asarray(desc["rgba"][:3], np.float64)
        if desc["tex"] is not None:
            col = col * _tex_mean(m, desc["tex"])
        sc.append(f"material {name}\n{{\n    color "
                  f"{' '.join(str(_num(x)) for x in col)}\n    roughness "
                  f"{_num(1.0 - desc['shininess'])}\n    metallic "
                  f"{_num(desc['reflectance'])}\n    specular "
                  f"{_num(desc['specular'])}\n}}\n\n")
    quads = lights(m, d)
    for corner, v1, v2, radiance, _ in quads:
        sc.append(f"light\n{{\n    position {vec(corner)}\n    v1 {vec(v1)}"
                  f"\n    v2 {vec(v2)}\n    emission "
                  f"{' '.join(str(_num(x)) for x in radiance)}\n    type Quad"
                  f"\n    divLevel {DIV_LEVEL}\n}}\n\n")
    for name in meshes:
        sc.append(f"mesh\n{{\n    file {NAME}/{name}.obj\n    material "
                  f"{name}\n}}\n\n")
    files[f"{NAME}.scene"] = "".join(sc).rstrip("\n") + "\n"
    files["NOTICE.txt"] = NOTICE
    summary = dict(geoms=counts, triangles=n_tris,
                   lights=[(what, [_num(x) for x in rad])
                           for *_, rad, what in quads])
    return files, summary


def walk_parts(scene_file: str) -> tuple:
    """(triangles with the lights' quads, walk parts) of the scene as the
    renderer loads it on the CPU in walk mode."""
    sys.path.insert(0, ROOT)
    from spcbpt_tpu_torch.scene.scene import load_trace_scene

    ts, _, _ = load_trace_scene(scene_file, "cpu", mode="walk")
    cw = ts.clusters_walk
    return ts.num_tris, len(getattr(cw, "parts", [cw]))


def config(summary: dict, triangles: int, parts: int) -> dict:
    """The benchmark's configuration file of the scene."""
    return {
        "name": NAME,
        "source": SOURCE,
        "scene": {"file": f"perfbench/scenes/{NAME}/{NAME}.scene"},
        "image": [WIDTH, HEIGHT],
        "triangles": triangles,
        "traversal": f"walk, {parts} parts",
        "precision": "float32",
        "lighting": ("three distant quads for the three directional lights "
                     "and one quad for the oven's spot light; no sky"),
        "reduced": ["textures", "skybox"],
        "geometry": {
            "groups": list(GROUPS),
            "triangles_by_geom_type": summary["geoms"],
            "light_triangles": triangles - summary["triangles"],
        },
        "assumed": {
            "tessellation": (f"spheres {SEGMENTS} segments x {SPHERE_BANDS} "
                             f"bands, capsules {SEGMENTS} x {CAP_BANDS} bands "
                             f"an end, cylinders {SEGMENTS} segments with "
                             "fan caps, boxes 12 triangles, the plane 2 at its"
                             " half-sizes; mesh triangles as MuJoCo loads "
                             "them"),
            "normals": "geometric (flat) on every triangle (geo_normal 1)",
            "textures": ("each textured material's color is its texture's "
                         f"mean linear colour (gamma {TEX_GAMMA}) times its "
                         "rgba"),
            "skybox": "left out: the background is black",
            "materials": ("color = rgba, specular = specular, roughness = 1 -"
                          " shininess, metallic = reflectance; alpha not "
                          "rendered; a geom's non-default rgba overrides its "
                          "material's (MuJoCo's rule)"),
            "directional_lights": (
                f"a {DIR_SIDE} m square quad each, {DIR_DISTANCE} m from "
                "stat.center against the light's direction and facing along "
                "it, radiance diffuse * R^2 / A so that its irradiance at the "
                "scene is its diffuse 0.3 (small-source approximation)"),
            "spot_light": (
                f"a {SPOT_SIDE} m square quad on the light's axis, "
                f"{SPOT_DROP * 1e3:g} mm below the underside of the lamp "
                "panel under its published position (the panel would hide "
                "it there), facing its direction, radiance diffuse * d^2 / A"
                " so that its on-axis irradiance at the first surface below "
                "it (d, mj_ray) is its diffuse; MuJoCo's cutoff and "
                "attenuation are not modelled"),
            "headlight": "MuJoCo's camera headlight is left out",
            "divLevel": (f"{DIV_LEVEL} on each of the four lights: "
                         f"4 x {DIV_LEVEL}^2 = {4 * DIV_LEVEL ** 2} of the "
                         "200 light-source subspaces"),
            "lights": [{"what": w, "emission": e}
                       for w, e in summary["lights"]],
        },
    }


def write(out_dir: str, config_file: str) -> dict:
    """Writes the scene's files into out_dir and the configuration into
    config_file; returns the configuration."""
    m, d = load_model()
    files, summary = convert(m, d)
    os.makedirs(out_dir, exist_ok=True)
    for name, text in files.items():
        with open(os.path.join(out_dir, name), "w", newline="\n") as f:
            f.write(text)
    scene_file = os.path.join(out_dir, f"{NAME}.scene")
    triangles, parts = walk_parts(scene_file)
    cfg = config(summary, triangles, parts)
    with open(config_file, "w", newline="\n") as f:
        f.write(json.dumps(cfg, indent=2) + "\n")
    return cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join(
        ROOT, "perfbench", "scenes", NAME))
    p.add_argument("--config", default=os.path.join(
        ROOT, "perfbench", "configs", f"{NAME}.json"))
    args = p.parse_args(argv)
    cfg = write(args.out, args.config)
    print(f"{cfg['triangles']} triangles, traversal {cfg['traversal']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

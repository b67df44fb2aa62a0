"""The plain reference's scene: the scene files assembled in numpy as the
program assembles them, traced by brute force over every triangle.

A frozen copy of the assembly of `spcbpt_tpu_torch/scene/scene.py`
(`build_scene`: material table, quad lights and their two triangles, the
uniform unit normalisation, geometric normals), without what the program
adds for speed: no BVH order, no cluster sets, no traversal mode. The
triangles stay in file order. Textures and skies are refused: no
configuration of the benchmark has them, and the reference does not carry
their code. Every float tensor takes torch's default dtype, so the control
(`perfbench/harness/check.py`) renders the same scene in bfloat16.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import intersect, vec
from . import obj as obj_mod
from .camera import Camera
from .consts import NUM_SUBSPACE_LIGHTSOURCE
from .parser import MaterialDesc, SceneDesc, load_scene

TARGET_DIAG = 10.0
# rays and triangles of one brute-force block
RAY_BLOCK = 16384
TRI_CHUNK = 1024


@dataclasses.dataclass
class Materials:
    base_color: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    subsurface: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    brdf: torch.Tensor
    tex_id: torch.Tensor


@dataclasses.dataclass
class QuadLights:
    corner: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    normal: torch.Tensor
    emission: torch.Tensor
    area: torch.Tensor
    ss_base: torch.Tensor
    div_level: torch.Tensor


@dataclasses.dataclass
class TraceScene:
    tri_p0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n: torch.Tensor
    tri_uv: torch.Tensor
    tri_mat: torch.Tensor
    tri_light: torch.Tensor
    mats: Materials
    lights: QuadLights
    num_lights: int = 0
    num_quad_lights: int = 0
    has_env: bool = False
    world_scale: float = 1.0

    @property
    def num_tris(self) -> int:
        return self.tri_p0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_p0.device


def _tensors_of(cls, arrays: dict, device):
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(arrays[f.name])
        dt = (torch.bool if a.dtype == bool else
              torch.int32 if np.issubdtype(a.dtype, np.integer) else
              torch.get_default_dtype())
        out[f.name] = torch.tensor(a, dtype=dt, device=device)
    return cls(**out)


def _quad_light_tris(corner, u, v):
    return [(corner, u, v), (corner + u + v, -u, -v)]


def build_scene(desc: SceneDesc, device) -> TraceScene:
    data_dir = desc.root_dir
    if desc.has_envmap():
        raise NotImplementedError("the plain reference has no sky")
    mat_names = list(desc.materials.keys())
    mat_index = {n: i for i, n in enumerate(mat_names)}
    if not mat_names:
        mat_names = ["default"]
        mat_index = {"default": 0}
        desc.materials["default"] = MaterialDesc(name="default",
                                                 color=(0.8, 0.8, 0.8))
    if any(desc.materials[n].albedo_tex for n in mat_names):
        raise NotImplementedError("the plain reference has no textures")

    M = len(mat_names)
    mats = dict(
        base_color=np.zeros((M, 3), np.float32),
        metallic=np.zeros(M, np.float32),
        roughness=np.zeros(M, np.float32),
        specular=np.full(M, 0.5, np.float32),
        specular_tint=np.zeros(M, np.float32),
        subsurface=np.zeros(M, np.float32),
        anisotropic=np.zeros(M, np.float32),
        sheen=np.zeros(M, np.float32),
        sheen_tint=np.full(M, 0.5, np.float32),
        clearcoat=np.zeros(M, np.float32),
        clearcoat_gloss=np.ones(M, np.float32),
        brdf=np.zeros(M, bool),
        tex_id=np.full(M, -1, np.int32),
    )
    for n in mat_names:
        i = mat_index[n]
        m = desc.materials[n]
        mats["base_color"][i] = m.color
        mats["metallic"][i] = m.metallic
        mats["roughness"][i] = m.roughness
        mats["brdf"][i] = bool(m.brdf)

    pos_l, n_l, uv_l, matid_l, light_l = [], [], [], [], []
    for mesh in desc.meshes:
        path = os.path.join(data_dir, mesh.file)
        if not os.path.exists(path):
            continue
        md = obj_mod.load_obj(path)
        t = len(md.positions)
        if t == 0:
            continue
        pos_l.append(md.positions)
        n_l.append(md.normals)
        uv_l.append(md.uvs)
        matid_l.append(np.full(t, mat_index.get(mesh.material, 0), np.int32))
        light_l.append(np.full(t, -1, np.int32))

    quads = [l for l in desc.lights if l.light_type == "Quad"]
    L = len(quads)
    lights = dict(
        corner=np.zeros((max(L, 1), 3), np.float32),
        u=np.zeros((max(L, 1), 3), np.float32),
        v=np.zeros((max(L, 1), 3), np.float32),
        normal=np.zeros((max(L, 1), 3), np.float32),
        emission=np.zeros((max(L, 1), 3), np.float32),
        area=np.ones(max(L, 1), np.float32),
        ss_base=np.zeros(max(L, 1), np.int32),
        div_level=np.ones(max(L, 1), np.int32),
    )
    ss_base_run = 0
    for i, l in enumerate(quads):
        corner = np.asarray(l.position, np.float32)
        uvec = np.asarray(l.u, np.float32)
        vvec = np.asarray(l.v, np.float32)
        lights["corner"][i] = corner
        lights["u"][i] = uvec
        lights["v"][i] = vvec
        lights["normal"][i] = l.normal
        lights["emission"][i] = l.emission
        lights["area"][i] = l.area
        lights["ss_base"][i] = ss_base_run
        lights["div_level"][i] = l.div_level
        ss_base_run += l.div_level * l.div_level
        tris = _quad_light_tris(corner, uvec, vvec)
        pos = np.stack([[p0, p0 + e1, p0 + e2] for p0, e1, e2 in tris])
        pos_l.append(pos.astype(np.float32))
        n_l.append(np.tile(np.asarray(l.normal, np.float32), (2, 3, 1)))
        uv_l.append(np.array([[[0, 0], [1, 0], [0, 1]],
                              [[1, 1], [0, 1], [1, 0]]], np.float32))
        matid_l.append(np.zeros(2, np.int32))
        light_l.append(np.full(2, i, np.int32))
    if ss_base_run > NUM_SUBSPACE_LIGHTSOURCE:
        raise ValueError("the lights' subspace blocks overflow their share")

    positions = np.concatenate(pos_l)
    world_scale = 1.0
    lo0 = positions.reshape(-1, 3).min(axis=0)
    hi0 = positions.reshape(-1, 3).max(axis=0)
    diag0 = float(np.linalg.norm(hi0 - lo0))
    if diag0 > 0:
        world_scale = TARGET_DIAG / diag0
        positions = positions * world_scale
        lights["corner"][:] = lights["corner"] * world_scale
        lights["u"][:] = lights["u"] * world_scale
        lights["v"][:] = lights["v"] * world_scale
        lights["area"][:] = lights["area"] * (world_scale * world_scale)
    normals = np.concatenate(n_l)
    uvs = np.concatenate(uv_l)
    mat_ids = np.concatenate(matid_l)
    light_ids = np.concatenate(light_l)

    if desc.use_geometry_normal:
        e1 = positions[:, 1] - positions[:, 0]
        e2 = positions[:, 2] - positions[:, 0]
        gn = np.cross(e1, e2)
        gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-30)
        keep = light_ids >= 0
        normals = np.where(keep[:, None, None], normals,
                           np.repeat(gn[:, None, :], 3, axis=1))

    p0 = positions[:, 0]
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]

    def dev(x, dt=None):
        return torch.tensor(np.asarray(x), dtype=dt or
                            torch.get_default_dtype(), device=device)

    return TraceScene(
        tri_p0=dev(p0), tri_e1=dev(e1), tri_e2=dev(e2), tri_n=dev(normals),
        tri_uv=dev(uvs), tri_mat=dev(mat_ids, torch.int32),
        tri_light=dev(light_ids, torch.int32),
        mats=_tensors_of(Materials, mats, device),
        lights=_tensors_of(QuadLights, lights, device),
        num_lights=L, num_quad_lights=L, world_scale=float(world_scale))


def load_trace_scene(scene_path: str, device):
    """(TraceScene, SceneDesc, Camera), the camera in the normalised units."""
    desc = load_scene(scene_path)
    ts = build_scene(desc, device)
    s = ts.world_scale
    cam = Camera(eye=np.asarray(desc.eye) * s,
                 lookat=np.asarray(desc.lookat) * s,
                 up=np.asarray(desc.up), fov_y=desc.fov,
                 aspect=desc.width / desc.height)
    return ts, desc, cam


# ---------------------------------------------------------------------------
# tracing: every triangle against every ray whose interval is not empty
# ---------------------------------------------------------------------------

def _lanes(x, n, like):
    if torch.is_tensor(x) and x.dim() == 1:
        return x.to(like.dtype)
    return torch.full((n,), float(x), dtype=like.dtype, device=like.device)


def trace_closest(ts: TraceScene, origins, dirs, tmin, tmax,
                  cull_backface: bool = True) -> intersect.Hit:
    n = origins.shape[0]
    tmin = _lanes(tmin, n, origins)
    tmax = _lanes(tmax, n, origins)
    dev = origins.device
    hit = intersect.Hit(t=torch.full((n,), intersect._BIG, device=dev),
                        tri=torch.full((n,), -1, dtype=torch.int32,
                                       device=dev),
                        u=torch.zeros((n,), device=dev),
                        v=torch.zeros((n,), device=dev))
    live = torch.nonzero(tmax > tmin).flatten()
    for b in range(0, live.shape[0], RAY_BLOCK):
        idx = live[b:b + RAY_BLOCK]
        h = intersect.brute_force_closest(
            origins[idx], dirs[idx], ts.tri_p0, ts.tri_e1, ts.tri_e2,
            tmin[idx], tmax[idx], cull_backface, chunk=TRI_CHUNK)
        hit.t[idx] = h.t
        hit.tri[idx] = h.tri
        hit.u[idx] = h.u
        hit.v[idx] = h.v
    return hit


def trace_any(ts: TraceScene, origins, dirs, tmin, tmax):
    n = origins.shape[0]
    tmin = _lanes(tmin, n, origins)
    tmax = _lanes(tmax, n, origins)
    occ = torch.zeros((n,), dtype=torch.bool, device=origins.device)
    live = torch.nonzero(tmax > tmin).flatten()
    for b in range(0, live.shape[0], RAY_BLOCK):
        idx = live[b:b + RAY_BLOCK]
        occ[idx] = intersect.brute_force_any(
            origins[idx], dirs[idx], ts.tri_p0, ts.tri_e1, ts.tri_e2,
            tmin[idx], tmax[idx], chunk=TRI_CHUNK)
    return occ


def visibility(ts: TraceScene, pos_a, pos_b, eps: float = 1e-3, mask=None):
    """True where the segment a->b is unoccluded; lanes where mask is False
    are not traced."""
    d = pos_b - pos_a
    dist = torch.sqrt(torch.clamp(vec.dot(d, d), min=1e-30))
    dirs = d / dist[..., None]
    tmax = dist - eps
    if mask is not None:
        tmax = torch.where(mask, tmax, -1.0)
    occ = trace_any(ts, pos_a, dirs, torch.full_like(dist, eps), tmax)
    return ~occ


def local_geometry(ts: TraceScene, hit: intersect.Hit, origins, dirs):
    """Per-hit shading data: P, Ns (flipped toward -dir), Ng, uv, mat_id,
    light_id, base_color."""
    tri = torch.clamp(hit.tri, min=0).long()
    p0 = ts.tri_p0[tri]
    e1 = ts.tri_e1[tri]
    e2 = ts.tri_e2[tri]
    u = hit.u[..., None]
    v = hit.v[..., None]
    P = p0 + u * e1 + v * e2
    n = ts.tri_n[tri]
    Ns = n[..., 0, :] * (1 - u - v) + n[..., 1, :] * u + n[..., 2, :] * v
    Ns = Ns / torch.clamp(vec.length(Ns), min=1e-20)[..., None]
    Ng = vec.cross(e1, e2)
    Ng = Ng / torch.clamp(vec.length(Ng), min=1e-20)[..., None]
    facing = vec.dot(Ns, dirs) <= 0.0
    Ns = torch.where(facing[..., None], Ns, -Ns)
    uvs = ts.tri_uv[tri]
    uv = uvs[..., 0, :] * (1 - u - v) + uvs[..., 1, :] * u + uvs[..., 2, :] * v
    mat_id = ts.tri_mat[tri]
    light_id = ts.tri_light[tri]
    base = ts.mats.base_color[mat_id.long()]
    return dict(P=P, Ns=Ns, Ng=Ng, uv=uv, mat_id=mat_id, light_id=light_id,
                base_color=base)

"""Scene assembly: parsed description -> device tensors + trace API.

Port of spcbpt_tpu/scene/scene.py. `build_scene` assembles the scene in
numpy exactly as the JAX package does (triangle order, material table,
quad lights, texture stack, cluster packing) and places the result on a
given device; `from_jax_scene` carries a JAX TraceScene over, array by
array. Traversal modes: `brute` (ops/brute_trace, kernel K3 on the
card) and `walk` (ops/ray_walk, kernels K1/K2 on the card); the `bvh` and
`tile` modes and environment maps are not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from spcbpt_tpu.ops import bvh as bvh_mod
from spcbpt_tpu.scene import obj as obj_mod
from spcbpt_tpu.scene.camera import Camera
from spcbpt_tpu.scene.parser import MaterialDesc, SceneDesc, load_scene

from ..ops import clusters as clusters_mod
from ..ops import brute_trace, intersect, ray_walk
from ..utils import vec

# Textures are kept at native resolution in one (NT, Hmax, Wmax, 3) stack;
# only textures whose longest edge exceeds TEX_MAX are area-downsampled.
TEX_MAX = 2048
# Traversal-mode selection: brute force over every triangle up to these
# sizes, the row walk above them.
BRUTE_FORCE_MAX_TRIS_CPU = 1024
BRUTE_FORCE_MAX_TRIS_CUDA = 512
TARGET_DIAG = 10.0  # normalized scene bbox diagonal (house-like units)


def _tensors_of(cls, arrays: dict, device) -> object:
    """Dataclass `cls` of tensors on `device` from a dict of numpy arrays
    (int arrays -> int32, bool -> bool, the rest float32)."""
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(arrays[f.name])
        dt = (torch.bool if a.dtype == bool else
              torch.int32 if np.issubdtype(a.dtype, np.integer) else
              torch.float32)
        out[f.name] = torch.tensor(a, dtype=dt, device=device)
    return cls(**out)


@dataclasses.dataclass
class Materials:
    """Disney BSDF parameter table (reference cuda/MaterialData.h:82-101)."""
    base_color: torch.Tensor     # (M, 3)
    metallic: torch.Tensor       # (M,)
    roughness: torch.Tensor      # (M,)
    specular: torch.Tensor
    specular_tint: torch.Tensor
    subsurface: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    brdf: torch.Tensor           # (M,) bool "pure specular" flag
    tex_id: torch.Tensor         # (M,) int32, -1 = no albedo texture


@dataclasses.dataclass
class QuadLights:
    """Quad area lights (reference cuda/Light.h:31-92)."""
    corner: torch.Tensor      # (L, 3)
    u: torch.Tensor           # (L, 3) edge vector
    v: torch.Tensor           # (L, 3) edge vector
    normal: torch.Tensor      # (L, 3) = normalize(cross(u, v))
    emission: torch.Tensor    # (L, 3)
    area: torch.Tensor        # (L,) = |cross(u, v)|
    ss_base: torch.Tensor     # (L,) int32 subspace block base
    div_level: torch.Tensor   # (L,) int32


@dataclasses.dataclass
class TraceScene:
    # geometry (SoA, includes emissive light quads), BVH-reordered
    tri_p0: torch.Tensor      # (T, 3)
    tri_e1: torch.Tensor      # (T, 3)
    tri_e2: torch.Tensor      # (T, 3)
    tri_n: torch.Tensor       # (T, 3, 3) shading normals per corner
    tri_uv: torch.Tensor      # (T, 3, 2)
    tri_mat: torch.Tensor     # (T,) int32
    tri_light: torch.Tensor   # (T,) int32 light id for emitter tris, else -1
    mats: Materials
    textures: torch.Tensor    # (NT, Hmax, Wmax, 3) linear albedo, zero-padded
    tex_h: torch.Tensor       # (NT,) int32 native extent in the stack
    tex_w: torch.Tensor       # (NT,) int32
    lights: QuadLights
    # K=128 cluster set of the row walk (mode "walk"; None otherwise)
    clusters_walk: Optional[clusters_mod.ClusterSet] = None
    num_lights: int = 0
    num_quad_lights: int = 0
    has_env: bool = False
    mode: str = "brute"
    # uniform scene-unit scale applied at build (radiance-invariant)
    world_scale: float = 1.0

    @property
    def num_tris(self) -> int:
        return self.tri_p0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_p0.device


# ---------------------------------------------------------------------------
# tracing entry points (the two "ray types" of optixPathTracer.h:202-209)
# ---------------------------------------------------------------------------

def _lanes(x, n, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n)


# The walk always sorts its rays by coherence key, the JAX package's default;
# no caller with presorted rays is ported yet.


def trace_closest(ts: TraceScene, origins, dirs, tmin, tmax,
                  cull_backface: bool = True) -> intersect.Hit:
    n = origins.shape[0]
    tmin = _lanes(tmin, n, origins.device)
    tmax = _lanes(tmax, n, origins.device)
    if ts.mode == "brute":
        return brute_trace.brute_closest(origins, dirs, tmin, tmax, ts.tri_p0,
                                         ts.tri_e1, ts.tri_e2, cull_backface)
    return ray_walk.walk_closest(ts.clusters_walk, origins, dirs, tmin, tmax,
                                 cull_backface, sort_rays=True)


def trace_any(ts: TraceScene, origins, dirs, tmin, tmax):
    n = origins.shape[0]
    tmin = _lanes(tmin, n, origins.device)
    tmax = _lanes(tmax, n, origins.device)
    if ts.mode == "brute":
        return brute_trace.brute_any(origins, dirs, tmin, tmax, ts.tri_p0,
                                     ts.tri_e1, ts.tri_e2)
    return ray_walk.walk_any(ts.clusters_walk, origins, dirs, tmin, tmax,
                             sort_rays=True)


def visibility(ts: TraceScene, pos_a, pos_b, eps: float = 1e-3, mask=None):
    """True if the segment a->b is unoccluded (reference visibilityTest,
    cuProg.h:463-487).

    mask (optional, bool (N,)): lanes where mask is False are not traced —
    their tmax is set below tmin so the walk skips them (the dead-lane
    convention of ops/ray_walk._pad); their returned value is unspecified."""
    d = pos_b - pos_a
    dist = torch.sqrt(torch.clamp(vec.dot(d, d), min=1e-30))
    dirs = d / dist[..., None]
    tmax = dist - eps
    if mask is not None:
        tmax = torch.where(mask, tmax, -1.0)
    occ = trace_any(ts, pos_a, dirs, torch.full_like(dist, eps), tmax)
    return ~occ


# ---------------------------------------------------------------------------
# hit shading data (reference cuda/LocalGeometry.h + ColorTexSample)
# ---------------------------------------------------------------------------

def sample_albedo(ts: TraceScene, tex_id, uv):
    """Bilinear, wrap-mode albedo fetch from the texture stack; returns
    linear-space rgb. tex_id < 0 lanes return 1 (multiplied away by caller)."""
    nt = ts.textures.shape[0]
    tid = torch.clamp(tex_id, 0, nt - 1).long()
    hi = ts.tex_h[tid]
    wi = ts.tex_w[tid]
    fu = uv[..., 0] * wi.to(torch.float32) - 0.5
    fv = uv[..., 1] * hi.to(torch.float32) - 0.5
    x0 = torch.floor(fu)
    y0 = torch.floor(fv)
    du = (fu - x0)[..., None]
    dv = (fv - y0)[..., None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)

    def fetch(xi, yi):
        return ts.textures[tid, torch.remainder(yi, hi).long(),
                           torch.remainder(xi, wi).long()]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    c = (c00 * (1 - du) * (1 - dv) + c10 * du * (1 - dv)
         + c01 * (1 - du) * dv + c11 * du * dv)
    return torch.where((tex_id >= 0)[..., None], c, torch.ones_like(c))


def local_geometry(ts: TraceScene, hit: intersect.Hit, origins, dirs):
    """Gather per-hit shading data. Returns a dict of SoA tensors:
    P, Ns (shading normal flipped toward -dir), Ng, uv, mat_id, light_id,
    base_color (texture-modulated, linear)."""
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
    # flip shading normal toward the incoming side (hit_program.cu:258-259)
    facing = vec.dot(Ns, dirs) <= 0.0
    Ns = torch.where(facing[..., None], Ns, -Ns)
    uvs = ts.tri_uv[tri]
    uv = uvs[..., 0, :] * (1 - u - v) + uvs[..., 1, :] * u + uvs[..., 2, :] * v
    mat_id = ts.tri_mat[tri]
    light_id = ts.tri_light[tri]
    mid = mat_id.long()
    base = ts.mats.base_color[mid]
    tex_id = ts.mats.tex_id[mid]
    base = base * sample_albedo(ts, tex_id, uv)
    return dict(P=P, Ns=Ns, Ng=Ng, uv=uv, mat_id=mat_id, light_id=light_id,
                base_color=base)


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------

def _quad_light_tris(corner, u, v):
    """Two CCW triangles whose geometric normal is normalize(cross(u,v))."""
    return [(corner, u, v), (corner + u + v, -u, -v)]


def _load_textures(tex_paths, data_dir):
    """Linear-space texture stack (NT, Hmax, Wmax, 3) + per-texture (h, w)."""
    textures = np.ones((max(len(tex_paths), 1), 1, 1, 3), np.float32)
    tex_hw = np.ones((max(len(tex_paths), 1), 2), np.int32)
    if not tex_paths:
        return textures, tex_hw
    import cv2
    texs = []
    for p in tex_paths:
        img = cv2.imread(os.path.join(data_dir, p), cv2.IMREAD_COLOR)
        if img is None:
            img = np.full((4, 4, 3), 255, np.uint8)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        if max(h, w) > TEX_MAX:
            s = TEX_MAX / max(h, w)
            img = cv2.resize(img, (max(1, round(w * s)), max(1, round(h * s))),
                             interpolation=cv2.INTER_AREA)
        texs.append(np.power(img.astype(np.float32) / 255.0, 2.2))
    hmax = max(t.shape[0] for t in texs)
    wmax = max(t.shape[1] for t in texs)
    textures = np.zeros((len(texs), hmax, wmax, 3), np.float32)
    tex_hw = np.ones((len(texs), 2), np.int32)
    for i, t in enumerate(texs):
        textures[i, :t.shape[0], :t.shape[1]] = t
        tex_hw[i] = t.shape[:2]
    return textures, tex_hw


def select_mode(num_tris: int, device) -> str:
    """brute up to 512 triangles on the card and 1024 on the CPU, the row
    walk above."""
    limit = (BRUTE_FORCE_MAX_TRIS_CPU if torch.device(device).type == "cpu"
             else BRUTE_FORCE_MAX_TRIS_CUDA)
    return "brute" if num_tris <= limit else "walk"


def _check_mode(mode: str) -> None:
    if mode not in ("brute", "walk"):
        raise NotImplementedError(f"traversal mode '{mode}' is not ported yet")


def build_scene(desc: SceneDesc, device, data_dir: Optional[str] = None,
                mode: Optional[str] = None,
                normalize_units: bool = True) -> TraceScene:
    if desc.has_envmap():
        raise NotImplementedError("environment maps are not ported yet")
    data_dir = data_dir or desc.root_dir

    mat_names = list(desc.materials.keys())
    mat_index = {n: i for i, n in enumerate(mat_names)}
    if not mat_names:
        mat_names = ["default"]
        mat_index = {"default": 0}
        desc.materials["default"] = MaterialDesc(name="default",
                                                 color=(0.8, 0.8, 0.8))

    tex_paths, tex_ids = [], {}
    for n in mat_names:
        m = desc.materials[n]
        if m.albedo_tex and m.albedo_tex not in tex_ids:
            tex_ids[m.albedo_tex] = len(tex_paths)
            tex_paths.append(m.albedo_tex)
    textures, tex_hw = _load_textures(tex_paths, data_dir)

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
        if m.albedo_tex:
            mats["tex_id"][i] = tex_ids[m.albedo_tex]

    pos_l, n_l, uv_l, matid_l, light_l = [], [], [], [], []
    for mesh in desc.meshes:
        path = os.path.join(data_dir, mesh.file)
        if not os.path.exists(path):
            print(f"[scene] warning: missing mesh {mesh.file}, skipped")
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
    # subspace blocks start at 0 without an env map (scene_shift.cpp:110)
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

    if not pos_l:
        raise ValueError("scene has no geometry")
    positions = np.concatenate(pos_l)

    # uniform scene-unit normalization to a ~TARGET_DIAG bounding diagonal
    # (radiance-invariant; keeps BDPT-family f32 flux products in range)
    world_scale = 1.0
    if normalize_units:
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
        keep = light_ids >= 0  # light quads already carry exact normals
        normals = np.where(keep[:, None, None], normals,
                           np.repeat(gn[:, None, :], 3, axis=1))

    p0 = positions[:, 0]
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]

    flat = bvh_mod.build_bvh(p0, e1, e2)
    order = flat.order

    mode = mode or select_mode(len(p0), device)
    _check_mode(mode)
    cset_walk = None
    if mode == "walk":
        cset_walk = clusters_mod.build_clusters(
            flat, p0[order], e1[order], e2[order], max_tris=128,
            device=device)

    def dev(x, dt=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return TraceScene(
        tri_p0=dev(p0[order]), tri_e1=dev(e1[order]), tri_e2=dev(e2[order]),
        tri_n=dev(normals[order]), tri_uv=dev(uvs[order]),
        tri_mat=dev(mat_ids[order], torch.int32),
        tri_light=dev(light_ids[order], torch.int32),
        mats=_tensors_of(Materials, mats, device),
        textures=dev(textures),
        tex_h=dev(tex_hw[:, 0], torch.int32),
        tex_w=dev(tex_hw[:, 1], torch.int32),
        lights=_tensors_of(QuadLights, lights, device),
        clusters_walk=cset_walk,
        num_lights=L, num_quad_lights=L, has_env=False, mode=mode,
        world_scale=float(world_scale),
    )


def load_trace_scene(scene_path: str, device, mode: Optional[str] = None):
    """Parse + assemble in one step; returns (TraceScene, SceneDesc, Camera).
    The camera is expressed in the normalized scene units (world_scale)."""
    desc = load_scene(scene_path)
    ts = build_scene(desc, device, mode=mode)
    s = ts.world_scale
    cam = Camera(eye=np.asarray(desc.eye) * s,
                 lookat=np.asarray(desc.lookat) * s,
                 up=np.asarray(desc.up), fov_y=desc.fov,
                 aspect=desc.width / desc.height)
    return ts, desc, cam


def from_jax_scene(jts, device) -> TraceScene:
    """The port's TraceScene from a JAX spcbpt_tpu TraceScene, whose arrays
    are read as numpy (no jax import here). Modes brute and walk only; the
    walk takes one cluster set."""
    if jts.has_env:
        raise NotImplementedError("environment maps are not ported yet")
    _check_mode(jts.mode)
    a = np.asarray
    cset = None
    if jts.mode == "walk":
        cw = jts.clusters_walk
        if isinstance(cw, tuple):
            raise NotImplementedError("partitioned cluster sets are not "
                                      "ported: the port walks one set")
        cset = clusters_mod.ClusterSet.from_arrays(
            a(cw.cmin), a(cw.cmax), a(cw.tri_block), a(cw.tri_begin), device)

    def dev(x, dt=torch.float32):
        return torch.tensor(a(x), dtype=dt, device=device)

    fields = lambda obj, cls: {f.name: a(getattr(obj, f.name))
                               for f in dataclasses.fields(cls)}
    return TraceScene(
        tri_p0=dev(jts.tri_p0), tri_e1=dev(jts.tri_e1), tri_e2=dev(jts.tri_e2),
        tri_n=dev(jts.tri_n), tri_uv=dev(jts.tri_uv),
        tri_mat=dev(jts.tri_mat, torch.int32),
        tri_light=dev(jts.tri_light, torch.int32),
        mats=_tensors_of(Materials, fields(jts.mats, Materials), device),
        textures=dev(jts.textures),
        tex_h=dev(jts.tex_h, torch.int32), tex_w=dev(jts.tex_w, torch.int32),
        lights=_tensors_of(QuadLights, fields(jts.lights, QuadLights), device),
        clusters_walk=cset,
        num_lights=jts.num_lights, num_quad_lights=jts.num_quad_lights,
        has_env=False, mode=jts.mode, world_scale=float(jts.world_scale),
    )

"""Wavefront OBJ loading to flat numpy triangle arrays.

Replaces the reference's vendored tiny_obj_loader (capability parity with the
subset the reference scenes use: v/vn/vt records, polygonal f records with
v, v/vt, v//vn, v/vt/vn forms, negative indices). A C++ fast path
(native/obj_loader.cpp) is used when available; this module is the portable
fallback and the correctness oracle for it.

The port's own copy of spcbpt_tpu/scene/obj.py, with the route rule of
ops/bvh.build_bvh: the native parser where g++ is on the PATH (a failure
raises), this module's parser only where there is no compiler.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    # Per-triangle corner attributes, already de-indexed (SoA, fixed shape).
    positions: np.ndarray  # (T, 3, 3) float32 — corner x vertex xyz
    normals: np.ndarray    # (T, 3, 3) float32 — shading normals (geo fallback)
    uvs: np.ndarray        # (T, 3, 2) float32


def _parse_index(token: str, nv: int, nt: int, nn: int):
    parts = token.split("/")
    vi = int(parts[0])
    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    vi = vi - 1 if vi > 0 else nv + vi
    ti = ti - 1 if ti > 0 else (nt + ti if ti < 0 else -1)
    ni = ni - 1 if ni > 0 else (nn + ni if ni < 0 else -1)
    return vi, ti, ni


def load_obj(path: str) -> MeshData:
    from ..native import loader

    if loader.get_lib() is None:
        return load_obj_python(path)
    return loader.native_load_obj(path)


def load_obj_python(path: str) -> MeshData:
    verts: list = []
    norms: list = []
    uvs: list = []
    f_v: list = []
    f_t: list = []
    f_n: list = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] not in "vf":
                continue
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append((float(t[1]), float(t[2]), float(t[3])))
            elif t[0] == "vn":
                norms.append((float(t[1]), float(t[2]), float(t[3])))
            elif t[0] == "vt":
                uvs.append((float(t[1]), float(t[2])))
            elif t[0] == "f":
                idx = [_parse_index(tok, len(verts), len(uvs), len(norms))
                       for tok in t[1:]]
                # triangle-fan triangulation of polygons
                for k in range(1, len(idx) - 1):
                    tri = (idx[0], idx[k], idx[k + 1])
                    f_v.append(tuple(x[0] for x in tri))
                    f_t.append(tuple(x[1] for x in tri))
                    f_n.append(tuple(x[2] for x in tri))

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    vn = np.asarray(norms, np.float32).reshape(-1, 3) if norms else np.zeros((0, 3), np.float32)
    vt = np.asarray(uvs, np.float32).reshape(-1, 2) if uvs else np.zeros((0, 2), np.float32)
    fv = np.asarray(f_v, np.int64).reshape(-1, 3)
    ft = np.asarray(f_t, np.int64).reshape(-1, 3)
    fn = np.asarray(f_n, np.int64).reshape(-1, 3)

    positions = v[fv]  # (T, 3, 3)

    # geometric normals as fallback
    e1 = positions[:, 1] - positions[:, 0]
    e2 = positions[:, 2] - positions[:, 0]
    gn = np.cross(e1, e2)
    gl = np.linalg.norm(gn, axis=-1, keepdims=True)
    gn = gn / np.maximum(gl, 1e-30)
    normals = np.repeat(gn[:, None, :], 3, axis=1)
    has_n = (fn >= 0) & (fn < len(vn)) if len(vn) else np.zeros_like(fn, bool)
    if len(vn):
        picked = vn[np.clip(fn, 0, max(len(vn) - 1, 0))]
        normals = np.where(has_n[..., None], picked, normals)

    tri_uv = np.zeros((len(fv), 3, 2), np.float32)
    if len(vt):
        has_t = (ft >= 0) & (ft < len(vt))
        picked_t = vt[np.clip(ft, 0, max(len(vt) - 1, 0))]
        tri_uv = np.where(has_t[..., None], picked_t, tri_uv).astype(np.float32)

    return MeshData(positions=positions.astype(np.float32),
                    normals=normals.astype(np.float32),
                    uvs=tri_uv)

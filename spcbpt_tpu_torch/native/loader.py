"""ctypes loader for the port's native host pieces: binned-SAH BVH
construction and the OBJ parser.

The sources here are copies of spcbpt_tpu/native/bvh_builder.cpp and
obj_loader.cpp, built with the JAX package's g++ flags so that both packages
build the same tree. The library is compiled at first use into
`kernels/build/libspcbpt_native-<hash>.so`, where the hash covers the
sources and the flags, and replaced atomically; nothing is built into the
source tree or when a module is imported.

The route follows the host, as in the JAX package: where g++ is on the PATH
the native pieces are built and used, and a failed build or call raises;
only where there is no compiler do the callers (ops/bvh.build_bvh,
scene/obj.load_obj) take their numpy versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "kernels", "build")
SOURCES = ("bvh_builder.cpp", "obj_loader.cpp")
# spcbpt_tpu/native/loader.py's flags: the same code gives the same tree
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB = None
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def compiler() -> str | None:
    """The C++ compiler the native route needs, or None where there is none."""
    return shutil.which("g++")


def _build(cxx: str) -> str:
    srcs = [os.path.join(_DIR, f) for f in SOURCES]
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR,
                      f"libspcbpt_native-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *srcs],
                         capture_output=True, text=True, timeout=240)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build the native host library:\n"
                           f"{res.stderr}")
    os.replace(tmp, so)   # atomic: no process ever loads a partial file
    return so


def get_lib():
    """The loaded native library, built first if needed; None only where
    there is no compiler."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            cxx = compiler()
            if cxx is None:
                return None
            lib = ctypes.CDLL(_build(cxx))
            # the C signatures, set once
            lib.bvh_build.restype = ctypes.c_int32
            lib.bvh_build.argtypes = ([_F32P] * 3 + [ctypes.c_int32] * 2
                                      + [_F32P] * 2 + [_I32P] * 3
                                      + [_I64P, _I32P])
            lib.obj_count.restype = ctypes.c_int64
            lib.obj_count.argtypes = [ctypes.c_char_p]
            lib.obj_load.restype = ctypes.c_int64
            lib.obj_load.argtypes = [ctypes.c_char_p] + [_F32P] * 3
            _LIB = lib
        return _LIB


def native_build_bvh(tri_p0, tri_e1, tri_e2, leaf_size: int):
    """FlatBVH of the triangles through the native code; raises if the
    native build of the tree fails."""
    from ..ops.bvh import FlatBVH

    lib = get_lib()
    if lib is None:
        raise RuntimeError("no C++ compiler: native BVH construction is not "
                           "available on this host")
    t = len(tri_p0)
    p0 = np.ascontiguousarray(tri_p0, np.float32)
    e1 = np.ascontiguousarray(tri_e1, np.float32)
    e2 = np.ascontiguousarray(tri_e2, np.float32)
    max_nodes = max(2 * t + 2, 8)
    bmin = np.zeros((max_nodes, 3), np.float32)
    bmax = np.zeros((max_nodes, 3), np.float32)
    skip = np.zeros(max_nodes, np.int32)
    leaf_start = np.zeros(max_nodes, np.int32)
    leaf_count = np.zeros(max_nodes, np.int32)
    order = np.zeros(t, np.int64)
    out_depth = np.zeros(1, np.int32)

    n_nodes = lib.bvh_build(
        p0.ctypes.data_as(_F32P), e1.ctypes.data_as(_F32P),
        e2.ctypes.data_as(_F32P), t, leaf_size,
        bmin.ctypes.data_as(_F32P), bmax.ctypes.data_as(_F32P),
        skip.ctypes.data_as(_I32P), leaf_start.ctypes.data_as(_I32P),
        leaf_count.ctypes.data_as(_I32P), order.ctypes.data_as(_I64P),
        out_depth.ctypes.data_as(_I32P))
    if n_nodes <= 0:
        raise RuntimeError(f"native bvh_build failed on {t} triangles "
                           f"(returned {n_nodes})")
    return FlatBVH(bounds_min=bmin[:n_nodes], bounds_max=bmax[:n_nodes],
                   skip=skip[:n_nodes], leaf_start=leaf_start[:n_nodes],
                   leaf_count=leaf_count[:n_nodes], order=order,
                   max_depth=int(out_depth[0]))


def native_load_obj(path: str):
    """MeshData of an OBJ file through the native parser; raises if the
    parser fails."""
    from ..scene.obj import MeshData

    lib = get_lib()
    if lib is None:
        raise RuntimeError("no C++ compiler: the native OBJ parser is not "
                           "available on this host")
    pb = path.encode()
    t = lib.obj_count(pb)
    if t < 0:
        raise RuntimeError(f"native obj_count failed on {path}")
    pos = np.zeros((t, 3, 3), np.float32)
    nrm = np.zeros((t, 3, 3), np.float32)
    uv = np.zeros((t, 3, 2), np.float32)
    got = lib.obj_load(pb, pos.ctypes.data_as(_F32P),
                       nrm.ctypes.data_as(_F32P), uv.ctypes.data_as(_F32P))
    if got != t:
        raise RuntimeError(f"native obj_load read {got} of {t} triangles "
                           f"from {path}")
    return MeshData(positions=pos, normals=nrm, uvs=uv)

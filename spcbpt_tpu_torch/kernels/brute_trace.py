"""ctypes bindings of csrc/brute_trace.cu: the CUDA brute-force traversal
kernel K3 (closest hit and any hit against every triangle).

`closest` and `any_hit` take (n, 3) rays, (n,) tmin/tmax and the scene's
(T, 3) p0/e1/e2 tables, check them, allocate the outputs with torch.empty,
launch on the current stream and raise on a launch error. LAUNCHES counts
each kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ray_walk import _check, _stream

MAX_TRIS = 512   # the triangle table lives in shared memory (18 KB)
LAUNCHES = {"brute_closest": 0, "brute_any": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures, set once at first use."""
    lib = build.load("brute_trace")
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    lib.brute_closest.argtypes = [_P] * 7 + [_I, _I, _I] + [_P] * 5
    lib.brute_closest.restype = _I
    lib.brute_any.argtypes = [_P] * 7 + [_I, _I] + [_P] * 2
    lib.brute_any.restype = _I
    return lib


def _check_inputs(o, d, tmin, tmax, p0, e1, e2):
    n = o.shape[0]
    t_total = p0.shape[0]
    if not 0 < t_total <= MAX_TRIS:
        raise ValueError(f"brute_trace kernels take 1..{MAX_TRIS} triangles, "
                         f"got {t_total}")
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"brute_trace kernels take CUDA tensors, got {dev}")
    f32 = torch.float32
    _check("origins", o, f32, (n, 3), dev)
    _check("dirs", d, f32, (n, 3), dev)
    _check("tmin", tmin, f32, (n,), dev)
    _check("tmax", tmax, f32, (n,), dev)
    for name, x in (("tri_p0", p0), ("tri_e1", e1), ("tri_e2", e2)):
        _check(name, x, f32, (t_total, 3), dev)
    return n, t_total, dev


def closest(o, d, tmin, tmax, p0, e1, e2, cull: bool):
    """K3 closest hit on (n,) rays -> (t, tri, u, v); misses keep t=1e30,
    tri=-1, u=v=0."""
    n, t_total, dev = _check_inputs(o, d, tmin, tmax, p0, e1, e2)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, tri, u, v
    with torch.cuda.device(dev):
        err = _lib().brute_closest(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            p0.data_ptr(), e1.data_ptr(), e2.data_ptr(), n, t_total,
            int(bool(cull)), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"brute_closest launch failed: CUDA error {err}")
    LAUNCHES["brute_closest"] += 1
    return t, tri, u, v


def any_hit(o, d, tmin, tmax, p0, e1, e2):
    """K3 any hit on (n,) rays -> int32 occlusion flags (1 = occluded)."""
    n, t_total, dev = _check_inputs(o, d, tmin, tmax, p0, e1, e2)
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return occ
    with torch.cuda.device(dev):
        err = _lib().brute_any(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            p0.data_ptr(), e1.data_ptr(), e2.data_ptr(), n, t_total,
            occ.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"brute_any launch failed: CUDA error {err}")
    LAUNCHES["brute_any"] += 1
    return occ

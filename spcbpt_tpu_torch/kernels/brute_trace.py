"""ctypes bindings of csrc/brute_trace.cu: the CUDA brute-force traversal
kernel K3 (closest hit and any hit against every triangle).

`closest` and `any_hit` take (n, 3) rays, tmin and tmax, and the scene's
(T, 3) p0/e1/e2 tables. tmin and tmax are each a Python number (passed by
value) or an (n,) float32 tensor with a stride of 0 (a broadcast scalar)
or 1: the kernel reads them as they are, so a call is one launch. The
binding checks its inputs, allocates the outputs with torch.empty,
launches on the current stream with no host sync (a call can be captured
in a CUDA graph) and raises on a launch error. LAUNCHES counts each
kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from . import build
from .ray_walk import _check, _stream

MAX_TRIS = 512   # the triangle table lives in shared memory (18 KB)
LAUNCHES = {"brute_closest": 0, "brute_any": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_BOUND = [_P, _I, _F]    # pointer (or None), stride, value


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures, set once at first use."""
    lib = build.load("brute_trace")
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    lib.brute_closest.argtypes = ([_P] * 2 + _BOUND * 2 + [_P] * 3
                                  + [_I, _I, _I] + [_P] * 5)
    lib.brute_closest.restype = _I
    lib.brute_any.argtypes = ([_P] * 2 + _BOUND * 2 + [_P] * 3 + [_I, _I]
                              + [_P] * 2)
    lib.brute_any.restype = _I
    return lib


def _bound(name, x, n, dev) -> tuple:
    """(pointer, stride, value) of tmin or tmax: a number goes by value, a
    tensor must be float32 (n,) on `dev` with a stride of 0 or 1. Copies
    nothing."""
    if isinstance(x, numbers.Real) and not isinstance(x, torch.Tensor):
        return None, 0, float(x)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: a number or a tensor, got {type(x)}")
    if x.device != dev:
        raise ValueError(f"{name}: on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {x.dtype}, expected torch.float32")
    if tuple(x.shape) != (n,):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected ({n},)")
    stride = x.stride(0) if n > 1 else 0
    if stride not in (0, 1):
        raise ValueError(f"{name}: stride {stride}, expected 0 (a broadcast "
                         f"scalar) or 1 (one per lane)")
    return x.data_ptr(), stride, 0.0


def _check_inputs(o, d, tmin, tmax, p0, e1, e2):
    """-> (n, t_total, device, tmin's and tmax's C arguments)."""
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
    for name, x in (("tri_p0", p0), ("tri_e1", e1), ("tri_e2", e2)):
        _check(name, x, f32, (t_total, 3), dev)
    return (n, t_total, dev, _bound("tmin", tmin, n, dev)
            + _bound("tmax", tmax, n, dev))


def closest(o, d, tmin, tmax, p0, e1, e2, cull: bool):
    """K3 closest hit on (n,) rays -> (t, tri, u, v); misses keep t=1e30,
    tri=-1, u=v=0."""
    n, t_total, dev, bounds = _check_inputs(o, d, tmin, tmax, p0, e1, e2)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, tri, u, v
    with torch.cuda.device(dev):
        err = _lib().brute_closest(
            o.data_ptr(), d.data_ptr(), *bounds, p0.data_ptr(),
            e1.data_ptr(), e2.data_ptr(), n, t_total, int(bool(cull)),
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            _stream(dev))
    if err:
        raise RuntimeError(f"brute_closest launch failed: CUDA error {err}")
    LAUNCHES["brute_closest"] += 1
    return t, tri, u, v


def any_hit(o, d, tmin, tmax, p0, e1, e2):
    """K3 any hit on (n,) rays -> bool occlusion flags."""
    n, t_total, dev, bounds = _check_inputs(o, d, tmin, tmax, p0, e1, e2)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    with torch.cuda.device(dev):
        err = _lib().brute_any(
            o.data_ptr(), d.data_ptr(), *bounds, p0.data_ptr(),
            e1.data_ptr(), e2.data_ptr(), n, t_total, occ.data_ptr(),
            _stream(dev))
    if err:
        raise RuntimeError(f"brute_any launch failed: CUDA error {err}")
    LAUNCHES["brute_any"] += 1
    return occ

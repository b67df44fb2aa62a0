"""ctypes bindings of csrc/ray_walk.cu: the CUDA row-walk kernels K1 (closest
hit) and K2 (any hit), which compute their rows' cluster entries themselves,
and `entries`, that phase alone written out as a table.

`closest` and `any_hit` take the padded, row-ordered rays that
ops/ray_walk.py prepares and the cluster set's boxes, triangle counts and
slot table, check them, allocate the outputs with torch.empty, launch on the
current stream and raise on a launch error. LAUNCHES counts each walk
kernel's launches and nothing else (`entries` is a check, not a walk).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

ROW = 8
BLOCK_RAYS = 64            # 8 rows, one warp each
WARPS = BLOCK_RAYS // ROW
GROUP = 8                  # clusters per group box of the entry phase
MAX_SHARED = 232_448       # dynamic shared memory a Hopper block can take
LAUNCHES = {"walk_closest": 0, "walk_any": 0}


def shared_bytes(c: int) -> int:
    """Python copy of csrc/ray_walk.cu's shared_bytes (the CPU has no
    kernel library; chip_smoke.py holds it to ray_walk_shared_bytes): 32
    bytes a cluster box and a group box, and per warp a list of C (entry,
    id) pairs and the groups in reach."""
    g = -(-c // GROUP)
    return 32 * (c + g) + WARPS * (8 * c + 4 * g)


# the most clusters one K1/K2 block holds: the cap of a cluster set's part
MAX_CLUSTERS = max(c for c in range(1, MAX_SHARED // 32)
                   if shared_bytes(c) <= MAX_SHARED)

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures, set once at first use."""
    lib = build.load("ray_walk")
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    lib.ray_walk_closest.argtypes = [_P] * 9 + [_I, _I, _I] + [_P] * 5
    lib.ray_walk_any.argtypes = [_P] * 8 + [_I, _I] + [_P] * 2
    lib.ray_walk_entries.argtypes = [_P] * 6 + [_I, _I] + [_P] * 2
    lib.ray_walk_shared_bytes.argtypes = [_I]
    for fn in (lib.ray_walk_closest, lib.ray_walk_any, lib.ray_walk_entries,
               lib.ray_walk_shared_bytes):
        fn.restype = _I
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_inputs(o, d, tmin, tmax, cmin, cmax):
    """Rays and boxes, as every entry point takes them -> (n, c, device)."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"ray_walk kernels take CUDA tensors, got {dev}")
    n = o.shape[0]
    if n % BLOCK_RAYS:
        raise ValueError(f"ray count {n} is not a multiple of {BLOCK_RAYS}")
    c = cmin.shape[0]
    f32 = torch.float32
    _check("origins", o, f32, (n, 3), dev)
    _check("dirs", d, f32, (n, 3), dev)
    _check("tmin", tmin, f32, (n,), dev)
    _check("tmax", tmax, f32, (n,), dev)
    _check("cmin", cmin, f32, (c, 3), dev)
    _check("cmax", cmax, f32, (c, 3), dev)
    return n, c, dev


def _check_triangles(tri_count, tri_slots, c, dev):
    _check("tri_count", tri_count, torch.int32, (c,), dev)
    _check("tri_slots", tri_slots, torch.float32, (c, 128, 12), dev)


def _check_shared(c) -> None:
    """A block keeps the C boxes and a C-entry list per row in shared
    memory: a cluster set too large for one block raises."""
    need = _lib().ray_walk_shared_bytes(c)
    if need > MAX_SHARED:
        raise ValueError(f"a cluster set of C = {c} clusters needs {need} "
                         f"bytes of shared memory a block, above the "
                         f"{MAX_SHARED} a block can take")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def closest(o, d, tmin, tmax, cmin, cmax, tri_begin, tri_count, tri_slots,
            cull: bool):
    """K1 on (n,) rays -> (t, tri, u, v); misses keep t=1e30, tri=-1; at
    equal t the lower file id (each slot's fourth word)."""
    n, c, dev = _check_inputs(o, d, tmin, tmax, cmin, cmax)
    _check("tri_begin", tri_begin, torch.int32, (c,), dev)
    _check_triangles(tri_count, tri_slots, c, dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, tri, u, v
    _check_shared(c)
    with torch.cuda.device(dev):
        err = _lib().ray_walk_closest(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            cmin.data_ptr(), cmax.data_ptr(), tri_begin.data_ptr(),
            tri_count.data_ptr(), tri_slots.data_ptr(), n, c,
            int(bool(cull)), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"ray_walk_closest launch failed: CUDA error {err}")
    LAUNCHES["walk_closest"] += 1
    return t, tri, u, v


def any_hit(o, d, tmin, tmax, cmin, cmax, tri_count, tri_slots):
    """K2 on (n,) rays -> int32 occlusion flags (1 = occluded)."""
    n, c, dev = _check_inputs(o, d, tmin, tmax, cmin, cmax)
    _check_triangles(tri_count, tri_slots, c, dev)
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return occ
    _check_shared(c)
    with torch.cuda.device(dev):
        err = _lib().ray_walk_any(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            cmin.data_ptr(), cmax.data_ptr(), tri_count.data_ptr(),
            tri_slots.data_ptr(), n, c, occ.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"ray_walk_any launch failed: CUDA error {err}")
    LAUNCHES["walk_any"] += 1
    return occ


def entries(o, d, tmin, tmax, cmin, cmax):
    """The kernels' entry phase alone -> the (n/8, c) table that
    ops/ray_walk.row_entries builds in torch. On no render path."""
    n, c, dev = _check_inputs(o, d, tmin, tmax, cmin, cmax)
    out = torch.empty((n // ROW, c), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    _check_shared(c)
    with torch.cuda.device(dev):
        err = _lib().ray_walk_entries(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            cmin.data_ptr(), cmax.data_ptr(), n, c, out.data_ptr(),
            _stream(dev))
    if err:
        raise RuntimeError(f"ray_walk_entries launch failed: CUDA error {err}")
    return out

"""ctypes bindings of csrc/list_walk.cu: the CUDA list-walk kernels K6, in
their resident and streamed forms, closest hit and any hit.

Each function checks its tensors, allocates the outputs with torch.empty,
launches on the current stream and raises on a launch error. LAUNCHES
counts each entry point's launches and nothing else. The closest forms walk
in groups of `group_rays()` rays, the any forms in groups of
`any_group_rays(stream)`, a warp each; all take the cluster set's
`tri_count` (the slots they test).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ray_walk import _check, _stream

SLOTS = 128
MAX_TILE = 256   # rays per tile = threads per block, a multiple of 32
LAUNCHES = {"list_walk_closest": 0, "list_walk_closest_stream": 0,
            "list_walk_any": 0, "list_walk_any_stream": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures, set once at first use."""
    lib = build.load("list_walk")
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    lib.list_walk_closest.argtypes = [_P] * 10 + [_I] * 5 + [_P] * 6
    lib.list_walk_closest_stream.argtypes = [_P] * 10 + [_I] * 4 + [_P] * 6
    lib.list_walk_any.argtypes = [_P] * 9 + [_I] * 3 + [_P] * 3
    lib.list_walk_any_stream.argtypes = [_P] * 9 + [_I] * 3 + [_P] * 3
    lib.list_walk_group_rays.argtypes = []
    lib.list_walk_any_group_rays.argtypes = [_I]
    for name in (*LAUNCHES, "list_walk_group_rays",
                 "list_walk_any_group_rays"):
        getattr(lib, name).restype = _I
    return lib


def group_rays() -> int:
    """Rays per group (one warp) of the closest kernels."""
    return _lib().list_walk_group_rays()


def any_group_rays(stream: bool) -> int:
    """Rays per group (one warp) of the resident (stream=False) or streamed
    any kernel."""
    return _lib().list_walk_any_group_rays(int(bool(stream)))


def _check_lists(blocks, counts, ids, entries, o, d, tmn, tmx):
    """Shapes of the prepared walk: (NT,) counts, (NT, C) lists, NT tiles of
    `tile` rays, (C, 16, 128) blocks. Returns (nt, tile, c, device)."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"list_walk kernels take CUDA tensors, got {dev}")
    nt, c = ids.shape
    n = o.shape[0]
    tile = n // nt if nt else 0
    if nt and (tile * nt != n or tile % 32 or not 0 < tile <= MAX_TILE):
        raise ValueError(f"{n} rays in {nt} tiles: a tile must be a "
                         f"multiple of 32 up to {MAX_TILE} rays")
    f32, i32 = torch.float32, torch.int32
    _check("counts", counts, i32, (nt,), dev)
    _check("ids", ids, i32, (nt, c), dev)
    _check("entries", entries, f32, (nt, c), dev)
    _check("origins", o, f32, (n, 3), dev)
    _check("dirs", d, f32, (n, 3), dev)
    _check("tmin", tmn, f32, (n,), dev)
    _check("tmax", tmx, f32, (n,), dev)
    _check("blocks", blocks, f32, (c, 16, SLOTS), dev)
    return nt, tile, c, dev


def closest(blocks, tri_count, counts, ids, bases, entries, o, d, tmn, tmx,
            cull: bool, prune: bool, stream: bool, rounds=None):
    """K6 closest hit on prepared rays -> (t, tri, u, v), each (n,); misses
    keep t=1e30, tri=-1, u=v=0. tri_count: the (C,) int32 slots to test per
    cluster (every slot at or past it zero). stream=True launches the
    streamed form, which always prunes. rounds: None, or an
    (n / group_rays(), 2) int32 tensor that receives, per group, the rounds
    it walked and the slots its rays tested, summed over the rays."""
    nt, tile, c, dev = _check_lists(blocks, counts, ids, entries, o, d, tmn,
                                    tmx)
    _check("bases", bases, torch.int32, (nt, c), dev)
    _check("tri_count", tri_count, torch.int32, (c,), dev)
    if stream and not prune:
        raise ValueError("the streamed closest walk always prunes")
    n = o.shape[0]
    if rounds is not None:
        _check("rounds", rounds, torch.int32, (n // group_rays(), 2), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    if nt == 0:
        return t, tri, u, v
    ptrs = (counts.data_ptr(), ids.data_ptr(), bases.data_ptr(),
            entries.data_ptr(), o.data_ptr(), d.data_ptr(), tmn.data_ptr(),
            tmx.data_ptr(), blocks.data_ptr(), tri_count.data_ptr(), nt, tile,
            c, int(bool(cull)))
    outs = (t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            None if rounds is None else rounds.data_ptr(), _stream(dev))
    name = "list_walk_closest_stream" if stream else "list_walk_closest"
    with torch.cuda.device(dev):
        fn = getattr(_lib(), name)
        err = fn(*ptrs, *outs) if stream else fn(*ptrs, int(bool(prune)),
                                                 *outs)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return t, tri, u, v


def any_hit(blocks, tri_count, counts, ids, entries, o, d, tmn, tmx,
            stream: bool, rounds=None):
    """K6 any hit on prepared rays -> int32 occlusion flags (1 = occluded).
    tri_count: the (C,) int32 slots to test per cluster (every slot at or
    past it zero). rounds: None, or an (n / any_group_rays(stream), 2)
    int32 tensor that receives, per group, the rounds it walked and the
    slots its rays tested, summed over the rays."""
    nt, tile, c, dev = _check_lists(blocks, counts, ids, entries, o, d, tmn,
                                    tmx)
    _check("tri_count", tri_count, torch.int32, (c,), dev)
    n = o.shape[0]
    if rounds is not None:
        _check("rounds", rounds, torch.int32,
               (n // any_group_rays(stream), 2), dev)
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    if nt == 0:
        return occ
    name = "list_walk_any_stream" if stream else "list_walk_any"
    with torch.cuda.device(dev):
        err = getattr(_lib(), name)(
            counts.data_ptr(), ids.data_ptr(), entries.data_ptr(),
            o.data_ptr(), d.data_ptr(), tmn.data_ptr(), tmx.data_ptr(),
            blocks.data_ptr(), tri_count.data_ptr(), nt, tile, c,
            occ.data_ptr(), None if rounds is None else rounds.data_ptr(),
            _stream(dev))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return occ

"""ctypes bindings of csrc/tile_walk.cu: the CUDA tile-walk kernels K4 (the
round walk of the tile mode's closest hit, and one round alone) and K5 (the
fused walk, closest hit and any hit).

Each function checks its tensors, allocates the outputs with torch.empty,
launches on the current stream and raises on a launch error. LAUNCHES
counts each kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ray_walk import _check, _stream

TILE = 128             # rays per tile of K5
MAX_ROUND_LANES = 256  # rays per tile of K4: one thread each
SLOTS = 128
# Both K5 kernels keep their tile's candidate list as 8-byte (entry, id)
# keys in shared memory, padded to a power of two for its sort (K5 any
# beside two staged 9 x 128 blocks)
MAX_ANY_CLUSTERS = 1 << 14
LAUNCHES = {"tile_round_walk": 0, "tile_round": 0, "tile_walk_closest": 0,
            "tile_walk_any": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures, set once at first use."""
    lib = build.load("tile_walk")
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    lib.tile_round_walk.argtypes = [_P] * 9 + [_I] * 5 + [_P] * 6
    lib.tile_round_walk.restype = _I
    lib.tile_round.argtypes = [_P] * 8 + [_I] * 4 + [_P] * 6
    lib.tile_round.restype = _I
    lib.tile_walk_closest.argtypes = [_P] * 9 + [_I] * 3 + [_P] * 6
    lib.tile_walk_closest.restype = _I
    lib.tile_walk_group_rays.argtypes = []
    lib.tile_walk_group_rays.restype = _I
    lib.tile_walk_any.argtypes = [_P] * 8 + [_I] * 3 + [_P] * 2
    lib.tile_walk_any.restype = _I
    return lib


def group_rays() -> int:
    """Rays per group (one warp) of K5 closest."""
    return _lib().tile_walk_group_rays()


def _check_blocks(tri_block, tri_k, dev):
    c = tri_block.shape[0]
    _check("tri_block", tri_block, torch.float32, (c, 16, SLOTS), dev)
    if not 0 < tri_k <= SLOTS:
        raise ValueError(f"tri_k {tri_k} outside 1..{SLOTS}")
    return c


def _cuda_device(x):
    if x.device.type != "cuda":
        raise ValueError(f"tile_walk kernels take CUDA tensors, got "
                         f"{x.device}")
    return x.device


def round_walk(o, d, tmin, tmax, entries, ids, tri_block, tri_begin,
               tri_count, tri_k: int, cull: bool):
    """K4, the whole round walk, on (nt, r) ray tiles -> (t, tri, u, v),
    each (nt, r), and rounds (nt,) int32: tile i visits the clusters
    ids[i, 0], ids[i, 1], ... of its near-to-far order (entries[i] ascending,
    1e30 past its reach) while the next entry is at most the tile's largest
    min(best_t, tmax), testing each cluster's slots below tri_count; misses
    keep t 1e30, tri -1, u = v = 0. r is a multiple of 32 up to 256."""
    dev = _cuda_device(o)
    nt, r = o.shape[0], o.shape[1]
    if r % 32 or not 0 < r <= MAX_ROUND_LANES:
        raise ValueError(f"tile of {r} rays: the round walk takes a multiple "
                         f"of 32 up to {MAX_ROUND_LANES}")
    f32 = torch.float32
    _check("origins", o, f32, (nt, r, 3), dev)
    _check("dirs", d, f32, (nt, r, 3), dev)
    _check("tmin", tmin, f32, (nt, r), dev)
    _check("tmax", tmax, f32, (nt, r), dev)
    c = _check_blocks(tri_block, tri_k, dev)
    _check("tri_begin", tri_begin, torch.int32, (c,), dev)
    _check("tri_count", tri_count, torch.int32, (c,), dev)
    n_cols = entries.shape[1] if entries.dim() == 2 else -1
    if n_cols < 1:
        raise ValueError(f"entries of shape {tuple(entries.shape)}: one "
                         f"visit order of at least one cluster per tile")
    _check("entries", entries, f32, (nt, n_cols), dev)
    _check("ids", ids, torch.int32, (nt, n_cols), dev)
    t = torch.empty((nt, r), dtype=f32, device=dev)
    tri = torch.empty((nt, r), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    rounds = torch.empty((nt,), dtype=torch.int32, device=dev)
    if nt == 0:
        return t, tri, u, v, rounds
    with torch.cuda.device(dev):
        err = _lib().tile_round_walk(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            entries.data_ptr(), ids.data_ptr(), tri_block.data_ptr(),
            tri_begin.data_ptr(), tri_count.data_ptr(), nt, r, n_cols, tri_k,
            int(bool(cull)),
            t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            rounds.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"tile_round_walk launch failed: CUDA error {err}")
    LAUNCHES["tile_round_walk"] += 1
    return t, tri, u, v, rounds


def tile_round(o, d, tmin, tmax_eff, cid, run, tri_block, tri_count,
               tri_k: int, cull: bool):
    """K4 on (nt, r) ray tiles -> (t, u, v, dn, slot), each (nt, r): tile
    i against the slots below tri_count of tri_block[cid[i]] where run[i],
    a miss (t 1e30, u = v = 0, slot 128) where not; dn is 1."""
    dev = _cuda_device(o)
    nt, r = o.shape[0], o.shape[1]
    if not 0 < r <= MAX_ROUND_LANES:
        raise ValueError(f"tile of {r} rays outside 1..{MAX_ROUND_LANES}")
    f32 = torch.float32
    _check("origins", o, f32, (nt, r, 3), dev)
    _check("dirs", d, f32, (nt, r, 3), dev)
    _check("tmin", tmin, f32, (nt, r), dev)
    _check("tmax_eff", tmax_eff, f32, (nt, r), dev)
    _check("cid", cid, torch.int32, (nt,), dev)
    _check("run", run, torch.bool, (nt,), dev)
    c = _check_blocks(tri_block, tri_k, dev)
    _check("tri_count", tri_count, torch.int32, (c,), dev)
    t = torch.empty((nt, r), dtype=f32, device=dev)
    u, v, dn = torch.empty_like(t), torch.empty_like(t), torch.empty_like(t)
    slot = torch.empty((nt, r), dtype=torch.int32, device=dev)
    if nt == 0:
        return t, u, v, dn, slot
    with torch.cuda.device(dev):
        err = _lib().tile_round(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax_eff.data_ptr(),
            cid.data_ptr(), run.data_ptr(), tri_block.data_ptr(),
            tri_count.data_ptr(), nt, r, tri_k, int(bool(cull)),
            t.data_ptr(), u.data_ptr(), v.data_ptr(), dn.data_ptr(),
            slot.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"tile_round launch failed: CUDA error {err}")
    LAUNCHES["tile_round"] += 1
    return t, u, v, dn, slot


def _check_walk(o, d, tmin, tmax, cmin, cmax, tri_block, tri_count):
    c = tri_block.shape[0]
    if not 0 < c <= MAX_ANY_CLUSTERS:
        raise ValueError(f"{c} clusters outside 1..{MAX_ANY_CLUSTERS} (the "
                         f"kernels' shared memory)")
    dev = _cuda_device(o)
    n = o.shape[0]
    if n % TILE:
        raise ValueError(f"ray count {n} is not a multiple of {TILE}")
    f32 = torch.float32
    _check("origins", o, f32, (n, 3), dev)
    _check("dirs", d, f32, (n, 3), dev)
    _check("tmin", tmin, f32, (n,), dev)
    _check("tmax", tmax, f32, (n,), dev)
    _check("tri_block", tri_block, f32, (c, 16, SLOTS), dev)
    _check("cmin", cmin, f32, (c, 3), dev)
    _check("cmax", cmax, f32, (c, 3), dev)
    _check("tri_count", tri_count, torch.int32, (c,), dev)
    return n, c, dev


def walk_closest(o, d, tmin, tmax, cmin, cmax, tri_begin, tri_block,
                 tri_count, cull: bool, rounds=None):
    """K5 closest hit on (n,) padded rays -> (t, tri, u, v); each cluster's
    slots below tri_count are tested; misses keep t=1e30, tri=-1, u=v=0.
    rounds: None, or an (n / group_rays(), 2) int32 tensor that receives,
    per group, the positions of its tile's list it walked and the slots its
    rays tested, summed over the rays."""
    n, c, dev = _check_walk(o, d, tmin, tmax, cmin, cmax, tri_block,
                            tri_count)
    _check("tri_begin", tri_begin, torch.int32, (c,), dev)
    if rounds is not None:
        _check("rounds", rounds, torch.int32, (n // group_rays(), 2), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    if n == 0:
        return t, tri, u, v
    with torch.cuda.device(dev):
        err = _lib().tile_walk_closest(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            cmin.data_ptr(), cmax.data_ptr(), tri_begin.data_ptr(),
            tri_block.data_ptr(), tri_count.data_ptr(), n, c,
            int(bool(cull)), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
            v.data_ptr(), None if rounds is None else rounds.data_ptr(),
            _stream(dev))
    if err:
        raise RuntimeError(f"tile_walk_closest launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["tile_walk_closest"] += 1
    return t, tri, u, v


def walk_any(o, d, tmin, tmax, cmin, cmax, tri_block, tri_count,
             tri_k: int):
    """K5 any hit on (n,) padded rays -> int32 occlusion flags (1 =
    occluded); each cluster's slots below tri_count are tested."""
    n, c, dev = _check_walk(o, d, tmin, tmax, cmin, cmax, tri_block,
                            tri_count)
    _check_blocks(tri_block, tri_k, dev)
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return occ
    with torch.cuda.device(dev):
        err = _lib().tile_walk_any(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            cmin.data_ptr(), cmax.data_ptr(), tri_block.data_ptr(),
            tri_count.data_ptr(), n, c, tri_k, occ.data_ptr(), _stream(dev))
    if err:
        raise RuntimeError(f"tile_walk_any launch failed: CUDA error {err}")
    LAUNCHES["tile_walk_any"] += 1
    return occ

"""Wavefront coherence sort keys.

Port of the sort-key part of spcbpt_tpu/ops/tile_trace.py (`_morton3`,
`ray_sort_key`, `ray_sort_key_live`); the tile walk itself is not ported yet.
"""
from __future__ import annotations

import torch


def _morton3(q, bits: int):
    """Interleave the low `bits` of 3 int32 coords (q: (..., 3))."""
    out = torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device)
    for b in range(bits):
        for a in range(3):
            out = out | (((q[..., a] >> b) & 1) << (3 * b + a))
    return out


def ray_sort_key(cmin, cmax, origins, dirs, bits: int = 5):
    """Wavefront coherence key: direction octant (major) then origin morton
    cell (minor). Sorting secondary-bounce wavefronts by it re-forms coherent
    rows: within a row all directions share sign per axis and origins share
    a morton cell."""
    lo = torch.amin(cmin, dim=0)
    hi = torch.amax(cmax, dim=0)
    scale = (1 << bits) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(((origins - lo) * scale).to(torch.int32), 0,
                    (1 << bits) - 1)
    morton = _morton3(q, bits)
    octant = ((dirs[..., 0] < 0).to(torch.int32)
              | ((dirs[..., 1] < 0).to(torch.int32) << 1)
              | ((dirs[..., 2] < 0).to(torch.int32) << 2))
    return (octant << (3 * bits)) | morton


def ray_sort_key_live(cmin, cmax, origins, dirs, tmin, tmax, bits: int = 5):
    """ray_sort_key with DEAD lanes (tmax < tmin, the masked-lane convention)
    sorted to the end, so that they pack into whole rows the walk kernels
    skip in one round."""
    key = ray_sort_key(cmin, cmax, origins, dirs, bits)
    dead = tmax < tmin
    return key | (dead.to(torch.int32) << 24)

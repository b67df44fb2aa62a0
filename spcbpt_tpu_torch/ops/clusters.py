"""Two-level traversal clusters: cut the SAH BVH into contiguous triangle
blocks of at most K triangles, one AABB each.

Port of spcbpt_tpu/ops/clusters.py for the row walk (ops/ray_walk.py): the
host build is numpy with the JAX package's float64 -> float32 casts, so the
arrays equal JAX's exactly. The MXU coefficient blocks of the tile mode are
not built (the walk uses `with_coeff=False`), and one cluster set takes a
scene of any size: the JAX package's partitioning exists only for the TPU's
VMEM.

Triangle ids are tri_begin[cluster] + slot; clusters are contiguous ranges
of the BVH-reordered triangle array.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spcbpt_tpu.ops.bvh import FlatBVH

SLOTS = 128   # triangle slots per cluster


@dataclasses.dataclass
class ClusterSet:
    cmin: torch.Tensor       # (C, 3) cluster AABB min
    cmax: torch.Tensor       # (C, 3)
    tri_begin: torch.Tensor  # (C,) int32 first (reordered) triangle id
    tri_slots: torch.Tensor  # (C, 128, 12) triangles slot-major,
                             # [p0, 0, e1, 0, e2, 0], zero-padded: three
                             # 16-byte loads per slot; read by the kernels
                             # and by their plain versions
    tri_block: np.ndarray    # host only: (C, 16, 128) rows 0..8 = [p0, e1,
                             # e2] xyz per slot, the JAX package's layout,
                             # kept for parity checks against it

    @property
    def num_clusters(self) -> int:
        return self.cmin.shape[0]

    @classmethod
    def from_arrays(cls, cmin, cmax, tri_block, tri_begin,
                    device) -> "ClusterSet":
        """Device cluster set from the host arrays of either package."""
        tri_block = np.asarray(tri_block, np.float32)
        c = tri_block.shape[0]
        slots = np.zeros((c, SLOTS, 3, 4), np.float32)
        slots[..., :3] = tri_block[:, :9, :].transpose(0, 2, 1).reshape(
            c, SLOTS, 3, 3)
        t = lambda a, dt=torch.float32: torch.tensor(
            np.asarray(a), dtype=dt, device=device)
        return cls(cmin=t(cmin), cmax=t(cmax),
                   tri_begin=t(tri_begin, torch.int32),
                   tri_slots=t(slots.reshape(c, SLOTS, 12)),
                   tri_block=tri_block)


def _cut_bvh(flat: FlatBVH, max_tris: int):
    """Walk the DFS-ordered skip-link BVH; emit the shallowest subtrees whose
    triangle range is <= max_tris. DFS order makes every subtree's triangles a
    contiguous range of the reordered array."""
    n = len(flat.skip)
    leaf_tris = np.where(flat.leaf_start >= 0, flat.leaf_count, 0)
    pref = np.concatenate([[0], np.cumsum(leaf_tris)])
    clusters = []  # (tri_begin, tri_end, node)
    i = 0
    while i < n:
        end = int(flat.skip[i])
        count = int(pref[end] - pref[i])
        if count <= max_tris or flat.leaf_start[i] >= 0:
            if count > 0:
                clusters.append((int(pref[i]), int(pref[end]), i))
            i = end
        else:
            i += 1
    return clusters


def build_clusters(flat: FlatBVH, p0: np.ndarray, e1: np.ndarray,
                   e2: np.ndarray, max_tris: int = SLOTS,
                   device="cpu") -> ClusterSet:
    """Build a ClusterSet from a flattened BVH and the REORDERED triangle
    arrays (p0/e1/e2 already permuted by flat.order)."""
    if max_tris > SLOTS:
        raise ValueError(f"cluster size {max_tris} above {SLOTS} slots")
    cl = _cut_bvh(flat, max_tris)
    p0 = np.asarray(p0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    c = len(cl)
    tri_block = np.zeros((c, 16, SLOTS), np.float32)
    cmin = np.zeros((c, 3), np.float32)
    cmax = np.zeros((c, 3), np.float32)
    begin = np.zeros((c,), np.int32)
    for ci, (lo, hi, node) in enumerate(cl):
        raw = np.concatenate([p0[lo:hi], e1[lo:hi], e2[lo:hi]], axis=1)
        tri_block[ci, :9, :hi - lo] = raw.T
        cmin[ci] = flat.bounds_min[node]
        cmax[ci] = flat.bounds_max[node]
        begin[ci] = lo
    return ClusterSet.from_arrays(cmin, cmax, tri_block, begin, device)

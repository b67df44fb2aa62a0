"""Two-level traversal clusters: cut the SAH BVH into contiguous triangle
blocks of at most K triangles, one AABB each.

Port of spcbpt_tpu/ops/clusters.py: the host build is numpy with the JAX
package's float64 -> float32 casts, so the arrays equal JAX's exactly. Two
sets, as the JAX scene builds them:
  * `ClusterSet`, K = 128, for the row walk (ops/ray_walk.py), without the
    coefficient blocks (`with_coeff=False` in JAX);
  * `TileClusterSet`, K = 32, for the tile mode (ops/tile_trace.py,
    ops/pallas_tile.py), with the coefficient blocks of the matmul walk and
    the raw (C, 16, 128) triangle blocks that kernels K4/K5 read.
The list walk (ops/pallas_walk.py, kernel K6) takes either set and reads
its (C, 16, 128) blocks on the device (`blocks()`).
A large scene's row-walk set is split into `ClusterParts`
(`build_cluster_parts`): contiguous ranges of the whole set's clusters, cut
by JAX's rule (at most `part_max_tris` triangles a part) and by the
clusters one K1/K2 block holds in shared memory (`MAX_CLUSTERS`); the
row walk walks the parts in turn (ops/ray_walk.walk_closest_parts).
A tile set above the clusters one K5 closest block holds in shared memory
(kernels/tile_walk.MAX_CLOSEST_CLUSTERS) is split into ClusterParts too,
of near-equal contiguous ranges (`even_bounds`), which the fused closest
walk walks in turn (ops/pallas_tile.pallas_closest); K5 any takes any
set whole.

The coefficient trick (`pack_coefficients`): for a triangle (p0, e1, e2)
with n = e1 x e2, the Moller-Trumbore numerators and determinant are linear
in the 16 ray features F = [vec(o d^T), d, o, 1] (`ray_features`), so a
cluster of K triangles is a (16, 4K) matrix and testing R rays one
(R, 16) x (16, 4K) product.

Triangle ids are tri_begin[cluster] + slot; clusters are contiguous ranges
of the BVH-reordered triangle array. The row walk's set keeps each
triangle's id in the scene file (`tri_file`), by which its closest walks
order hits of equal t.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.ray_walk import MAX_CLUSTERS
from .bvh import FlatBVH

SLOTS = 128   # triangle slots per cluster
FEAT_DIM = 16
N_OUT = 4     # u_num, v_num, t_num, det
# The cluster visits of the plain walks, while a caller collects them: a
# list of (lanes of the visiting row or tile, cluster ids visited in one
# round), or None. chip_smoke.py counts a kernel's ray-triangle tests from
# it (the work term of the kernel's bound).
VISIT_LOG: Optional[list] = None


def log_visits(lanes: int, cid) -> None:
    """Record one round of a plain walk: each cluster id in `cid` tested
    against `lanes` rays."""
    if VISIT_LOG is not None:
        VISIT_LOG.append((lanes, cid))


def cluster_sizes(cs, num_tris: int) -> torch.Tensor:
    """(C,) int64 triangles per cluster of either set (clusters are
    contiguous ranges of the reordered triangle array). The row walk's set
    keeps them as `tri_count`, made once with the set."""
    begin = cs.tri_begin.long()
    end = torch.cat([begin[1:], begin.new_tensor([num_tris])])
    return end - begin


@dataclasses.dataclass
class ClusterSet:
    cmin: torch.Tensor       # (C, 3) cluster AABB min
    cmax: torch.Tensor       # (C, 3)
    tri_begin: torch.Tensor  # (C,) int32 first (reordered) triangle id
    tri_count: torch.Tensor  # (C,) int32 triangles of the cluster: the
                             # slots the row-walk kernels test
    tri_slots: torch.Tensor  # (C, 128, 12) triangles slot-major,
                             # [p0, file id, e1, 0, e2, 0], zero-padded:
                             # three 16-byte loads per slot, the file id
                             # (tri_file's) as the bits of an int32; read by
                             # the kernels and by their plain versions
    tri_block: np.ndarray    # host: (C, 16, 128) rows 0..8 = [p0, e1, e2]
                             # xyz per slot, the JAX package's layout; the
                             # list walk (K6) reads it on the device,
                             # through blocks()
    tri_file: torch.Tensor   # (T,) int32 file-order id of each (reordered)
                             # triangle: the closest walks' order at equal t
    _blocks: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    # arrays of the whole scene's triangles, which a part keeps whole
    PER_TRIANGLE = ("tri_file",)

    @property
    def num_clusters(self) -> int:
        return self.cmin.shape[0]

    def blocks(self) -> torch.Tensor:
        """tri_block on the set's device, copied at first use (368 x 8 KB
        at the scale-4 interior)."""
        if self._blocks is None:
            self._blocks = torch.from_numpy(self.tri_block).to(
                self.cmin.device)
        return self._blocks

    @classmethod
    def from_arrays(cls, cmin, cmax, tri_block, tri_begin, num_tris: int,
                    device, file_order=None) -> "ClusterSet":
        """Device cluster set from the host arrays of either package, the
        scene's triangle count and the file-order id of each reordered
        triangle (the BVH's `order`; None: the reordered id, for arrays
        that keep no file order, such as the JAX package's)."""
        tri_block = np.asarray(tri_block, np.float32)
        c = tri_block.shape[0]
        begin = np.asarray(tri_begin, np.int64)
        count = np.append(begin[1:], num_tris) - begin
        file = np.asarray(np.arange(num_tris) if file_order is None
                          else file_order, np.int32)
        slots = np.zeros((c, SLOTS, 3, 4), np.float32)
        slots[..., :3] = tri_block[:, :9, :].transpose(0, 2, 1).reshape(
            c, SLOTS, 3, 3)
        ids = begin[:, None] + np.arange(SLOTS)
        key = np.where(ids < (begin + count)[:, None],
                       file[np.minimum(ids, num_tris - 1)], 0)
        slots[:, :, 0, 3] = key.astype(np.int32).view(np.float32)
        t = lambda a, dt=torch.float32: torch.tensor(
            np.asarray(a), dtype=dt, device=device)
        return cls(cmin=t(cmin), cmax=t(cmax),
                   tri_begin=t(tri_begin, torch.int32),
                   tri_count=t(count, torch.int32),
                   tri_slots=t(slots.reshape(c, SLOTS, 12)),
                   tri_block=tri_block, tri_file=t(file, torch.int32))


@dataclasses.dataclass
class ClusterParts:
    """A cluster set split into parts: `parts[i]` is the set (a ClusterSet
    of the row walk, or a TileClusterSet of the tile mode) of the whole
    set's clusters bounds[i][0]:bounds[i][1], its arrays views of the whole
    set's (tri_begin stays the global triangle id; a per-triangle array,
    `PER_TRIANGLE`, is the whole set's). Ranges in BVH order
    are runs of subtrees: each part is spatially coherent."""
    whole: object
    bounds: tuple            # ((first cluster, end), ...) per part
    parts: tuple             # a set of whole's type per part

    @classmethod
    def split(cls, whole, bounds) -> "ClusterParts":
        whole_arrays = getattr(whole, "PER_TRIANGLE", ())
        arrays = [f.name for f in dataclasses.fields(whole) if isinstance(
            getattr(whole, f.name), (torch.Tensor, np.ndarray))
            and f.name not in whole_arrays]

        def part(a, b):
            return dataclasses.replace(
                whole, **{k: getattr(whole, k)[a:b] for k in arrays})
        bounds = tuple((int(a), int(b)) for a, b in bounds)
        return cls(whole=whole, bounds=bounds,
                   parts=tuple(part(a, b) for a, b in bounds))

    # the boxes of all parts (the coherence sort's bounds)
    @property
    def cmin(self) -> torch.Tensor:
        return self.whole.cmin

    @property
    def cmax(self) -> torch.Tensor:
        return self.whole.cmax

    @property
    def num_clusters(self) -> int:
        """Clusters of all parts."""
        return self.whole.num_clusters


@dataclasses.dataclass
class TileClusterSet:
    """The tile mode's cluster set, every array as the JAX package packs it
    (spcbpt_tpu/ops/clusters.py ClusterSet with with_coeff=True)."""
    cmin: torch.Tensor       # (C, 3) cluster AABB min
    cmax: torch.Tensor       # (C, 3)
    coeff: torch.Tensor      # (C, 16, 4K) coefficient blocks of the matmul
                             # walk: outputs grouped by kind, then slot
    tri_block: torch.Tensor  # (C, 16, 128) rows 0..8 = [p0, e1, e2] xyz per
                             # slot, zero-padded; read by K4/K5 and their
                             # plain versions
    tri_begin: torch.Tensor  # (C,) int32 first (reordered) triangle id
    tri_k: int               # triangle slots in use per cluster (K)
    tri_count: torch.Tensor  # (C,) int32 slots up to the cluster's last
                             # nonzero one (the rest are zero and never
                             # hit): the slots kernels K4/K5 test

    @property
    def num_clusters(self) -> int:
        return self.cmin.shape[0]

    def blocks(self) -> torch.Tensor:
        """tri_block, already on the device (ClusterSet.blocks' contract)."""
        return self.tri_block

    @classmethod
    def from_arrays(cls, cmin, cmax, coeff, tri_block, tri_begin, tri_k,
                    device) -> "TileClusterSet":
        """Device tile set from the host arrays of either package."""
        t = lambda a, dt=torch.float32: torch.tensor(
            np.asarray(a), dtype=dt, device=device)
        used = np.any(np.asarray(tri_block)[:, :9, :] != 0, axis=1)
        count = np.where(used.any(axis=1),
                         SLOTS - np.argmax(used[:, ::-1], axis=1), 0)
        return cls(cmin=t(cmin), cmax=t(cmax), coeff=t(coeff),
                   tri_block=t(tri_block), tri_begin=t(tri_begin, torch.int32),
                   tri_k=int(tri_k), tri_count=t(count, torch.int32))


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


def pack_coefficients(p0: np.ndarray, e1: np.ndarray,
                      e2: np.ndarray) -> np.ndarray:
    """(T,3)x3 -> (T, 16, 4) coefficient blocks (see the module docstring).
    Degenerate triangles (zero normal) give det == 0 and never hit."""
    t = len(p0)
    n = np.cross(e1, e2)
    eps = np.zeros((3, 3, 3), np.float64)
    eps[0, 1, 2] = eps[1, 2, 0] = eps[2, 0, 1] = 1.0
    eps[0, 2, 1] = eps[2, 1, 0] = eps[1, 0, 2] = -1.0
    coeff = np.zeros((t, FEAT_DIM, N_OUT), np.float64)
    # u_num: o_i d_j block = sum_k eps_ijk e2_k ; d block = -(e2 x p0)
    coeff[:, 0:9, 0] = np.einsum("ijk,tk->tij", eps, e2).reshape(t, 9)
    coeff[:, 9:12, 0] = -np.cross(e2, p0)
    # v_num: o_i d_j block = -eps_ijk e1_k ; d block = -(p0 x e1)
    coeff[:, 0:9, 1] = -np.einsum("ijk,tk->tij", eps, e1).reshape(t, 9)
    coeff[:, 9:12, 1] = -np.cross(p0, e1)
    # t_num: o block = n ; const = -p0.n
    coeff[:, 12:15, 2] = n
    coeff[:, 15, 2] = -np.sum(p0 * n, axis=-1)
    # det: d block = -n
    coeff[:, 9:12, 3] = -n
    return coeff.astype(np.float32)


def ray_features(o, d):
    """(..., 3) x 2 -> (..., 16) features F = [vec(o d^T), d, o, 1]."""
    od = (o[..., :, None] * d[..., None, :]).reshape(o.shape[:-1] + (9,))
    one = torch.ones(o.shape[:-1] + (1,), dtype=o.dtype, device=o.device)
    return torch.cat([od, d, o, one], dim=-1)


def _pack(flat: FlatBVH, p0, e1, e2, max_tris: int, with_coeff: bool):
    """Host arrays (cmin, cmax, tri_block, tri_begin, coeff or None) of the
    clusters of at most max_tris triangles, packed as the JAX package packs
    them."""
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
    coeff = (np.zeros((c, max_tris, FEAT_DIM, N_OUT), np.float32)
             if with_coeff else None)
    for ci, (lo, hi, node) in enumerate(cl):
        if with_coeff:
            coeff[ci, :hi - lo] = pack_coefficients(p0[lo:hi], e1[lo:hi],
                                                    e2[lo:hi])
        raw = np.concatenate([p0[lo:hi], e1[lo:hi], e2[lo:hi]], axis=1)
        tri_block[ci, :9, :hi - lo] = raw.T
        cmin[ci] = flat.bounds_min[node]
        cmax[ci] = flat.bounds_max[node]
        begin[ci] = lo
    if with_coeff:
        # (C, K, 16, 4) -> (C, 16, 4K): outputs grouped by kind, then slot
        coeff = coeff.transpose(0, 2, 3, 1).reshape(c, FEAT_DIM,
                                                    N_OUT * max_tris)
    return cmin, cmax, tri_block, begin, coeff


def build_clusters(flat: FlatBVH, p0: np.ndarray, e1: np.ndarray,
                   e2: np.ndarray, max_tris: int = SLOTS,
                   device="cpu") -> ClusterSet:
    """The row walk's ClusterSet from a flattened BVH and the REORDERED
    triangle arrays (p0/e1/e2 already permuted by flat.order)."""
    cmin, cmax, tri_block, begin, _ = _pack(flat, p0, e1, e2, max_tris,
                                            with_coeff=False)
    return ClusterSet.from_arrays(cmin, cmax, tri_block, begin, len(p0),
                                  device, flat.order)


def part_bounds(begin, end, part_max_tris: int,
                max_clusters: int = MAX_CLUSTERS) -> list:
    """Cut consecutive clusters, triangles begin[i]:end[i], into ranges:
    JAX's rule (a new part wherever a cluster would end more than
    part_max_tris triangles past its part's first triangle), and at most
    max_clusters clusters a part (what one K1/K2 block holds in shared
    memory). Returns [(first cluster, end), ...]."""
    bounds, first = [], 0
    base = int(begin[0]) if len(begin) else 0
    for i, (lo, hi) in enumerate(zip(begin.tolist(), end.tolist())):
        if i > first and (hi - base > part_max_tris
                          or i - first >= max_clusters):
            bounds.append((first, i))
            first, base = i, lo
    bounds.append((first, len(begin)))
    return bounds


def even_bounds(count: int, max_clusters: int) -> list:
    """The fewest near-equal contiguous ranges (their sizes differ by at
    most one) of `count` clusters with at most max_clusters each:
    [(first cluster, end), ...]."""
    if max_clusters < 1:
        raise ValueError(f"max_clusters {max_clusters} below 1")
    k = max(1, -(-count // max_clusters))
    edges = [count * i // k for i in range(k + 1)]
    return list(zip(edges[:-1], edges[1:]))


def build_cluster_parts(flat: FlatBVH, p0, e1, e2, max_tris: int = SLOTS,
                        part_max_tris: int = 120_000,
                        max_clusters: int = MAX_CLUSTERS,
                        device="cpu") -> ClusterParts:
    """The row walk's set of a large scene (JAX's build_cluster_parts): the
    BVH cut once into clusters of at most max_tris triangles, then split by
    `part_bounds`. Where max_clusters does not bind, the parts are JAX's,
    whose tri_begin is local to the part (add JAX's tri_base)."""
    cmin, cmax, tri_block, begin, _ = _pack(flat, p0, e1, e2, max_tris,
                                            with_coeff=False)
    whole = ClusterSet.from_arrays(cmin, cmax, tri_block, begin, len(p0),
                                   device, flat.order)
    end = np.append(begin[1:], len(p0))
    return ClusterParts.split(whole, part_bounds(begin, end, part_max_tris,
                                                 max_clusters))


def build_tile_clusters(flat: FlatBVH, p0: np.ndarray, e1: np.ndarray,
                        e2: np.ndarray, max_tris: int,
                        device="cpu") -> TileClusterSet:
    """The tile mode's TileClusterSet (K = max_tris) from a flattened BVH
    and the REORDERED triangle arrays."""
    cmin, cmax, tri_block, begin, coeff = _pack(flat, p0, e1, e2, max_tris,
                                                with_coeff=True)
    return TileClusterSet.from_arrays(cmin, cmax, coeff, tri_block, begin,
                                      max_tris, device)

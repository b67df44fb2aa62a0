"""Binned-SAH BVH build (host) + stackless skip-link flattening.

Replaces the reference's OptiX GAS/IAS builds (reference: sutil/Scene.cpp
buildMeshAccels:943, buildInstanceAccel:1260) with a software BVH laid out for
TPU traversal: nodes in depth-first order, so an interior node's left child is
`node+1` and every node stores a single "skip" escape index. Traversal needs no
stack — one int per lane (see spcbpt_tpu/ops/traverse.py).

Leaves reference a contiguous range of reordered triangles, so leaf tests are
dense vector loads. A native C++ builder (native/bvh_builder.cpp) accelerates
large scenes; this numpy implementation is the reference.

The port's own copy of spcbpt_tpu/ops/bvh.py. The native C++ code and
`build_bvh_numpy` give different trees, so `build_bvh` takes the route the
JAX package takes on the same host: native where g++ is on the PATH (a
failed build or call raises), numpy only where there is no compiler.
BUILD_ROUTE records the route of the last build.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 4
N_BINS = 16
BUILD_ROUTE = None   # "native" or "numpy": the route of the last build_bvh


@dataclasses.dataclass
class FlatBVH:
    bounds_min: np.ndarray   # (N, 3) float32
    bounds_max: np.ndarray   # (N, 3) float32
    skip: np.ndarray         # (N,) int32 — node to visit on miss / after leaf
    leaf_start: np.ndarray   # (N,) int32 — first triangle (leaves), -1 interior
    leaf_count: np.ndarray   # (N,) int32
    order: np.ndarray        # (T,) int64 — new-to-old triangle permutation
    max_depth: int


def _build_recursive(cent, bmin, bmax, idx, nodes, depth):
    """Append (bounds, leaf range or children) nodes; returns node index."""
    lo = bmin[idx].min(axis=0)
    hi = bmax[idx].max(axis=0)
    my = len(nodes)
    nodes.append(None)  # placeholder

    if len(idx) <= LEAF_SIZE or depth > 60:
        nodes[my] = (lo, hi, None, None, idx, depth)
        return my

    c = cent[idx]
    clo, chi = c.min(axis=0), c.max(axis=0)
    ext = chi - clo
    axis = int(np.argmax(ext))
    if ext[axis] < 1e-12:
        # degenerate spread: median split on original order
        half = len(idx) // 2
        left_idx, right_idx = idx[:half], idx[half:]
    else:
        # binned SAH
        rel = (c[:, axis] - clo[axis]) / ext[axis]
        bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
        best_cost, best_split = np.inf, None
        # prefix/suffix bounds over bins
        counts = np.bincount(bins, minlength=N_BINS)
        bin_lo = np.full((N_BINS, 3), np.inf, np.float64)
        bin_hi = np.full((N_BINS, 3), -np.inf, np.float64)
        for b in range(N_BINS):
            m = bins == b
            if counts[b]:
                bin_lo[b] = bmin[idx][m].min(axis=0)
                bin_hi[b] = bmax[idx][m].max(axis=0)
        pre_lo = np.minimum.accumulate(bin_lo, axis=0)
        pre_hi = np.maximum.accumulate(bin_hi, axis=0)
        suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
        suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
        pre_n = np.cumsum(counts)

        def area(lo_, hi_):
            d = np.maximum(hi_ - lo_, 0.0)
            return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

        for b in range(N_BINS - 1):
            nl = pre_n[b]
            nr = len(idx) - nl
            if nl == 0 or nr == 0:
                continue
            cost = nl * area(pre_lo[b], pre_hi[b]) + nr * area(suf_lo[b + 1], suf_hi[b + 1])
            if cost < best_cost:
                best_cost, best_split = cost, b
        if best_split is None:
            half = len(idx) // 2
            order = np.argsort(c[:, axis], kind="stable")
            left_idx, right_idx = idx[order[:half]], idx[order[half:]]
        else:
            m = bins <= best_split
            left_idx, right_idx = idx[m], idx[~m]

    _build_recursive(cent, bmin, bmax, left_idx, nodes, depth + 1)
    right = _build_recursive(cent, bmin, bmax, right_idx, nodes, depth + 1)
    nodes[my] = (lo, hi, None, right, None, depth)
    return my


def build_bvh(tri_p0: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray) -> FlatBVH:
    """Build from triangles given as (p0, e1, e2) arrays of shape (T, 3)."""
    global BUILD_ROUTE
    from ..native import loader

    if loader.get_lib() is None:
        BUILD_ROUTE = "numpy"
        return build_bvh_numpy(tri_p0, tri_e1, tri_e2)
    BUILD_ROUTE = "native"
    return loader.native_build_bvh(tri_p0, tri_e1, tri_e2, LEAF_SIZE)


def build_bvh_numpy(tri_p0, tri_e1, tri_e2) -> FlatBVH:
    p0 = np.asarray(tri_p0, np.float64)
    p1 = p0 + np.asarray(tri_e1, np.float64)
    p2 = p0 + np.asarray(tri_e2, np.float64)
    bmin = np.minimum(np.minimum(p0, p1), p2)
    bmax = np.maximum(np.maximum(p0, p1), p2)
    cent = (bmin + bmax) * 0.5

    T = len(p0)
    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        nodes: list = []
        _build_recursive(cent, bmin, bmax, np.arange(T), nodes, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    n = len(nodes)
    out_min = np.zeros((n, 3), np.float32)
    out_max = np.zeros((n, 3), np.float32)
    skip = np.zeros(n, np.int32)
    leaf_start = np.full(n, -1, np.int32)
    leaf_count = np.zeros(n, np.int32)
    order: list = []
    max_depth = 0

    # In DFS order, a node's subtree occupies [i, subtree_end); skip = subtree_end.
    # subtree_end(leaf) = i+1; subtree_end(interior i with right child r) =
    # subtree_end(r). Compute by scanning right-to-left.
    subtree_end = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        lo, hi, _, right, idx, depth = nodes[i]
        max_depth = max(max_depth, depth)
        out_min[i] = lo
        out_max[i] = hi
        if idx is not None:
            subtree_end[i] = i + 1
        else:
            subtree_end[i] = subtree_end[right]
    for i in range(n):
        lo, hi, _, right, idx, depth = nodes[i]
        skip[i] = subtree_end[i]
        if idx is not None:
            leaf_start[i] = len(order)
            leaf_count[i] = len(idx)
            order.extend(idx.tolist())

    return FlatBVH(bounds_min=out_min, bounds_max=out_max, skip=skip,
                   leaf_start=leaf_start, leaf_count=leaf_count,
                   order=np.asarray(order, np.int64), max_depth=max_depth)

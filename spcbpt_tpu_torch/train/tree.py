"""Octree "class tree" classifier — reference-parity alternative to the
nearest-centroid classifier of train/classify.py.

Port of spcbpt_tpu/train/tree.py. The reference accelerates
nearest-centroid labeling with an 8-way mid-split tree over position
(alternating a normal split at a fixed depth cadence), grown until 99% of
sample weight in each leaf agrees on one label or depth 15 (reference:
classTree_host.h:103-431, classTree_common.h:11-62). `build_tree` is the
JAX package's host numpy code, so both packages build the same arrays;
`tree_lookup` walks it on tensors, a fixed MAX_DEPTH+2 steps for every
lane. No renderer calls it: it is an accuracy cross-check of the centroid
rule.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

TYPE_POSITION = 0
TYPE_NORMAL = 1

MAX_DEPTH = 15
PURITY = 0.99
MIN_LEAF = 2
# depth cadence at which a normal split is used instead of position
NORMAL_SPLIT_EVERY = 2


@dataclasses.dataclass
class FlatTree:
    mid: np.ndarray      # (N, 3)
    child: np.ndarray    # (N, 8) int32, -1 absent
    label: np.ndarray    # (N,) int32
    node_type: np.ndarray  # (N,) int32 (position/normal)
    leaf: np.ndarray     # (N,) bool


def _majority(labels, weights):
    lab = np.bincount(labels, weights=weights)
    best = int(lab.argmax())
    total = weights.sum()
    purity = lab[best] / total if total > 0 else 1.0
    return best, purity


def _octant(key, mid):
    return ((key[:, 0] > mid[0]).astype(int)
            + 2 * (key[:, 1] > mid[1]).astype(int)
            + 4 * (key[:, 2] > mid[2]).astype(int))


def _leaf(label, node_type):
    return dict(mid=np.zeros(3), child=np.full(8, -1), label=label,
                type=node_type, leaf=True)


def build_tree(pos, normal, labels, weights, max_depth: int = MAX_DEPTH,
               purity: float = PURITY) -> FlatTree:
    pos = np.asarray(pos, np.float64)
    normal = np.asarray(normal, np.float64)
    labels = np.asarray(labels, np.int64)
    weights = np.asarray(weights, np.float64)

    nodes = []

    def grow(idx, depth):
        my = len(nodes)
        nodes.append(None)
        best, pur = _majority(labels[idx], weights[idx])
        node_type = (TYPE_NORMAL if (depth % NORMAL_SPLIT_EVERY
                                     == NORMAL_SPLIT_EVERY - 1)
                     else TYPE_POSITION)
        key = pos if node_type == TYPE_POSITION else normal
        if pur >= purity or depth >= max_depth or len(idx) <= MIN_LEAF:
            nodes[my] = _leaf(best, node_type)
            return my
        mid = np.median(key[idx], axis=0)
        octant = _octant(key[idx], mid)
        n_nonempty = len(np.unique(octant))
        if n_nonempty <= 1:
            # degenerate split (e.g. identical normals): fall back to the
            # other key before giving up
            node_type = (TYPE_POSITION if node_type == TYPE_NORMAL
                         else TYPE_NORMAL)
            key = pos if node_type == TYPE_POSITION else normal
            mid = np.median(key[idx], axis=0)
            octant = _octant(key[idx], mid)
            n_nonempty = len(np.unique(octant))
        child = np.full(8, -1, np.int64)
        if n_nonempty <= 1:
            nodes[my] = _leaf(best, node_type)
            return my
        for o in range(8):
            sub = idx[octant == o]
            if len(sub):
                child[o] = grow(sub, depth + 1)
        # empty octants share one leaf with this node's majority label
        fallback = None
        for o in range(8):
            if child[o] < 0:
                if fallback is None:
                    fallback = len(nodes)
                    nodes.append(_leaf(best, node_type))
                child[o] = fallback
        nodes[my] = dict(mid=mid, child=child, label=best, type=node_type,
                         leaf=False)
        return my

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        grow(np.arange(len(pos)), 0)
    finally:
        sys.setrecursionlimit(old)

    return FlatTree(
        mid=np.stack([nd["mid"] for nd in nodes]).astype(np.float32),
        child=np.stack([nd["child"] for nd in nodes]).astype(np.int32),
        label=np.asarray([nd["label"] for nd in nodes], np.int32),
        node_type=np.asarray([nd["type"] for nd in nodes], np.int32),
        leaf=np.asarray([nd["leaf"] for nd in nodes], bool),
    )


def tree_lookup(tree: FlatTree, pos, normal, max_steps: int = MAX_DEPTH + 2):
    """Label query (classTree_common.h tree_index:39-52) on (N, 3) float32
    tensors: every lane walks from the root picking the octant of
    (position|normal) against the node's mid, max_steps steps, staying on a
    leaf once there."""
    dev = pos.device
    t = lambda a: torch.as_tensor(a, device=dev)
    mid, child, label = t(tree.mid), t(tree.child).long(), t(tree.label)
    by_pos, leaf = t(tree.node_type) == TYPE_POSITION, t(tree.leaf)
    node = torch.zeros(pos.shape[0], dtype=torch.int64, device=dev)
    for _ in range(max_steps):
        m = mid[node]
        key = torch.where(by_pos[node][:, None], pos, normal)
        octant = ((key[:, 0] > m[:, 0]).long() + 2 * (key[:, 1] > m[:, 1]).long()
                  + 4 * (key[:, 2] > m[:, 2]).long())
        nxt = child[node, octant]
        node = torch.where(leaf[node] | (nxt < 0), node, nxt)
    return label[node]


def tree_accuracy(tree: FlatTree, pos, normal, labels, device="cpu") -> float:
    """Fraction of samples the tree labels like the training labels — the
    reference prints this as 'acc:n/m' (classTree_host.h:392)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    got = tree_lookup(tree, f32(pos), f32(normal)).cpu().numpy()
    return float((got == np.asarray(labels)).mean())

"""Subspace classification and the render-time subspace state.

Port of the runtime side of spcbpt_tpu/train/classify.py: the centroid
classifier (weighted-quantile centroids, exact nearest-centroid labels as
one (N,6)x(6,C) product; classTree_host.h:302-352, classTree_common.h:82-90)
and SubspaceState, which carries Q, Gamma as row CMFs and the published
lookup tables (subspaceMacroInfo, optixPathTracer.h:166-189), with the
untrained defaults (label 0, gamma_ss == 1). `synthetic_trained_state`
makes a fully trained-shaped state without training (train/pipeline.py
trains one). `from_jax_state` carries a JAX SubspaceState over, array by
array.

The label product runs in full float32 on every device: `classify` raises
on a CUDA tensor while TF32 matmuls are allowed (`use_fp32_matmul` turns
them off), since reduced precision flipped 48.8% of labels in the JAX
package's record (ARCHITECTURE.md:30-36).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import (CONSERVATIVE_RATE, NUM_SUBSPACE,
                      NUM_SUBSPACE_LIGHTSOURCE)
from ..utils import vec

NUM_LIGHT_TREE_SUBSPACE = NUM_SUBSPACE - NUM_SUBSPACE_LIGHTSOURCE  # 800


@dataclasses.dataclass
class Classifier:
    centers_pos: torch.Tensor    # (C, 3)
    centers_norm: torch.Tensor   # (C, 3)
    diag2: torch.Tensor          # () scene position variance
    label_bias: int = 0


@dataclasses.dataclass
class SubspaceState:
    """Field for field the JAX SubspaceState; see its docstrings for what
    each table is for."""
    eye: Classifier
    light: Classifier
    q: torch.Tensor                      # (NUM_SUBSPACE,) mean light flux
    cmf_gamma: torch.Tensor              # (NUM_SUBSPACE, NUM_SUBSPACE) row CMFs
    alias_prob: torch.Tensor = None      # (NUM_SUBSPACE, NUM_SUBSPACE)
    alias_idx: torch.Tensor = None       # (NUM_SUBSPACE, NUM_SUBSPACE) int32
    inv_occ: torch.Tensor = None         # (NUM_SUBSPACE,) paths per vertex
    # derived by publish_tables, not serialized
    gamma_pmf: torch.Tensor = None       # (NUM_SUBSPACE, NUM_SUBSPACE)
    alias_pack: torch.Tensor = None      # (NUM_SUBSPACE, NUM_SUBSPACE, 4)
    # close-set refinement network (nn_classifier.NNTables): when set, the
    # first-stage light-subspace pick blends Gamma with its distribution
    # (lvc.sample_first_stage) — reference C21 behind --classifier nn
    nn: object = None
    trained: bool = False
    # the second-stage sampler this state is calibrated for: "mixture",
    # "uniform" or "weighted"; rmis and the renderers key off it
    second_stage: str = "mixture"

    def replace(self, **kw) -> "SubspaceState":
        return dataclasses.replace(self, **kw)


def use_fp32_matmul() -> None:
    """Full-float32 matrix products on the card (no TF32), as `classify`
    and the close-set network require."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def require_fp32_matmul(t: torch.Tensor) -> None:
    """Raises when a product on the card would take TF32 inputs."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                      torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("full-float32 matmuls are needed on the card: "
                           "call classify.use_fp32_matmul() first")


def dummy_classifier(n_labels: int = 1, device="cpu") -> Classifier:
    return Classifier(centers_pos=torch.zeros((n_labels, 3), device=device),
                      centers_norm=torch.zeros((n_labels, 3), device=device),
                      diag2=torch.tensor(1.0, device=device))


def untrained_state(device="cpu") -> SubspaceState:
    row = torch.cumsum(torch.full((NUM_SUBSPACE,), 1.0 / NUM_SUBSPACE,
                                  device=device), dim=0)
    return SubspaceState(
        eye=dummy_classifier(device=device),
        light=dummy_classifier(device=device),
        q=torch.ones((NUM_SUBSPACE,), device=device),
        cmf_gamma=row.expand(NUM_SUBSPACE, NUM_SUBSPACE),
        alias_prob=torch.ones((1, 1), device=device),
        alias_idx=torch.zeros((1, 1), dtype=torch.int32, device=device),
        trained=False)


def synthetic_trained_state(ts, seed: int = 0,
                            second_stage: str = "mixture") -> SubspaceState:
    """Miniature but fully trained-shaped state for dry runs and tests, on
    the scene's device: real classifiers (centers seeded from the scene's
    triangle vertices), a random row-normalized Gamma with alias tables,
    positive Q/inv_occ, and published lookup tables. The same random draws
    as the JAX function, so both packages build the same state."""
    from . import qgamma

    dev = ts.device
    rng = np.random.default_rng(seed)
    p0 = ts.tri_p0.cpu().numpy().astype(np.float64)
    e1 = ts.tri_e1.cpu().numpy().astype(np.float64)
    e2 = ts.tri_e2.cpu().numpy().astype(np.float64)
    pts = np.concatenate([p0, p0 + e1, p0 + e2])
    nrm = np.cross(e1, e2)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    nrm = np.concatenate([nrm, nrm, nrm])
    w = np.ones(len(pts))
    eye_cls = build_classifier(pts, nrm, w, NUM_SUBSPACE, device=dev)
    light_cls = build_classifier(pts, nrm, w, NUM_LIGHT_TREE_SUBSPACE,
                                 device=dev)

    gamma = rng.random((NUM_SUBSPACE, NUM_SUBSPACE)) + 0.1
    gamma = gamma / gamma.sum(axis=1, keepdims=True)
    mixed = gamma * (1.0 - CONSERVATIVE_RATE) + CONSERVATIVE_RATE / NUM_SUBSPACE
    aprob, aidx = build_alias(mixed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    q = f32(rng.random(NUM_SUBSPACE).astype(np.float32) + 0.5)
    inv_occ = f32(rng.random(NUM_SUBSPACE).astype(np.float32) + 0.5)
    return publish_tables(SubspaceState(
        eye=eye_cls, light=light_cls, q=q,
        cmf_gamma=qgamma.gamma_to_cmf(f32(gamma)),
        alias_prob=f32(aprob),
        alias_idx=torch.tensor(aidx, dtype=torch.int32, device=dev),
        inv_occ=inv_occ, trained=True, second_stage=second_stage))


def build_alias(gamma: np.ndarray):
    """Row-wise Vose alias tables for the (conservative-mixed) Gamma rows.
    Returns (prob (S,S) f32, alias (S,S) i32): sample u1 -> column j =
    floor(u1*S); accept j if frac < prob[row, j] else alias[row, j]."""
    g = np.asarray(gamma, np.float64)
    s_rows, n = g.shape
    g = g / np.maximum(g.sum(axis=1, keepdims=True), 1e-30)
    prob = np.ones((s_rows, n), np.float32)
    alias = np.tile(np.arange(n, dtype=np.int32), (s_rows, 1))
    scaled_all = g * n
    for r in range(s_rows):
        scaled = scaled_all[r].copy()
        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] >= 1.0]
        while small and large:
            s_i = small.pop()
            l_i = large.pop()
            prob[r, s_i] = scaled[s_i]
            alias[r, s_i] = l_i
            scaled[l_i] = scaled[l_i] - (1.0 - scaled[s_i])
            (small if scaled[l_i] < 1.0 else large).append(l_i)
        for i in small + large:
            prob[r, i] = 1.0
    return prob, alias


def classify(c: Classifier, pos, normal):
    """argmin_i |p-ci|^2 + diag2*(1 - n.nci)  (classTree_common.h:82-90;
    direction term dropped as in the reference, DIR_JUDGE=0), computed as
    one matrix product on (pos, normal) features, recentred on the centroid
    cloud as in the JAX package (the score is translation-invariant, and
    |ci|^2 - 2 p.ci loses the label information once |coords|^2 * eps
    reaches the spacing between scores)."""
    require_fp32_matmul(pos)
    anchor = torch.mean(c.centers_pos, dim=0)
    feat = torch.cat([pos - anchor, normal * (0.5 * c.diag2)], dim=-1)
    cpos = c.centers_pos - anchor
    cfeat = torch.cat([cpos, c.centers_norm], dim=-1)
    # score_i = |ci|^2 - 2 p.ci - diag2 n.nci   (|p|^2, diag2 const dropped)
    bias = vec.dot(cpos, cpos)
    score = bias - 2.0 * torch.matmul(feat, cfeat.T)
    return (torch.argmin(score, dim=-1) + c.label_bias).to(torch.int32)


def label_eye(ss: SubspaceState, pos, normal):
    """Eye-side subspace label (labelUnit::getLabel cuProg.h:1109-1123:
    0 until the tree exists)."""
    if not ss.trained:
        return torch.zeros(pos.shape[:-1], dtype=torch.int32,
                           device=pos.device)
    return classify(ss.eye, pos, normal)


def label_light(ss: SubspaceState, pos, normal):
    if not ss.trained:
        return torch.zeros(pos.shape[:-1], dtype=torch.int32,
                           device=pos.device)
    return classify(ss.light, pos, normal)


def gamma_block(ss: SubspaceState, eye_id, light_id):
    """Gamma(eye, light) (optixPathTracer.h:173-180): one gather from the
    published pmf matrix, else recovered from the row CMF (two gathers)."""
    if ss.gamma_pmf is not None:
        return ss.gamma_pmf[eye_id.long(), light_id.long()]
    flat = ss.cmf_gamma.reshape(-1)
    idx = eye_id.long() * NUM_SUBSPACE + light_id.long()
    c = flat[idx]
    prev = flat[torch.clamp(idx - 1, min=0)]
    return torch.where(light_id == 0, c, c - prev)


def publish_tables(ss: SubspaceState) -> SubspaceState:
    """Derive the render-time lookup tables (gamma_pmf, alias_pack) from the
    serialized state. Called after building a state and after checkpoint
    load."""
    if not ss.trained:
        return ss
    cmf = ss.cmf_gamma
    pmf = torch.diff(cmf, dim=1, prepend=torch.zeros_like(cmf[:, :1]))
    pack = None
    if ss.alias_prob is not None and ss.alias_prob.shape[0] == NUM_SUBSPACE:
        rows = torch.arange(NUM_SUBSPACE, device=cmf.device)[:, None]
        idx = ss.alias_idx.long()
        pack = torch.stack([
            ss.alias_prob,
            ss.alias_idx.to(torch.float32),    # ids < 2^24, exact
            pmf,                               # pmf when j accepted
            pmf[rows, idx],                    # pmf when aliased
        ], dim=-1)
    return ss.replace(gamma_pmf=pmf, alias_pack=pack)


def gamma_ss(ss: SubspaceState, eye_id, light_id):
    """Connect-rate kernel Gamma/Q (optixPathTracer.h:182-189); 1 when
    untrained."""
    if not ss.trained:
        shape = torch.broadcast_shapes(eye_id.shape, light_id.shape)
        return torch.ones(shape, device=eye_id.device)
    return gamma_block(ss, eye_id, light_id) / ss.q[light_id.long()]


def build_classifier(pos: np.ndarray, normal: np.ndarray, weight: np.ndarray,
                     n_labels: int, label_bias: int = 0,
                     max_samples: int = 100_000, device="cpu") -> Classifier:
    """Weighted-quantile centroid seeding (classTree_host.h:313-322): walk the
    samples accumulating weight; every time the accumulator crosses
    total/n_labels, the current sample becomes a centroid."""
    pos = np.asarray(pos, np.float64)
    normal = np.asarray(normal, np.float64)
    weight = np.asarray(weight, np.float64)
    if len(pos) > max_samples:
        sel = np.random.default_rng(0).choice(len(pos), max_samples,
                                              replace=False)
        pos, normal, weight = pos[sel], normal[sel], weight[sel]
    mean = pos.mean(axis=0)
    var = ((pos - mean) ** 2).sum(axis=0) / max(len(pos) - 1, 1)
    diag2 = float(var.max())

    total = weight.sum()
    step = total / n_labels
    acc = np.cumsum(weight)
    # indices where the accumulator crosses each multiple of `step`
    ticks = np.searchsorted(acc, step * (1 + np.arange(n_labels)), side="right")
    ticks = np.unique(np.clip(ticks, 0, len(pos) - 1))
    cp = pos[ticks]
    cn = normal[ticks]
    if len(cp) < n_labels:  # pad by repeating last center
        reps = n_labels - len(cp)
        cp = np.concatenate([cp, np.repeat(cp[-1:], reps, axis=0)])
        cn = np.concatenate([cn, np.repeat(cn[-1:], reps, axis=0)])
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return Classifier(centers_pos=f32(cp), centers_norm=f32(cn),
                      diag2=f32(diag2), label_bias=label_bias)


def from_jax_state(jss, device) -> SubspaceState:
    """The port's SubspaceState from a JAX spcbpt_tpu SubspaceState, whose
    arrays are read as numpy (no jax import here), its close-set network
    included."""
    from . import nn_classifier

    def t(x, dt=torch.float32):
        return None if x is None else torch.tensor(np.asarray(x), dtype=dt,
                                                   device=device)

    def cls(c):
        return Classifier(centers_pos=t(c.centers_pos),
                          centers_norm=t(c.centers_norm), diag2=t(c.diag2),
                          label_bias=int(c.label_bias))

    return SubspaceState(
        eye=cls(jss.eye), light=cls(jss.light), q=t(jss.q),
        cmf_gamma=t(jss.cmf_gamma), alias_prob=t(jss.alias_prob),
        alias_idx=t(jss.alias_idx, torch.int32), inv_occ=t(jss.inv_occ),
        gamma_pmf=t(jss.gamma_pmf), alias_pack=t(jss.alias_pack),
        nn=None if jss.nn is None
        else nn_classifier.from_jax_tables(jss.nn, device),
        trained=bool(jss.trained), second_stage=str(jss.second_stage))

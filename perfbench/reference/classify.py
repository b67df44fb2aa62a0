"""Subspace classification and the render-time subspace state.

The benchmark's plain reference: a frozen copy of
`spcbpt_tpu_torch/train/classify.py` (what the rendered configurations use;
skies, textures and the close-set network left out), importing
nothing of the program. Float tensors take torch's default dtype,
so that the control runs it in bfloat16.

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

from .consts import CONSERVATIVE_RATE, NUM_SUBSPACE
from . import vec



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
        # the table holds ids, so it is float32 whatever the computation's
        # precision
        pack = torch.stack([
            ss.alias_prob.to(torch.float32),
            ss.alias_idx.to(torch.float32),    # ids < 2^24, exact
            pmf.to(torch.float32),             # pmf when j accepted
            pmf[rows, idx].to(torch.float32),  # pmf when aliased
        ], dim=-1)
    return ss.replace(gamma_pmf=pmf, alias_pack=pack)


def gamma_ss(ss: SubspaceState, eye_id, light_id):
    """Connect-rate kernel Gamma/Q (optixPathTracer.h:182-189); 1 when
    untrained."""
    if not ss.trained:
        shape = torch.broadcast_shapes(eye_id.shape, light_id.shape)
        return torch.ones(shape, device=eye_id.device)
    return gamma_block(ss, eye_id, light_id) / ss.q[light_id.long()]


def gamma_to_cmf(gamma: torch.Tensor) -> torch.Tensor:
    """Conservative 20% uniform mix, then row CMFs pinned to 1 (the
    program's train/qgamma.gamma_to_cmf)."""
    t = CONSERVATIVE_RATE
    g = gamma * (1.0 - t) + t / NUM_SUBSPACE
    cmf = torch.cumsum(g, dim=1)
    cmf[:, -1] = 1.0
    return cmf

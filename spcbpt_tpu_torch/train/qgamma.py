"""Subspace statistics: Q estimation, training-sample reweighting, Gamma
initialization, and the Gamma -> CMF publication step.

Port of spcbpt_tpu/train/qgamma.py. Behavior contracts:
- Q (reference MyThrustOp::preprocess_getQ device_thrust.cu:347-409): per
  subspace, the mean cached-vertex weight (float3weight(flux)/pdf) per traced
  light path, streamed over launches as an incremental average; zero entries
  become +inf-like so gamma_ss ~ 0 (Q_zero_handle :335-346).
- sample_reweight (device_thrust.cu:574-623): training-path contributions are
  normalized by the mean contribution of their 10x10-pixel block.
- Gamma init (preprocess_getGamma device_thrust.cu:627-667): Gamma[e,l] +=
  min(contri/sample_pdf, 10) over every connection of every path, then
  row-normalized with uniform fallback.
- CMF publication (Gamma2CMFGamma device_thrust.cu:3406-3433): 20% uniform
  mixture then row cumulative sums with the last entry pinned to 1.
"""
from __future__ import annotations

import torch

from ..config import CONSERVATIVE_RATE, NUM_SUBSPACE
from ..render.vertex import LightVertices, reshape_flat
from ..utils import vec

Q_INF = 3.4e38


def q_batch(lv: LightVertices):
    """Per-subspace summed weight, vertex counts, path count for one
    light-trace launch. Returns (q_sum (N,), occ_count (N,), path_count ()
    int32 tensor)."""
    flat = reshape_flat(lv)
    dev = flat.valid.device
    w = vec.float3weight(flat.ratio)
    w = torch.where(torch.isnan(w) | torch.isinf(w) | ~flat.valid, 0.0, w)
    lab = torch.clamp(flat.subspace_id, 0, NUM_SUBSPACE - 1).long()
    q = torch.zeros(NUM_SUBSPACE, device=dev).index_add_(0, lab, w)
    occ = torch.zeros(NUM_SUBSPACE, device=dev).index_add_(
        0, lab, flat.valid.to(torch.float32))
    paths = torch.sum(flat.valid & (flat.depth == 0)).to(torch.int32)
    return q, occ, paths


def q_update(q_mean, acc_paths, q_sum, batch_paths):
    """Incremental average over launches (device_thrust.cu:378-408):
    new_mean = mean*(1-t) + batch_mean*t, t = batch/total."""
    total = acc_paths + batch_paths
    t = batch_paths.to(torch.float32) / torch.clamp(
        total.to(torch.float32), min=1.0)
    batch_mean = q_sum / torch.clamp(batch_paths.to(torch.float32), min=1.0)
    return q_mean * (1.0 - t) + batch_mean * t, total


def q_finalize(q_mean):
    """Q_zero_handle: zero -> FLT_MAX so 1/Q ~ 0."""
    return torch.where(q_mean == 0.0, Q_INF, q_mean)


def inv_occ_finalize(occ_total, paths_total):
    """paths/vertices per subspace: the uniform-second-stage weight
    normalizer (classify.SubspaceState.inv_occ). Empty subspaces get 0 —
    the strategy cannot sample them (n_l = 0 draws are rejected)."""
    paths = torch.clamp(paths_total.to(torch.float32), min=1.0)
    return torch.where(occ_total > 0.0,
                       paths / torch.clamp(occ_total, min=1.0), 0.0)


def sample_reweight(contri, sample_pdf, pixel, width: int, height: int,
                    block: int = 10):
    """Spatial normalization of training contributions
    (device_thrust.cu:574-623): contri /= (block_weight_sum/100 + 0.1)."""
    px = torch.clamp((pixel[:, 0].to(torch.float32) / 65535.0 * width)
                     .to(torch.int32), 0, width - 1)
    py = torch.clamp((pixel[:, 1].to(torch.float32) / 65535.0 * height)
                     .to(torch.int32), 0, height - 1)
    bw = (width + block - 1) // block
    bh = (height + block - 1) // block
    bid = ((px // block) + (py // block) * bw).long()
    ww = vec.float3weight(contri) / torch.clamp(sample_pdf, min=1e-30)
    ww = torch.where(torch.isnan(ww) | torch.isinf(ww), 0.0, ww)
    sums = torch.zeros(bw * bh, device=contri.device).index_add_(0, bid, ww)
    w = sums[bid] / 100.0 + 0.1
    return contri / w[:, None]


def gamma_init(label_a, label_b, conn_valid, contri, sample_pdf):
    """Gamma[e,l] += min(path_weight, 10) per connection; row-normalize
    (device_thrust.cu:627-667). Args shaped (P, C) / (P, ...)."""
    w = vec.float3weight(contri) / torch.clamp(sample_pdf, min=1e-30)
    w = torch.where(torch.isnan(w) | torch.isinf(w), 0.0,
                    torch.clamp(w, max=10.0))
    wc = torch.where(conn_valid, w[:, None].expand(label_a.shape), 0.0)
    flat_idx = (torch.clamp(label_a, 0, NUM_SUBSPACE - 1).long() * NUM_SUBSPACE
                + torch.clamp(label_b, 0, NUM_SUBSPACE - 1).long()).reshape(-1)
    g = torch.zeros(NUM_SUBSPACE * NUM_SUBSPACE, device=contri.device)
    g = g.index_add_(0, flat_idx, wc.reshape(-1))
    g = g.reshape(NUM_SUBSPACE, NUM_SUBSPACE)
    row = torch.sum(g, dim=1, keepdim=True)
    uniform = torch.full_like(g, 1.0 / NUM_SUBSPACE)
    return torch.where(row > 1e-10, g / torch.clamp(row, min=1e-30), uniform)


def gamma_to_cmf(gamma: torch.Tensor) -> torch.Tensor:
    """Conservative 20% uniform mix, then row CMFs pinned to 1."""
    t = CONSERVATIVE_RATE
    g = gamma * (1.0 - t) + t / NUM_SUBSPACE
    cmf = torch.cumsum(g, dim=1)
    cmf[:, -1] = 1.0
    return cmf

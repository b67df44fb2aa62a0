"""Gamma (subspace sampling matrix) training with Adam + autograd.

Port of spcbpt_tpu/train/gamma_train.py. The reference trains E =
row-normalized sigmoid(theta), conservative-mixed, to minimize the expected
second-moment loss of the SPCBPT estimator:
    loss(path) = f^2/sample_pdf / (fix_pdf + sum_conns E[e,l]*peak/Q[l])
(reference: matrix_parameter device_thrust.cu:1561-1707, Adam :1437-1559,
train_optimal_E :3327-3344; batch 20000, 1 epoch, lr 0.01, theta
init by inverse sigmoid of the contribution-integral Gamma). The gradient
comes from autograd (the gather e[label_e] and its scatter-add backward,
plain torch ops), the optimiser is torch.optim.Adam, optax's adam formula
m_hat / (sqrt(v_hat) + eps), and NaN gradient entries are set to 0 before
each step as optax.zero_nans() does (+-inf stay).

Training data layout: per path, connections padded to PRETRACE_CONN_PADDING
slots (zero peak slots are inert), so a minibatch is plain slicing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CONSERVATIVE_RATE, NUM_SUBSPACE
from ..utils import vec


class GammaTrainData(NamedTuple):
    f_square: torch.Tensor   # (P,) min(f3w(contri)^2/sample_pdf, clamp)
    pdf0: torch.Tensor       # (P,) fix_pdf
    peak: torch.Tensor       # (P, C) peak_pdf / Q[label_b], 0 where invalid
    label_e: torch.Tensor    # (P, C) int32 flattened eye*N + light index
    valid: torch.Tensor      # (P,) bool


LOSS_CLAMP = 1e6  # optimal_E_loss_threshold analogue


def from_jax_train_data(jtd, device) -> GammaTrainData:
    """The port's GammaTrainData from a JAX spcbpt_tpu GammaTrainData, read
    as numpy (no jax import here)."""
    t = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device=device)
    return GammaTrainData(f_square=t(jtd.f_square, torch.float32),
                          pdf0=t(jtd.pdf0, torch.float32),
                          peak=t(jtd.peak, torch.float32),
                          label_e=t(jtd.label_e, torch.int32),
                          valid=t(jtd.valid, torch.bool))


def build_train_data(batch, q, label_a, label_b) -> GammaTrainData:
    """From a PretraceBatch of tensors (+ final conn labels) to training
    arrays (construct_optimal_E_data_* device_thrust.cu:3124-3171)."""
    w = vec.float3weight(batch.contri)
    f_square = w * w / torch.clamp(batch.sample_pdf, min=1e-30)
    f_square = torch.where(torch.isnan(f_square) | (f_square > LOSS_CLAMP),
                           LOSS_CLAMP, f_square)
    lb = torch.clamp(label_b, 0, NUM_SUBSPACE - 1).long()
    ql = q[lb]
    peak = torch.where(ql > 0.0, batch.peak_pdf / ql, 0.0)
    peak = torch.where(torch.isnan(peak) | torch.isinf(peak)
                       | ~batch.conn_valid, 0.0, peak)
    label_e = (torch.clamp(label_a, 0, NUM_SUBSPACE - 1).long() * NUM_SUBSPACE
               + lb)
    # sanitize: non-finite entries on invalid lanes would leak NaN gradients
    # through the masked loss (the where-grad trap)
    pdf0 = torch.where(torch.isfinite(batch.fix_pdf), batch.fix_pdf, 0.0)
    f_square = torch.where(torch.isfinite(f_square), f_square, 0.0)
    valid = batch.valid & torch.isfinite(batch.fix_pdf) & (batch.fix_pdf > 0.0)
    # condition the optimization: the loss is invariant under a joint scale
    # of (f_square, pdf0, peak); normalize so denominators are O(1)
    denom_proxy = pdf0 + torch.sum(peak, dim=1)
    mean_den = (torch.sum(torch.where(valid, denom_proxy, 0.0))
                / torch.clamp(torch.sum(valid), min=1))
    scale = 1.0 / torch.clamp(mean_den, min=1e-30)
    return GammaTrainData(f_square=f_square * scale, pdf0=pdf0 * scale,
                          peak=peak * scale,
                          label_e=label_e.to(torch.int32), valid=valid)


def clamp_outliers(td: GammaTrainData, sample: int = 1000) -> GammaTrainData:
    """Reference outlier clamp (device_thrust.cu:3282-3295): compute
    loss/uniform-pdf for the first `sample` paths, take the max as threshold,
    and clamp every path's f_square so its ratio stays below it."""
    proxy_pdf = td.pdf0 + torch.sum(td.peak, dim=1) / 1000.0
    ratio = td.f_square / torch.clamp(proxy_pdf, min=1e-30)
    thresh = torch.max(torch.where(td.valid[:sample], ratio[:sample], 0.0))
    new_f = torch.minimum(td.f_square, thresh * proxy_pdf)
    return td._replace(f_square=new_f)


def gamma_from_theta(theta):
    """E = sigmoid(theta) row-normalized + conservative mixture
    (get_E device_thrust.cu:1175-1190)."""
    e = torch.sigmoid(theta)
    e = e / torch.clamp(torch.sum(e, dim=1, keepdim=True), min=1e-30)
    return e * (1.0 - CONSERVATIVE_RATE) + CONSERVATIVE_RATE / NUM_SUBSPACE


def theta_from_gamma(gamma, eps: float = 1e-6):
    """Inverse-sigmoid init (initial_with_inver_sigmoid
    device_thrust.cu:3333-3334)."""
    g = torch.clamp(gamma, eps, 1.0 - eps)
    return torch.log(g / (1.0 - g))


def loss_sum_fn(theta, batch: GammaTrainData):
    """Unnormalized loss: (sum of per-path losses, valid count)."""
    e = gamma_from_theta(theta).reshape(-1)
    pdf_sum = torch.sum(e[batch.label_e.long()] * batch.peak, dim=1)
    # epsilon-floored denominator: build_train_data normalizes the dataset
    # so mean(den) ~ 1, making 1e-9 a pure numerical guard
    den = batch.pdf0 + pdf_sum + 1e-9
    loss = torch.where(batch.valid, batch.f_square, 0.0) / den
    return torch.sum(loss), torch.sum(batch.valid)


def loss_fn(theta, batch: GammaTrainData):
    s, c = loss_sum_fn(theta, batch)
    return s / torch.clamp(c, min=1)


def train_gamma(gamma_init, td: GammaTrainData, lr: float = 0.01,
                batch_size: int = 20000, epochs: int = 1,
                log_every: int = 0):
    """Adam over fixed minibatch slices (no shuffle); returns (trained
    Gamma, losses per step)."""
    theta = theta_from_gamma(gamma_init).detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    n = td.f_square.shape[0]
    steps_per_epoch = max(n // batch_size, 1)
    losses = []
    for ep in range(epochs):
        for i in range(steps_per_epoch):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            batch = GammaTrainData(*[a[sl] for a in td])
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(theta, batch)
            loss.backward()
            # optax.zero_nans(): NaN -> 0, +-inf kept
            theta.grad = torch.where(torch.isnan(theta.grad), 0.0, theta.grad)
            opt.step()
            losses.append(float(loss.detach()))
            if log_every and (i % log_every == 0):
                print(f"gamma train epoch {ep} step {i}: loss "
                      f"{losses[-1]:.6g}")
    with torch.no_grad():
        return gamma_from_theta(theta), losses

"""Optional neural refinement of the subspace sampling distribution (C21).

Port of spcbpt_tpu/train/nn_classifier.py. Every eye subspace owns a small
MLP (reference network_operator device_thrust.cu:1836-2824: positional
encoding :1384, batched per-class GEMMs :2138, softmax with temperature
:2558, Kaiming init :1486) whose output is a distribution over that eye
subspace's CLOSE_SET nearest light subspaces; at render time it is blended
with the trained Gamma row (lvc.sample_first_stage). Training minimizes the
same second-moment objective as the Gamma matrix, with autograd and
torch.optim.Adam in optax's form (gamma_train.py).

The per-lane MLP gathers each lane's stacked weights and multiplies with
torch.bmm, in full float32: on a CUDA tensor it raises while TF32 matmuls
are allowed (classify.use_fp32_matmul turns them off). `init_params` draws
on the host with numpy, the same draws as the JAX function, so both
packages start from the same network.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import NUM_SUBSPACE
from .classify import require_fp32_matmul

CLOSE_SET = 32          # nearby light subspaces per eye subspace (ref :2870)
ENC_FREQS = 4           # positional encoding octaves (ref position_encoding)
HIDDEN = 32
TEMPERATURE = 2.0       # softmax temperature (sigmoid_peak_op :2558)


class NNParams(NamedTuple):
    w1: torch.Tensor       # (S, F, H)
    b1: torch.Tensor       # (S, H)
    w2: torch.Tensor       # (S, H, CLOSE_SET)
    b2: torch.Tensor       # (S, CLOSE_SET)


class NNState(NamedTuple):
    params: NNParams
    close_set: torch.Tensor  # (S, CLOSE_SET) int32 light-subspace ids


@dataclasses.dataclass
class NNTables:
    """Render-time form of the trained network, carried on
    SubspaceState.nn: the first-stage pick becomes the mixture
        p(l | e, x) = (1-blend) * Gamma_mix(e, l) + blend * close(e, x)(l)
    and the reported pmf is that exact mixture (see the JAX class)."""
    w1: torch.Tensor          # (S, F, H)
    b1: torch.Tensor          # (S, H)
    w2: torch.Tensor          # (S, H, CLOSE_SET)
    b2: torch.Tensor          # (S, CLOSE_SET)
    close_set: torch.Tensor   # (S, CLOSE_SET) int32
    scene_lo: torch.Tensor    # (3,) for the positional encoding
    scene_hi: torch.Tensor    # (3,)
    blend: float = 0.5


def tables_from_state(state: NNState, scene_lo, scene_hi,
                      blend: float = 0.5) -> NNTables:
    p = state.params
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                    device=p.w1.device)
    return NNTables(w1=p.w1, b1=p.b1, w2=p.w2, b2=p.b2,
                    close_set=state.close_set, scene_lo=f32(scene_lo),
                    scene_hi=f32(scene_hi), blend=float(blend))


def from_jax_tables(jnt, device) -> NNTables:
    """The port's NNTables from a JAX spcbpt_tpu NNTables, whose arrays are
    read as numpy (no jax import here)."""
    t = lambda x, dt=torch.float32: torch.tensor(np.asarray(x), dtype=dt,
                                                 device=device)
    return NNTables(w1=t(jnt.w1), b1=t(jnt.b1), w2=t(jnt.w2), b2=t(jnt.b2),
                    close_set=t(jnt.close_set, torch.int32),
                    scene_lo=t(jnt.scene_lo), scene_hi=t(jnt.scene_hi),
                    blend=float(jnt.blend))


def _mlp(feats, w1, b1, w2, b2):
    """Per-lane MLP on gathered weights: feats (N, F), w1 (N, F, H), b1
    (N, H), w2 (N, H, K), b2 (N, K) -> close-set probabilities (N, K)."""
    require_fp32_matmul(feats)
    h = torch.relu(torch.bmm(feats[:, None, :], w1)[:, 0] + b1)
    logits = torch.bmm(h[:, None, :], w2)[:, 0] + b2
    return torch.softmax(logits / TEMPERATURE, dim=-1)


def close_probs(nt: NNTables, eye_label, position, normal):
    """Per-lane close-set distribution at an eye vertex.
    Returns (probs (N, CLOSE_SET) summing to 1, ids (N, CLOSE_SET))."""
    feats = encode(position, normal, nt.scene_lo, nt.scene_hi)
    row = torch.clamp(eye_label.long(), 0, nt.w1.shape[0] - 1)
    probs = _mlp(feats, nt.w1[row], nt.b1[row], nt.w2[row], nt.b2[row])
    return probs, nt.close_set[row]


def close_pmf_of(probs, ids, light_subspace):
    """pmf the close-set distribution assigns to a given light subspace
    (0 when outside the close set). Shapes: probs/ids (N,K), l (N,)."""
    match = ids == light_subspace[..., None].to(ids.dtype)
    return torch.sum(torch.where(match, probs, 0.0), dim=-1)


def feature_dim() -> int:
    return 3 * 2 * ENC_FREQS + 3  # enc(position) + normal


def encode(position, normal, scene_lo, scene_hi):
    """Sin/cos positional encoding of the normalized position + raw normal
    (reference position_encoding device_thrust.cu:1384)."""
    p = (position - scene_lo) / torch.clamp(scene_hi - scene_lo, min=1e-6)
    feats = [normal]
    for k in range(ENC_FREQS):
        w = (2.0 ** k) * math.pi
        feats.append(torch.sin(w * p))
        feats.append(torch.cos(w * p))
    return torch.cat(feats, dim=-1)


def init_params(rng: np.random.Generator, gamma: np.ndarray,
                device="cpu") -> NNState:
    """Kaiming init (ref :1486); close sets = top-CLOSE_SET Gamma columns of
    each eye row. The same numpy draws as the JAX function."""
    s = NUM_SUBSPACE
    f = feature_dim()
    w1 = rng.normal(0, np.sqrt(2.0 / f), (s, f, HIDDEN)).astype(np.float32)
    w2 = rng.normal(0, np.sqrt(2.0 / HIDDEN),
                    (s, HIDDEN, CLOSE_SET)).astype(np.float32)
    close = np.argsort(-gamma, axis=1)[:, :CLOSE_SET].astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=device)
    return NNState(params=NNParams(
        w1=t(w1), b1=torch.zeros((s, HIDDEN), device=device),
        w2=t(w2), b2=torch.zeros((s, CLOSE_SET), device=device)),
        close_set=t(close))


def forward(state: NNState, eye_label, feats):
    """Per-sample distribution over the eye subspace's close set.
    feats: (N, F); eye_label: (N,). Returns (probs (N, CLOSE_SET),
    light_ids (N, CLOSE_SET))."""
    p = state.params
    row = eye_label.long()
    probs = _mlp(feats, p.w1[row], p.b1[row], p.w2[row], p.b2[row])
    return probs, state.close_set[row]


def refined_gamma_row(state: NNState, gamma, eye_label, feats,
                      blend: float = 0.5):
    """Gamma row refined by the network: probability mass inside the close
    set is redistributed by the MLP; the rest of the row is kept."""
    probs, ids = forward(state, eye_label, feats)
    row = gamma[eye_label.long()]
    idx = ids.long()
    inside = torch.gather(row, 1, idx)
    close_mass = inside.sum(-1, keepdim=True)
    return row.scatter(1, idx, (1 - blend) * inside
                       + blend * probs * close_mass)


def second_moment_loss(params: NNParams, close_set, gamma, batch):
    """Same objective as the Gamma matrix trainer, with the network's refined
    row as the first-stage pmf. batch: dict with eye_label (N,), feats (N,F),
    light_label (N,), f_square, pdf0, peak (N,)."""
    probs, ids = forward(NNState(params, close_set), batch["eye_label"],
                         batch["feats"])
    match = ids == batch["light_label"][:, None].to(ids.dtype)
    inside = torch.any(match, dim=-1)
    pmf_net = torch.sum(torch.where(match, probs, 0.0), dim=-1)
    row_pmf = gamma[batch["eye_label"].long(), batch["light_label"].long()]
    pmf = torch.where(inside, pmf_net * 0.5 + row_pmf * 0.5, row_pmf)
    den = batch["pdf0"] + pmf * batch["peak"] + 1e-9
    return torch.mean(batch["f_square"] / den)


def _adam(params: NNParams, lr: float):
    """Leaf copies of the parameters and torch's Adam over them (optax's
    adam: betas 0.9/0.999, eps 1e-8)."""
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    return leaves, torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)


def _step(leaves, opt, loss_of, zero_nans: bool) -> float:
    opt.zero_grad(set_to_none=True)
    loss = loss_of(NNParams(*leaves))
    loss.backward()
    if zero_nans:
        # optax.zero_nans(): NaN -> 0, +-inf kept
        for p in leaves:
            p.grad = torch.where(torch.isnan(p.grad), 0.0, p.grad)
    opt.step()
    return float(loss.detach())


def _frozen(leaves) -> NNParams:
    return NNParams(*[p.detach() for p in leaves])


def corpus_batches(td, a_position, a_normal, label_a, label_b,
                   batch_size: int = 4096, max_paths: int = 500_000):
    """The full batches train_from_corpus steps through, in order (a last
    partial batch is dropped), as dicts of tensors on td's device."""
    dev = td.f_square.device
    t = lambda a: torch.as_tensor(a, device=dev)
    n = min(int(td.f_square.shape[0]), max_paths)
    for i0 in range(0, n - batch_size + 1, batch_size):
        sl = slice(i0, i0 + batch_size)
        yield dict(pos=t(a_position[sl]), nrm=t(a_normal[sl]),
                   la=t(label_a[sl]), lb=t(label_b[sl]),
                   pdf0=td.pdf0[sl], peak=td.peak[sl],
                   f_square=td.f_square[sl], valid=td.valid[sl])


def corpus_loss(params: NNParams, close_set, gamma_mixed, scene_lo,
                scene_hi, blend: float, b) -> torch.Tensor:
    """The objective of one corpus batch b (corpus_batches): the Gamma
    trainer's second moment with the blended first-stage density
        den = pdf0 + sum_c [(1-b) Gamma_mix(e_c,l_c) + b nn(l_c|e_c,x_c)] peak_c
    summed over the valid paths and divided by their count."""
    pc, cc = b["pos"].shape[0], b["pos"].shape[1]
    feats = encode(b["pos"].reshape(-1, 3), b["nrm"].reshape(-1, 3),
                   scene_lo, scene_hi)
    la = torch.clamp(b["la"].reshape(-1).long(), 0, NUM_SUBSPACE - 1)
    lb = torch.clamp(b["lb"].reshape(-1).long(), 0, NUM_SUBSPACE - 1)
    probs, ids = forward(NNState(params, close_set), la, feats)
    p_close = close_pmf_of(probs, ids, lb).reshape(pc, cc)
    p_row = gamma_mixed[la, lb].reshape(pc, cc)
    p_blend = (1.0 - blend) * p_row + blend * p_close
    den = b["pdf0"] + torch.sum(p_blend * b["peak"], dim=1) + 1e-9
    loss = torch.where(b["valid"], b["f_square"], 0.0) / den
    return torch.sum(loss) / torch.clamp(torch.sum(b["valid"]), min=1)


def train_from_corpus(state: NNState, gamma_mixed, td, a_position, a_normal,
                      label_a, label_b, scene_lo, scene_hi,
                      blend: float = 0.5, lr: float = 1e-3,
                      batch_size: int = 4096, epochs: int = 1,
                      max_paths: int = 500_000):
    """Train the close-set network on the pretrace corpus against the same
    second-moment objective as the Gamma matrix (corpus_loss). Gamma stays
    frozen; only the network moves. td is a gamma_train.GammaTrainData;
    a_position/a_normal (P,C,3) and label_a/label_b (P,C) are host arrays.
    Full batches only, no shuffle. Returns (NNTables, losses)."""
    dev = state.close_set.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    g, lo, hi = f32(gamma_mixed), f32(scene_lo), f32(scene_hi)
    leaves, opt = _adam(state.params, lr)
    losses = []
    for _ in range(epochs):
        for b in corpus_batches(td, a_position, a_normal, label_a, label_b,
                                batch_size, max_paths):
            losses.append(_step(leaves, opt, lambda p: corpus_loss(
                p, state.close_set, g, lo, hi, blend, b), zero_nans=True))
    return tables_from_state(NNState(_frozen(leaves), state.close_set),
                             lo, hi, blend), losses


def train(state: NNState, gamma, batches, lr: float = 1e-3):
    """Adam on second_moment_loss over `batches` in order (optax.adam, no
    NaN zeroing, as the JAX function). Returns (NNState, losses)."""
    leaves, opt = _adam(state.params, lr)
    losses = [_step(leaves, opt, lambda p, b=batch: second_moment_loss(
        p, state.close_set, gamma, b), zero_nans=False) for batch in batches]
    return NNState(_frozen(leaves), state.close_set), losses

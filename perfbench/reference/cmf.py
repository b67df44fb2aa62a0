"""Batched CMF (cumulative mass function) utilities.

The benchmark's plain reference: a frozen copy of
`spcbpt_tpu_torch/ops/cmf.py` (what the rendered configurations use;
skies, textures and the close-set network left out), importing
nothing of the program. Float tensors take torch's default dtype,
so that the control runs it in bfloat16.

Port of spcbpt_tpu/ops/cmf.py. The reference samples CMFs with a
per-thread binary search (Tracer::binary_sample cuProg.h:245-264); here
lanes bisect in lock step with per-lane [base, base+size) bounds into one
flat CMF array, with the same round count as the JAX fori_loop.
"""
from __future__ import annotations

import math

import torch


def _clip_index(i, n: int):
    return torch.clamp(i, 0, n - 1).long()


def segment_searchsorted(cmf_flat, base, size, x, max_size: int):
    """Per-lane searchsorted-right within segments of a flat CMF.

    Returns local index l in [0, size-1]: the first slot with cmf > x
    (clamped). pmf recovery: cmf[base+l] - (l>0 ? cmf[base+l-1] : 0).
    max_size bounds the bisection round count."""
    n = cmf_flat.shape[0]
    lo = torch.zeros_like(base)             # first candidate
    hi = torch.clamp(size, min=1)           # one past last
    rounds = max(1, math.ceil(math.log2(int(max_size) + 1)))
    for _ in range(rounds + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        right = cmf_flat[_clip_index(base + mid, n)] <= x
        # standard bisect: if cmf[mid] <= x, the answer is right of mid
        new_lo = torch.where(right, mid + 1, lo)
        lo, hi = torch.minimum(new_lo, hi), torch.where(right, hi, mid)
    return torch.minimum(torch.clamp(lo, min=0), torch.clamp(size - 1, min=0))


def segment_pmf(cmf_flat, base, local_idx):
    n = cmf_flat.shape[0]
    c = cmf_flat[_clip_index(base + local_idx, n)]
    prev = cmf_flat[_clip_index(base + local_idx - 1, n)]
    return torch.where(local_idx > 0, c - prev, c)

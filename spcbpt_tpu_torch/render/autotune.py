"""Train-time second-stage selection.

A copy of spcbpt_tpu/render/autotune.py (numpy only).

The SPCBPT family has two calibrated (second-stage sampler, MIS-rate)
pairs, and the choice between them is pure variance engineering (both are
unbiased):

  * "weighted" (reference parity): flux-CMF second stage + Gamma*flux/Q
    rates (connectRate_SOL cuProg.h:70-78). Near-optimal on low
    dynamic-range scenes: glossy Cornell relMSE 0.012 vs 0.033 for
    "uniform" (64 spp, 1% firefly discard).
  * "uniform": uniform-in-subspace second stage + Gamma*inv_occ rates.
    Robust on high dynamic-range interiors: 0.31 vs 3.06 for "weighted"
    on the two-room interior.

Diagnosis history (round 2): the damage in the losing mode flows through
the RATE function inside the recursive MIS weights, not the sampler — on
the interior, rate=flux/Q is catastrophic with EITHER sampler (2.9-3.1)
and rate=inv_occ is good with either (0.31-0.33). flux-valued rates are
winner-take-all under high flux dynamic range (one bright vertex claims
every balance weight it appears in, ignoring visibility), and Q-shrinkage
does not fix it; count-valued rates are bounded and robust. Render-time
probes (frame variance, connection second moments, mean connection
visibility) all failed to separate the modes — the tail events that
distinguish them are too rare to probe cheaply. The per-subspace flux
dynamic range, however, separates the regimes directly and is free at
train time:

    DR = p99(m) / p50(m),   m(l) = Q(l) * inv_occ(l)  (mean flux/vertex)

    measured: glossy 1.3, two-room interior 4.7 -> threshold 2.5.
"""
from __future__ import annotations

import numpy as np


def select_second_stage(q, inv_occ, dr_threshold: float = 2.5):
    """Returns ("weighted" | "uniform", stats) from trained Q/occupancy."""
    q = np.asarray(q, np.float64)
    inv_occ = np.asarray(inv_occ, np.float64)
    m = np.where((q < 1e30) & (inv_occ > 0), q * inv_occ, np.nan)
    m = m[np.isfinite(m) & (m > 0)]
    if m.size < 8:
        return "uniform", {"flux_dr": float("inf"), "n": int(m.size)}
    p50, p99 = np.percentile(m, [50, 99])
    dr = float(p99 / max(p50, 1e-30))
    mode = "weighted" if dr <= dr_threshold else "uniform"
    return mode, {"flux_dr": dr, "n": int(m.size), "mode": mode}

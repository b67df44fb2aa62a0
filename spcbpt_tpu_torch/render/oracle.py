"""Full-path estimator oracle: exact contribution / pdf / SPCBPT MIS weights
recomputed from complete path vertex lists.

Port of spcbpt_tpu/render/oracle.py. This is the reference's validation
semantics (reference: eval_path + __raygen__SPCBPT_no_rmis
raygen.cu:445-463, contriCompute cuProg.h:900-936, pdfCompute
cuProg.h:937-1008, MISWeight_SPCBPT cuProg.h:1010-1105): the no-RMIS
renderer that recomputes every strategy's weight from scratch, used as the
test oracle for the O(1) cached RMIS path of render/rmis.py.

Paths are SoA: dict with position/normal/color (N, K, 3), mat_id (N, K),
size (N,) — vertex 0 is the eye (camera) vertex, vertex size-1 is the light
vertex; light_flux (N, 3), light_pdf (N,) and light_subspace (N,) describe
the light-source sample.
"""
from __future__ import annotations

import math

import torch

from ..config import MIN_RR_RATE
from ..ops import bsdf as bsdf_mod
from ..train import classify
from ..utils import vec
from .rmis import connect_rate


def _mat(ts, path, i):
    return bsdf_mod.gather_mat(ts.mats,
                               torch.clamp(path["mat_id"][:, i], min=0),
                               path["color"][:, i])


def _eval(ts, path, i, d_in, d_out):
    return bsdf_mod.eval_bsdf(_mat(ts, path, i), path["normal"][:, i],
                              d_in, d_out)


def _pdf(ts, path, i, d_in, d_out):
    return bsdf_mod.pdf_bsdf(_mat(ts, path, i), path["normal"][:, i],
                             d_in, d_out)


def _rr(path, i):
    return torch.clamp(torch.amax(path["color"][:, i], dim=-1),
                       min=MIN_RR_RATE)


def _light_end(path):
    """(lanes, light position, light normal, direction light -> its
    neighbour) of every path."""
    pos = path["position"]
    lanes = torch.arange(pos.shape[0], device=pos.device)
    last = (path["size"] - 1).long()
    light_pos = pos[lanes, last]
    light_n = path["normal"][lanes, last]
    prev_pos = pos[lanes, torch.clamp(last - 1, min=0)]
    return lanes, light_pos, light_n, vec.normalize(prev_pos - light_pos)


def contri_compute(ts, path, k_max: int):
    """cuProg.h:900-936: product of Le*cos, 1/d^2 segment terms and
    cos*cos*f at interior vertices. size fixed per call via masks."""
    size = path["size"]
    pos = path["position"]
    _, _, light_n, ldir = _light_end(path)
    lang = vec.dot(light_n, ldir)
    throughput = path["light_flux"] * torch.clamp(lang, min=0.0)[..., None]

    for i in range(1, k_max):
        in_range = i < size
        line = pos[:, i] - pos[:, i - 1]
        d2 = torch.clamp(vec.dot(line, line), min=1e-20)
        throughput = torch.where(in_range[..., None],
                                 throughput / d2[..., None], throughput)
    for i in range(1, k_max - 1):
        interior = i < (size - 1)
        last_dir = vec.normalize(pos[:, i - 1] - pos[:, i])
        next_dir = vec.normalize(pos[:, i + 1] - pos[:, i])
        n = path["normal"][:, i]
        f = _eval(ts, path, i, last_dir, next_dir)
        term = (torch.abs(vec.dot(n, last_dir))
                * torch.abs(vec.dot(n, next_dir)))[..., None] * f
        throughput = torch.where(interior[..., None], throughput * term,
                                 throughput)
    return torch.where((lang > 0.0)[..., None], throughput, 0.0)


def _at(path, name, idx, lanes):
    return path[name][lanes, torch.clamp(idx, min=0).long()]


def _strategy(path, strategy_id):
    """The eye length of a strategy, a number or an (N,) tensor, as (N,)."""
    size = path["size"]
    return torch.as_tensor(strategy_id, dtype=size.dtype,
                           device=size.device).expand(size.shape)


def pdf_compute(ts, path, strategy_id, k_max: int):
    """cuProg.h:937-1008: pdf of sampling the path with eye length
    = strategy_id (light length = size - strategy_id)."""
    size = path["size"]
    pos = path["position"]
    strategy_id = _strategy(path, strategy_id)
    lanes, _, light_n, ldir = _light_end(path)
    light_len = size - strategy_id
    pdf = torch.ones(pos.shape[0], device=pos.device)

    # light-side start pdf
    pdf = torch.where(light_len > 0, pdf * path["light_pdf"], pdf)
    pdf = torch.where(light_len > 1,
                      pdf * torch.abs(vec.dot(ldir, light_n)) / math.pi, pdf)

    # light-side geometric + directional pdfs (indices relative to path end)
    for i in range(1, k_max):
        on = i < light_len
        mid_p = _at(path, "position", size - i - 1, lanes)     # midPoint
        last_p = _at(path, "position", size - i, lanes)        # lastPoint
        line = mid_p - last_p
        d2 = torch.clamp(vec.dot(line, line), min=1e-20)
        g = torch.abs(vec.dot(_at(path, "normal", size - i - 1, lanes),
                              vec.normalize(line))) / d2
        pdf = torch.where(on, pdf * g, pdf)
    for i in range(1, k_max - 1):
        on = i < light_len - 1
        mi = size - i - 1
        mid_p = _at(path, "position", mi, lanes)
        last_dir = vec.normalize(_at(path, "position", size - i, lanes)
                                 - mid_p)
        next_dir = vec.normalize(_at(path, "position", size - i - 2, lanes)
                                 - mid_p)
        color = _at(path, "color", mi, lanes)
        mat = bsdf_mod.gather_mat(
            ts.mats, torch.clamp(_at(path, "mat_id", mi, lanes), min=0),
            color)
        p = bsdf_mod.pdf_bsdf(mat, _at(path, "normal", mi, lanes), last_dir,
                              next_dir)
        rr = torch.clamp(torch.amax(color, dim=-1), min=MIN_RR_RATE)
        pdf = torch.where(on, pdf * p * rr, pdf)

    # eye-side geometric + directional pdfs
    for i in range(1, k_max):
        on = i < strategy_id
        line = pos[:, i] - pos[:, i - 1]
        d2 = torch.clamp(vec.dot(line, line), min=1e-20)
        g = torch.abs(vec.dot(path["normal"][:, i],
                              vec.normalize(line))) / d2
        pdf = torch.where(on, pdf * g, pdf)
    for i in range(1, k_max - 1):
        on = i < (strategy_id - 1)
        last_dir = vec.normalize(pos[:, i - 1] - pos[:, i])
        next_dir = vec.normalize(pos[:, i + 1] - pos[:, i])
        p = _pdf(ts, path, i, last_dir, next_dir)
        pdf = torch.where(on, pdf * p * _rr(path, i), pdf)
    return pdf


def suffix_value(ts, path, strategy_id, k_max: int):
    """The cumulative (flux / pdf) of the light sub-path at the connection
    vertex path[strategy_id] — the quantity every LVC vertex stores and
    connectRate_SOL takes at connection time. Closed form for a quad-light
    start with cosine-hemisphere emission: suffix length 1 gives
    emission/light_pdf; each added segment multiplies by
    Eval * cos_toward_eye / (Pdf * rr) at the interior vertex, and the first
    segment contributes a bare pi."""
    size = path["size"]
    pos = path["position"]
    lanes = torch.arange(pos.shape[0], device=pos.device)
    light_len = size - _strategy(path, strategy_id)

    v = path["light_flux"] / torch.clamp(path["light_pdf"],
                                         min=1e-30)[..., None]
    v = torch.where((light_len >= 2)[..., None], v * math.pi, v)
    # interior light vertices: light depth i = 1 .. light_len-2,
    # path index k = size-1-i
    for i in range(1, k_max - 1):
        on = i < (light_len - 1)
        k = size - 1 - i
        p_k = _at(path, "position", k, lanes)
        to_prev = vec.normalize(_at(path, "position", size - i, lanes) - p_k)
        to_next = vec.normalize(_at(path, "position", size - i - 2, lanes)
                                - p_k)
        n = _at(path, "normal", k, lanes)
        color = _at(path, "color", k, lanes)
        mat = bsdf_mod.gather_mat(
            ts.mats, torch.clamp(_at(path, "mat_id", k, lanes), min=0), color)
        f = bsdf_mod.eval_bsdf(mat, n, to_prev, to_next)
        p = bsdf_mod.pdf_bsdf(mat, n, to_prev, to_next)
        rr = torch.clamp(torch.amax(color, dim=-1), min=MIN_RR_RATE)
        factor = f * (torch.abs(vec.dot(n, to_next))
                      / torch.clamp(p * rr, min=1e-30))[..., None]
        v = torch.where(on[..., None], v * factor, v)
    return v


def mis_weight_spcbpt(ts, ss: classify.SubspaceState, path, strategy_id,
                      k_max: int):
    """The (unnormalized) SPCBPT balance weight of a strategy, recomputed from
    the complete path: full-path pdf under strategy s (pdfCompute,
    cuProg.h:937-1008) times the subspace connect rate with lum = the light
    vertex's cumulative flux/pdf (connectRate_SOL cuProg.h:70-78), the
    closed form of the live rmis.h recursion."""
    size = path["size"]
    pos = path["position"]
    lanes = torch.arange(pos.shape[0], device=pos.device)
    strategy_id = _strategy(path, strategy_id)

    # full path pdf under this strategy (eye prefix x light prefix)
    plain = pdf_compute(ts, path, strategy_id, k_max)

    # subspace connect rate at the strategy boundary
    eye_label = classify.label_eye(
        ss, _at(path, "position", strategy_id - 1, lanes),
        _at(path, "normal", strategy_id - 1, lanes))
    li = torch.clamp(strategy_id, max=k_max - 1)
    light_label_tree = classify.label_light(
        ss, _at(path, "position", li, lanes), _at(path, "normal", li, lanes))
    light_label = torch.where(strategy_id == (size - 1),
                              path["light_subspace"], light_label_tree)
    lum = vec.float3weight(suffix_value(ts, path, strategy_id, k_max))
    w = plain * connect_rate(ss, eye_label, light_label, lum)
    # pure-pdf strategies: s<=1 (light tracing; disabled) or s==size (BSDF hit)
    use_plain = (strategy_id <= 1) | (strategy_id == size)
    return torch.where(use_plain, plain, w)


def eval_path(ts, ss, path, strategy_id, k_max: int):
    """raygen.cu:445-463: contri/pdf * normalized MIS weight."""
    pdf = pdf_compute(ts, path, strategy_id, k_max)
    contri = contri_compute(ts, path, k_max)
    num = mis_weight_spcbpt(ts, ss, path, strategy_id, k_max)
    den = torch.zeros_like(num)
    for i in range(2, k_max + 1):
        on = i <= path["size"]
        den = den + torch.where(on, mis_weight_spcbpt(ts, ss, path, i, k_max),
                                0.0)
    ans = (contri / torch.clamp(pdf, min=1e-30)[..., None]
           * (num / torch.clamp(den, min=1e-30))[..., None])
    return vec.scrub(ans)

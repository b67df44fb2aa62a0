"""Recursive MIS (RMIS): O(1)-per-vertex MIS weights for SPCBPT connections.

The benchmark's plain reference: a frozen copy of
`spcbpt_tpu_torch/render/rmis.py` (what the rendered configurations use;
skies, textures and the close-set network left out), importing
nothing of the program. Float tensors take torch's default dtype,
so that the control runs it in bfloat16.

Port of spcbpt_tpu/render/rmis.py (math contract: reference rmis.h:13-391).
Each sub-path carries an accumulated "all other strategies" term (scalar
`rmis` on the light side, float3 `rmis3` plus the pdf-only `rmis_u` on the
eye side) updated once per bounce from pdf ratios and subspace connect
rates; at connection time the combiners below produce the balance-heuristic
weight. The connect-rate kernel is Gamma(eye,light)/Q[light] * lum *
CONNECTION_N (cuProg.h:70-78).

Vertex arguments are duck-typed records (LightVertices from
render/vertex.py, EyeVertices here) sharing the attribute names used here.
With a sky, env light vertices are directional: their start pdf is the
projected disk's 1/(pi r^2) (scene/envmap.env_project_pdf), and an eye
path that escapes is weighed against the env connections by light_hit_env
(or light_hit_env_cached from the per-bounce products).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .consts import CONNECTION_N, MIN_RR_RATE, NUM_SUBSPACE
from . import bsdf as bsdf_mod
from . import classify
from . import vec


@dataclasses.dataclass
class EyeVertices:
    """Eye sub-path vertex state carried through the SPCBPT eye loop. The
    cumulative flux/pdf is carried as its ratio by the renderers; only the
    per-segment single_pdf lives on the vertex for the RMIS recursion."""
    position: torch.Tensor
    normal: torch.Tensor
    color: torch.Tensor
    last_position: torch.Tensor
    single_pdf: torch.Tensor
    last_normal_proj: torch.Tensor
    rmis3: torch.Tensor           # (..., 3) RMIS_pointer_3 (flux-transported)
    rmis_u: torch.Tensor          # (...,) pdf-only chain for the flux-free
                                  # (uniform-second-stage) strategy weights
    mat_id: torch.Tensor
    subspace_id: torch.Tensor
    light_label: torch.Tensor     # light-tree label at this vertex (cached)
    last_zone_id: torch.Tensor
    depth: torch.Tensor
    is_ll_direction: torch.Tensor
    is_brdf: torch.Tensor
    last_brdf: torch.Tensor


def mix_coeffs(ss: classify.SubspaceState):
    """(alpha_weighted, alpha_uniform) for the active second stage. The two
    strategy-weight families ride separate recursive chains (flux-linear
    weights the fm chain, flux-free weights a pdf-only chain), so they mix
    at the combiners, not inside the recursion."""
    if not ss.trained or ss.inv_occ is None:
        return 1.0, 0.0
    return {"weighted": (1.0, 0.0), "uniform": (0.0, 1.0),
            "mixture": (0.5, 0.5)}[ss.second_stage]


def rate_parts(ss: classify.SubspaceState, eye_label, light_label, lum):
    """The two pure strategy-weight forms (before mixing):
      weighted (reference connectRate_SOL cuProg.h:70-78):
          Gamma/Q * lum * N    — density of the flux-weighted second stage
      uniform:
          Gamma * inv_occ * N  — density of the uniform-in-subspace stage.
    A family whose mixing coefficient is 0 is not computed."""
    aw, au = mix_coeffs(ss)
    shape = torch.broadcast_shapes(eye_label.shape, light_label.shape)
    zero = torch.zeros(shape, device=eye_label.device)
    w = (classify.gamma_ss(ss, eye_label, light_label) * lum * CONNECTION_N
         if aw != 0.0 else zero)
    if au != 0.0 and ss.trained and ss.inv_occ is not None:
        l = torch.clamp(light_label, 0, NUM_SUBSPACE - 1).long()
        u = (classify.gamma_block(ss, eye_label, light_label)
             * ss.inv_occ[l] * CONNECTION_N)
    else:
        u = zero
    return w, u


def connect_rate(ss: classify.SubspaceState, eye_label, light_label, lum):
    """Mixed connection-strategy weight for the active second stage."""
    aw, au = mix_coeffs(ss)
    w, u = rate_parts(ss, eye_label, light_label, lum)
    return aw * w + au * u


def _pdf_at(ts, v, in_dir, out_dir):
    mat = bsdf_mod.gather_mat(ts.mats, torch.clamp(v.mat_id, min=0), v.color)
    return bsdf_mod.pdf_bsdf(mat, v.normal, in_dir, out_dir)


def _eval_at(ts, v, in_dir, out_dir):
    mat = bsdf_mod.gather_mat(ts.mats, torch.clamp(v.mat_id, min=0), v.color)
    return bsdf_mod.eval_bsdf(mat, v.normal, in_dir, out_dir)


def _rr(v):
    return bsdf_mod.rr_rate(v.color, MIN_RR_RATE)


def get_last_pdf(ts, v, in_dir):
    """rmis::getLast_pdf (rmis.h:41-51): area pdf of regenerating v's previous
    vertex from v, given incidence in_dir; includes RR."""
    out_vec = v.last_position - v.position
    out_dir = vec.normalize(out_vec)
    pdf = _pdf_at(ts, v, in_dir, out_dir)
    conv = v.last_normal_proj / torch.clamp(vec.dot(out_vec, out_vec),
                                            min=1e-20)
    pdf = torch.where(v.is_ll_direction, pdf, pdf * conv)
    return pdf * _rr(v)


def get_pdf_from_light_source(ts, light_v, end_position, end_normal):
    """rmis::getPdf_from_light_source (rmis.h:174-190): area lights, and
    env origins, whose projected-area pdf is a constant."""
    conn_vec = end_position - light_v.position
    conn_dir = vec.normalize(conn_vec)
    pdf_angle = torch.abs(vec.dot(light_v.normal, conn_dir)) / math.pi
    angle2a = (torch.abs(vec.dot(end_normal, conn_dir))
               / torch.clamp(vec.dot(conn_vec, conn_vec), min=1e-20))
    return pdf_angle * angle2a


def source_flux_multiplier(ts, light_v, like):
    """fm1 of the light-source combiner (rmis.h:278-281): pi for area
    lights, the projected disk's area pi r^2 for env origins."""
    return torch.full_like(like, math.pi)


def flux_multiplier(ts, v, in_dir, out_dir):
    """rmis::getFluxMultiplier (rmis.h:104-115): f*cos/(pdf*rr)."""
    f = _eval_at(ts, v, in_dir, out_dir)
    pdf = _pdf_at(ts, v, in_dir, out_dir)
    cos = torch.abs(vec.dot(v.normal, out_dir))
    return f * (cos / torch.clamp(pdf * _rr(v), min=1e-20))[..., None]


def flux_multiplier_last(ts, v, in_dir):
    out_dir = vec.normalize(v.last_position - v.position)
    return flux_multiplier(ts, v, in_dir, out_dir)


def tracing_weight_light(ts, ss, last, mid_position):
    """rmis.h:57-79: last treated as eye-side connection point, with the
    eye-tree label cached on the light vertex at trace time (the reference
    recomputes it per connection, rmis.h:71-74)."""
    w = connect_rate(ss, last.eye_label, last.last_zone_id, last.last_lum)
    return torch.where(last.last_brdf | last.is_brdf, 0.0, w)


def tracing_weight_eye_parts(ts, ss, last, mid_position, mid_is_dir=None):
    """rmis.h:134-153: last treated as light-side connection point; lum = 1
    for the flux-linear part (the suffix flux accumulates via the fm chain).
    Depth-1 eye vertices weigh 0 (no t=1 light-tracing strategy). Returns
    (flux-linear part, flux-free part)."""
    w, u = rate_parts(ss, last.last_zone_id, last.light_label,
                      torch.ones_like(last.single_pdf))
    z = last.last_brdf | last.is_brdf | (last.depth == 1)
    return torch.where(z, 0.0, w), torch.where(z, 0.0, u)


def tracing_update_eye(ts, ss, last: EyeVertices, mid_position, mid_is_dir,
                       in_dir=None):
    """rmis.h:191-203: new (rmis3, rmis_u) for the vertex after `last`.
    rmis3 transports flux-linear weights (pdf ratio x flux multiplier);
    rmis_u transports flux-free weights (pdf ratio only).

    in_dir: the renderers pass the (already normalized) ray direction d —
    identical to normalize(mid_position - last.position) for hit lanes, and
    the only correct value for miss lanes."""
    if in_dir is None:
        in_dir = vec.normalize(mid_position - last.position)
    ll_pdf = get_last_pdf(ts, last, in_dir)
    w_part, u_part = tracing_weight_eye_parts(ts, ss, last, mid_position,
                                              mid_is_dir)
    fm = flux_multiplier_last(ts, last, in_dir)
    inv_sp = 1.0 / torch.clamp(last.single_pdf, min=1e-30)
    num3 = last.rmis3 * ll_pdf[..., None] * fm + w_part[..., None]
    num_u = last.rmis_u * ll_pdf + u_part
    return num3 * inv_sp[..., None], num_u * inv_sp


def light_hit_cached(ss, eye_v: EyeVertices, rmis3_next, rmis_u_next, d,
                     cos_last, inv_t2, pending_single,
                     lv_normal, lv_flux, lv_pdf, lv_subspace):
    """light_hit from the per-bounce quantities the renderer already has:
    the eye-side chain (d_a0_w, d_a0_u) is tracing_update_eye's (rmis3,
    rmis_u) output scaled by eye_v.single_pdf, and pdf_b is the carried
    sampling pdf `pending_single` (= pdf_bsdf * rr of the bounce that
    generated d) times the virtual vertex's area conversion. Lanes with
    eye_v.depth == 0 (camera vertex) produce garbage; callers override them
    with weight 1 (direct hit)."""
    flux = lv_flux / torch.clamp(lv_pdf, min=1e-30)[..., None]
    aw, au = mix_coeffs(ss)
    cos_lv = torch.abs(vec.dot(lv_normal, d))
    pdf_a = (cos_lv / math.pi) * cos_last * inv_t2
    d_a = au * rmis_u_next * pdf_a
    if aw != 0.0:
        d_a = d_a + aw * vec.float3weight(
            rmis3_next * (pdf_a * math.pi)[..., None] * flux)
    weight = connect_rate(ss, eye_v.subspace_id, lv_subspace,
                          vec.float3weight(flux))
    weight = torch.where(eye_v.is_brdf, 0.0, weight)
    pdf_b = pending_single * cos_lv * inv_t2
    denom = (weight + d_a) / torch.clamp(pdf_b, min=1e-30) * lv_pdf + 1.0
    return 1.0 / torch.clamp(denom, min=1e-30)

"""Recursive MIS (RMIS): O(1)-per-vertex MIS weights for SPCBPT connections.

Port of spcbpt_tpu/render/rmis.py (math contract: reference rmis.h:13-391).
Each sub-path carries an accumulated "all other strategies" term (scalar
`rmis` on the light side, float3 `rmis3` plus the pdf-only `rmis_u` on the
eye side) updated once per bounce from pdf ratios and subspace connect
rates; at connection time the combiners below produce the balance-heuristic
weight. The connect-rate kernel is Gamma(eye,light)/Q[light] * lum *
CONNECTION_N (cuProg.h:70-78).

Vertex arguments are duck-typed records (LightVertices from
render/vertex.py, EyeVertices here) sharing the attribute names used here.
Environment lights are not ported: the env combiners raise.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from spcbpt_tpu.config import CONNECTION_N, MIN_RR_RATE, NUM_SUBSPACE

from ..ops import bsdf as bsdf_mod
from ..train import classify
from ..utils import vec


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


def _no_env(ts) -> None:
    if ts is not None and ts.has_env:
        raise NotImplementedError("environment maps are not ported yet")


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


def get_pdf(ts, begin_v, end_position, end_normal, end_is_dir, in_dir):
    """rmis::getPdf (rmis.h:155-173): pdf of generating `end` from `begin`."""
    out_vec = end_position - begin_v.position
    out_dir = torch.where(end_is_dir[..., None], -end_normal,
                          vec.normalize(out_vec))
    pdf = _pdf_at(ts, begin_v, in_dir, out_dir)
    conv = (torch.abs(vec.dot(out_dir, end_normal))
            / torch.clamp(vec.dot(out_vec, out_vec), min=1e-20))
    pdf = torch.where(end_is_dir, pdf, pdf * conv)
    return pdf * _rr(begin_v)


def get_pdf_from_light_source(ts, light_v, end_position, end_normal):
    """rmis::getPdf_from_light_source (rmis.h:174-190), area lights."""
    _no_env(ts)
    conn_vec = end_position - light_v.position
    conn_dir = vec.normalize(conn_vec)
    pdf_angle = torch.abs(vec.dot(light_v.normal, conn_dir)) / math.pi
    angle2a = (torch.abs(vec.dot(end_normal, conn_dir))
               / torch.clamp(vec.dot(conn_vec, conn_vec), min=1e-20))
    return pdf_angle * angle2a


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


def tracing_weight_eye(ts, ss, last, mid_position, mid_is_dir=None):
    aw, au = mix_coeffs(ss)
    w, u = tracing_weight_eye_parts(ts, ss, last, mid_position, mid_is_dir)
    return aw * w + au * u


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


def _eye_side_D(ts, ss, eye_v, light_v, connect_dir, flux):
    """Shared eye-side accumulators of the combiners (rmis.h:219-233):
    connect_dir points light->eye. Returns (flux-chain D_A0 (N,3),
    pdf-only-chain D_A0 (N,))."""
    ll_pdf_a = get_last_pdf(ts, eye_v, -connect_dir)
    fm0 = flux_multiplier_last(ts, eye_v, -connect_dir)
    w_part, u_part = tracing_weight_eye_parts(ts, ss, eye_v, light_v.position)
    d_w = eye_v.rmis3 * ll_pdf_a[..., None] * fm0 + w_part[..., None]
    d_u = eye_v.rmis_u * ll_pdf_a + u_part
    return d_w, d_u


def general_connection(ts, ss, eye_v: EyeVertices, light_v):
    """rmis::general_connection (rmis.h:212-247): MIS weight for connecting
    eye_v to a light vertex with depth>0."""
    connect_vec = eye_v.position - light_v.position
    connect_dir = vec.normalize(connect_vec)
    flux = light_v.ratio

    aw, au = mix_coeffs(ss)
    d_a0_w, d_a0_u = _eye_side_D(ts, ss, eye_v, light_v, connect_dir, flux)
    la = vec.normalize(light_v.last_position - light_v.position)
    pdf_a = get_pdf(ts, light_v, eye_v.position, eye_v.normal,
                    torch.zeros_like(eye_v.single_pdf, dtype=torch.bool), la)
    fm1 = flux_multiplier(ts, light_v, la, connect_dir)
    inv_sp = 1.0 / torch.clamp(eye_v.single_pdf, min=1e-30)
    d_a_w = vec.float3weight(d_a0_w * pdf_a[..., None] * fm1 * flux) * inv_sp
    d_a_u = d_a0_u * pdf_a * inv_sp
    d_a = aw * d_a_w + au * d_a_u

    weight = connect_rate(ss, eye_v.subspace_id, light_v.subspace_id,
                          vec.float3weight(flux))

    ll_pdf_b = get_last_pdf(ts, light_v, connect_dir)
    weight_b = tracing_weight_light(ts, ss, light_v, eye_v.position)
    d_b0 = light_v.rmis * ll_pdf_b + weight_b
    lb = vec.normalize(eye_v.last_position - eye_v.position)
    pdf_b = get_pdf(ts, eye_v, light_v.position, light_v.normal,
                    light_v.is_env, lb)
    d_b = d_b0 * pdf_b / torch.clamp(light_v.single_pdf, min=1e-30)

    w = weight / torch.clamp(weight + d_a + d_b, min=1e-30)
    return torch.where(eye_v.is_brdf | light_v.is_brdf, 0.0, w)


def connection_light_source(ts, ss, eye_v: EyeVertices, light_v):
    """rmis::connection_lightSource (rmis.h:281-323): light vertex is on the
    light source (depth 0, area light)."""
    _no_env(ts)
    connect_vec = eye_v.position - light_v.position
    connect_dir = torch.where(light_v.is_env[..., None], light_v.normal,
                              vec.normalize(connect_vec))
    flux = light_v.ratio

    aw, au = mix_coeffs(ss)
    d_a0_w, d_a0_u = _eye_side_D(ts, ss, eye_v, light_v, connect_dir, flux)
    pdf_a = get_pdf_from_light_source(ts, light_v, eye_v.position,
                                      eye_v.normal)
    fm1 = torch.full_like(pdf_a, math.pi)
    inv_sp = 1.0 / torch.clamp(eye_v.single_pdf, min=1e-30)
    d_a_w = vec.float3weight(d_a0_w * (pdf_a * fm1)[..., None] * flux) * inv_sp
    d_a_u = d_a0_u * pdf_a * inv_sp
    d_a = aw * d_a_w + au * d_a_u

    weight = connect_rate(ss, eye_v.subspace_id, light_v.subspace_id,
                          vec.float3weight(flux))

    d_b0 = light_v.rmis
    lb = vec.normalize(eye_v.last_position - eye_v.position)
    pdf_b = get_pdf(ts, eye_v, light_v.position, light_v.normal,
                    light_v.is_env, lb)
    d_b = d_b0 * pdf_b / torch.clamp(light_v.single_pdf, min=1e-30)

    w = weight / torch.clamp(weight + d_a + d_b, min=1e-30)
    return torch.where(eye_v.is_brdf | light_v.is_brdf, 0.0, w)


def light_hit(ts, ss, eye_v: EyeVertices, lv_position, lv_normal, lv_flux,
              lv_pdf, lv_subspace):
    """rmis::light_hit (rmis.h:359-390): MIS weight (not its inverse) for an
    eye path that lands on an emitter (virtual depth-0 light vertex with
    rmis=1)."""
    connect_vec = eye_v.position - lv_position
    connect_dir = vec.normalize(connect_vec)
    flux = lv_flux / torch.clamp(lv_pdf, min=1e-30)[..., None]

    aw, au = mix_coeffs(ss)
    ll_pdf_a = get_last_pdf(ts, eye_v, -connect_dir)
    fm0 = flux_multiplier_last(ts, eye_v, -connect_dir)
    w_part, u_part = tracing_weight_eye_parts(ts, ss, eye_v, lv_position)
    d_a0_w = eye_v.rmis3 * ll_pdf_a[..., None] * fm0 + w_part[..., None]
    d_a0_u = eye_v.rmis_u * ll_pdf_a + u_part

    # virtual light vertex: area light from the emitter's pdf
    conn_vec2 = eye_v.position - lv_position
    pdf_angle = torch.abs(vec.dot(lv_normal, connect_dir)) / math.pi
    angle2a = (torch.abs(vec.dot(eye_v.normal, connect_dir))
               / torch.clamp(vec.dot(conn_vec2, conn_vec2), min=1e-20))
    pdf_a = pdf_angle * angle2a
    fm1 = math.pi
    inv_sp = 1.0 / torch.clamp(eye_v.single_pdf, min=1e-30)
    d_a = (aw * vec.float3weight(d_a0_w * (pdf_a * fm1)[..., None] * flux)
           + au * d_a0_u * pdf_a) * inv_sp

    weight = connect_rate(ss, eye_v.subspace_id, lv_subspace,
                          vec.float3weight(flux))
    weight = torch.where(eye_v.is_brdf, 0.0, weight)

    d_b = torch.ones_like(pdf_a)  # virtual vertex rmis = 1
    lb = vec.normalize(eye_v.last_position - eye_v.position)
    pdf_b = get_pdf(ts, eye_v, lv_position, lv_normal,
                    torch.zeros_like(eye_v.single_pdf, dtype=torch.bool), lb)
    denom = ((weight + d_a) / torch.clamp(pdf_b, min=1e-30) * lv_pdf + d_b)
    return d_b / torch.clamp(denom, min=1e-30)


def light_hit_env(ts, ss, eye_v: EyeVertices, ray_dir, env_flux, env_pdf,
                  env_label):
    """rmis::light_hit_env (rmis.h:325-357): environment maps are not
    ported yet."""
    raise NotImplementedError("environment maps are not ported yet")


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


def light_hit_env_cached(ts, ss, eye_v: EyeVertices, rmis3_next, rmis_u_next,
                         d, cos_last, pending_single,
                         env_flux, env_pdf, env_label):
    """light_hit_env from the update products: environment maps are not
    ported yet."""
    raise NotImplementedError("environment maps are not ported yet")

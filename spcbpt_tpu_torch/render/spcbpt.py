"""SPCBPT eye-side renderer: eye sub-paths with probabilistic, subspace-driven
connections to cached light vertices, weighted by recursive MIS.

Port of spcbpt_tpu/render/spcbpt.py (reference: __raygen__SPCBPT
raygen.cu:319-443, __closesthit__eyeSubpath hit_program.cu:246-340,
emitter hit hit_program.cu:62-147, connectVertex_SPCBPT raygen.cu:253-303):
per eye vertex draw CONNECTION_N light vertices by two-stage subspace
sampling, test visibility, and add
  contri/(pdf_eye*pdf_light) * G * fa * fb * rmis_weight / pmf / CONNECTION_N
with pmf = path_count * pmf1 * pmf2 (raygen.cu:410-414). Direct emitter hits
use the cached light_hit weight (hit_program.cu:128-147). With a sky, env
light vertices connect by direction (their visibility target lies 10r
beyond the eye vertex, against the env direction), and an eye path that
escapes adds the sky's radiance weighed by rmis.light_hit_env_cached
against those connections (the reference drops it, raygen.cu:699), so
BDPT/SPCBPT converge to PT on sky-lit scenes.

The same loop with uniform vertex choice (uniform=True) and an untrained
subspace state is the classic-BDPT baseline. The JAX lax.scan over the
depth cap is a Python loop.
"""
from __future__ import annotations

import torch

from ..config import (CONNECTION_N, CULL_BACKFACE, MIN_RR_RATE,
                      NUM_SUBSPACE, SCENE_EPSILON, SUBPATH_MAX_DEPTH)
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene import envmap as env_mod
from ..scene.scene import TraceScene, local_geometry, trace_closest, visibility
from ..train import classify
from ..utils import rng as rng_mod
from ..utils import vec
from . import common, rmis
from .lvc import (LVCSampler, sample_first_stage, sample_second_stage,
                  sample_second_stage_mixture, sample_second_stage_table,
                  sample_second_stage_uniform, sample_uniform)
from .rmis import EyeVertices
from .vertex import map_fields, unpack_rows, unpack_weight_b


def _init_eye_vertices(origins, dirs):
    """init_EyeSubpath (raygen.cu:222-238): camera vertex."""
    n = origins.shape[0]
    dev = origins.device
    z = torch.zeros((n,), device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    zb = torch.zeros((n,), dtype=torch.bool, device=dev)
    return EyeVertices(
        position=origins, normal=dirs, color=torch.ones((n, 3), device=dev),
        last_position=origins, single_pdf=torch.ones((n,), device=dev),
        last_normal_proj=torch.ones((n,), device=dev),
        rmis3=torch.zeros((n, 3), device=dev), rmis_u=z,
        mat_id=zi, subspace_id=zi, light_label=zi, last_zone_id=zi, depth=zi,
        is_ll_direction=zb, is_brdf=zb, last_brdf=zb,
    )


def connect_vertex(ts: TraceScene, ss: classify.SubspaceState,
                   eye_v, light_v):
    """connectVertex_SPCBPT (raygen.cu:253-303) WITHOUT the pmf division.
    Returns (N, 3) contribution (zero where invalid)."""
    connect_vec = eye_v.position - light_v.position
    connect_dir = vec.normalize(connect_vec)
    # direction/env light vertices connect by direction (raygen.cu:234-252)
    dir_conn = light_v.is_env
    conn_dir_e = torch.where(dir_conn[..., None], -light_v.normal, connect_dir)

    cos_a = torch.abs(vec.dot(eye_v.normal, conn_dir_e))
    cos_b = torch.abs(vec.dot(light_v.normal, connect_dir))
    g = cos_a * cos_b / torch.clamp(vec.dot(connect_vec, connect_vec),
                                    min=1e-20)

    la_dir = vec.normalize(eye_v.last_position - eye_v.position)
    lb_dir = vec.normalize(light_v.last_position - light_v.position)

    # eye->light direction: -connect_dir for surface vertices; for env
    # vertices conn_dir_e already points surface->env (negating it would
    # put the eval in the wrong hemisphere and zero every env connection)
    to_light = torch.where(dir_conn[..., None], conn_dir_e, -conn_dir_e)
    fa = rmis._eval_at(ts, eye_v, to_light, la_dir)
    fb = rmis._eval_at(ts, light_v, connect_dir, lb_dir)
    # origin (on-light) vertices: fb = [facing ? 1 : 0] (raygen.cu:275-287)
    facing = vec.dot(light_v.normal, -connect_dir) <= 0.0
    fb = torch.where(light_v.is_origin[..., None],
                     torch.where(facing[..., None], 1.0, 0.0), fb)

    # cumulative flux/pdf enter only as their ratio:
    # contri/pdf == eye.ratio * light.ratio * fa * fb * g
    contri = eye_v.ratio * light_v.ratio * fa * fb * g[..., None]

    w_general = rmis.general_connection(ts, ss, eye_v, light_v)
    w_source = rmis.connection_light_source(ts, ss, eye_v, light_v)
    w = torch.where(light_v.depth == 0, w_source, w_general)

    # direction-connect variant (raygen.cu:234-252)
    contri_dir = (eye_v.ratio * light_v.ratio * fa
                  * vec.dot(eye_v.normal, conn_dir_e)[..., None])
    ok_dir = vec.dot(eye_v.normal, conn_dir_e) > 0.0
    contri = torch.where(dir_conn[..., None],
                         torch.where(ok_dir[..., None], contri_dir, 0.0),
                         contri)

    return vec.scrub(contri * w[..., None])


def connect_vertex_fused(ts: TraceScene, ss: classify.SubspaceState,
                         eye_v, light_v, pmf1=None, eye_parts=None,
                         weight_b=None):
    """connect_vertex + general_connection + connection_light_source fused:
    the same weighted contribution with every shared quantity computed once
    (one material gather, one eval and one pdf pair per endpoint; the
    eye-side RMIS accumulator shared by both combiners; eval reciprocity
    folds the RMIS flux multipliers into fa/fb).

    Optional precomputed arguments, each exact:
      * pmf1: the first-stage pmf of light_v's subspace; when the first
        stage sampled the Gamma row, pmf1 == Gamma(eye_ss, light_ss);
      * eye_parts: rmis.tracing_weight_eye_parts(eye_v), once per eye vertex;
      * weight_b: per-vertex rmis.tracing_weight_light from the packed LVC.
    Reference: connectVertex_SPCBPT raygen.cu:253-303 + rmis.h:212-323."""
    conn_vec = eye_v.position - light_v.position
    connect_dir = vec.normalize(conn_vec)            # light -> eye
    dir_conn = light_v.is_env
    conn_dir_e = torch.where(dir_conn[..., None], -light_v.normal, connect_dir)
    # eye->light direction; for env lanes conn_dir_e already points
    # surface->env, so it is not negated there
    in_e = torch.where(dir_conn[..., None], conn_dir_e, -conn_dir_e)

    la = vec.normalize(eye_v.last_position - eye_v.position)
    lb = vec.normalize(light_v.last_position - light_v.position)
    mat_e = bsdf_mod.gather_mat(ts.mats, torch.clamp(eye_v.mat_id, min=0),
                                eye_v.color)
    mat_l = bsdf_mod.gather_mat(ts.mats, torch.clamp(light_v.mat_id, min=0),
                                light_v.color)
    rr_e = bsdf_mod.rr_rate(eye_v.color, MIN_RR_RATE)
    rr_l = bsdf_mod.rr_rate(light_v.color, MIN_RR_RATE)
    flux = light_v.ratio
    lum_flux = vec.float3weight(flux)
    inv_sp_e = 1.0 / torch.clamp(eye_v.single_pdf, min=1e-30)
    inv_sp_l = 1.0 / torch.clamp(light_v.single_pdf, min=1e-30)
    aw, au = rmis.mix_coeffs(ss)

    # ---- contribution factors (connectVertex_SPCBPT raygen.cu:253-303) ----
    cos_a = torch.abs(vec.dot(eye_v.normal, conn_dir_e))
    cos_b = torch.abs(vec.dot(light_v.normal, connect_dir))
    g = cos_a * cos_b / torch.clamp(vec.dot(conn_vec, conn_vec), min=1e-20)
    fa = bsdf_mod.eval_bsdf(mat_e, eye_v.normal, in_e, la)
    fb = bsdf_mod.eval_bsdf(mat_l, light_v.normal, connect_dir, lb)
    facing = vec.dot(light_v.normal, -connect_dir) <= 0.0
    fb_eff = torch.where(light_v.is_origin[..., None],
                         torch.where(facing[..., None], 1.0, 0.0), fb)
    contri = eye_v.ratio * flux * fa * fb_eff * g[..., None]
    contri_dir = (eye_v.ratio * flux * fa
                  * vec.dot(eye_v.normal, conn_dir_e)[..., None])
    ok_dir = vec.dot(eye_v.normal, conn_dir_e) > 0.0
    contri = torch.where(dir_conn[..., None],
                         torch.where(ok_dir[..., None], contri_dir, 0.0),
                         contri)

    # ---- shared eye-side RMIS accumulator (rmis.h:219-233) ----
    pdf_e_fwd, pdf_e_rev = bsdf_mod.pdf_bsdf_pair(mat_e, eye_v.normal, in_e,
                                                  la)
    last_vec_e = eye_v.last_position - eye_v.position
    conv_last_e = eye_v.last_normal_proj / torch.clamp(
        vec.dot(last_vec_e, last_vec_e), min=1e-20)
    ll_pdf_a = (torch.where(eye_v.is_ll_direction, pdf_e_fwd,
                            pdf_e_fwd * conv_last_e) * rr_e)
    cos_e_la = torch.abs(vec.dot(eye_v.normal, la))
    fm0 = fa * (cos_e_la / torch.clamp(pdf_e_fwd * rr_e, min=1e-20))[..., None]
    if eye_parts is None:
        eye_parts = rmis.tracing_weight_eye_parts(ts, ss, eye_v,
                                                  light_v.position)
    w_part, u_part = eye_parts
    d_a0_w = eye_v.rmis3 * ll_pdf_a[..., None] * fm0 + w_part[..., None]
    d_a0_u = eye_v.rmis_u * ll_pdf_a + u_part

    # pdf_b = get_pdf(eye_v, light_v.position, light_v.normal, is_env, la):
    # its out_dir equals in_e on every lane
    conv_b = cos_b / torch.clamp(vec.dot(conn_vec, conn_vec), min=1e-20)
    pdf_b = torch.where(light_v.is_env, pdf_e_rev, pdf_e_rev * conv_b) * rr_e

    # strategy weight of THIS connection (shared by both combiners)
    if pmf1 is not None and ss.trained:
        # pmf1 == Gamma(eye_ss, light_ss): connect_rate without the 2D gather
        lsub = light_v.subspace_id.long()
        base = pmf1 * CONNECTION_N
        weight = torch.zeros_like(pmf1)
        if aw != 0.0:
            weight = weight + aw * base * lum_flux / ss.q[lsub]
        if au != 0.0 and ss.inv_occ is not None:
            weight = weight + au * base * ss.inv_occ[
                torch.clamp(lsub, 0, NUM_SUBSPACE - 1)]
    else:
        weight = rmis.connect_rate(ss, eye_v.subspace_id,
                                   light_v.subspace_id, lum_flux)

    # ---- general combiner (light depth > 0; rmis.h:212-247) ----
    pdf_l_fwd, pdf_l_rev = bsdf_mod.pdf_bsdf_pair(mat_l, light_v.normal, lb,
                                                  connect_dir)
    conv_a = cos_a / torch.clamp(vec.dot(conn_vec, conn_vec), min=1e-20)
    pdf_a_gen = pdf_l_fwd * conv_a * rr_l
    cos_l_cd = torch.abs(vec.dot(light_v.normal, connect_dir))
    fm1 = fb * (cos_l_cd / torch.clamp(pdf_l_fwd * rr_l, min=1e-20))[..., None]
    d_a_gen = (aw * vec.float3weight(d_a0_w * pdf_a_gen[..., None] * fm1
                                     * flux)
               + au * d_a0_u * pdf_a_gen) * inv_sp_e
    last_vec_l = light_v.last_position - light_v.position
    conv_last_l = light_v.last_normal_proj / torch.clamp(
        vec.dot(last_vec_l, last_vec_l), min=1e-20)
    ll_pdf_b = (torch.where(light_v.is_ll_direction, pdf_l_rev,
                            pdf_l_rev * conv_last_l) * rr_l)
    if weight_b is None:
        weight_b = rmis.tracing_weight_light(ts, ss, light_v, eye_v.position)
    d_b_gen = (light_v.rmis * ll_pdf_b + weight_b) * pdf_b * inv_sp_l
    w_gen = weight / torch.clamp(weight + d_a_gen + d_b_gen, min=1e-30)

    # ---- light-source combiner (light depth == 0; rmis.h:281-323) ----
    pdf_a_src = rmis.get_pdf_from_light_source(ts, light_v, eye_v.position,
                                               eye_v.normal)
    fm1_src = rmis.source_flux_multiplier(ts, light_v, pdf_a_src)
    d_a_src = (aw * vec.float3weight(d_a0_w * (pdf_a_src * fm1_src)[..., None]
                                     * flux)
               + au * d_a0_u * pdf_a_src) * inv_sp_e
    d_b_src = light_v.rmis * pdf_b * inv_sp_l
    w_src = weight / torch.clamp(weight + d_a_src + d_b_src, min=1e-30)

    w = torch.where(light_v.depth == 0, w_src, w_gen)
    w = torch.where(eye_v.is_brdf | light_v.is_brdf, 0.0, w)
    return vec.scrub(contri * w[..., None])


class _ConnEye:
    """Eye vertex view exposing the cumulative flux/pdf ratio for
    connection eval."""

    def __init__(self, v: EyeVertices, ratio):
        self._v = v
        self.ratio = ratio

    def __getattr__(self, k):
        return getattr(self._v, k)


def _connections(ts, ss, sampler, mid: EyeVertices, eye_ratio, state,
                 connection_n: int, uniform: bool, second_stage=None,
                 live=None):
    """The CONNECTION_N sampling/eval loop; returns (sum contribution, state).
    second_stage=None follows the state's calibration (uniform when
    untrained), so the sampler always matches the MIS weights."""
    n = eye_ratio.shape[0]
    dev = eye_ratio.device
    total = torch.zeros((n, 3), device=dev)
    if connection_n == 0:
        return total, state
    if second_stage is None:
        second_stage = ss.second_stage if ss.trained else "uniform"
    # per-frame presampled table for this mode (lvc.presample_tables)
    use_table = (sampler.table_idx is not None
                 and sampler.table_mode == second_stage)
    draws = []
    for _ in range(connection_n):
        if uniform:
            idx, pmf2, ok_seg, state = sample_uniform(sampler, state)
            pmf1 = torch.ones_like(pmf2)
        else:
            lsub, pmf1, state = sample_first_stage(
                ss, mid.subspace_id, state,
                position=mid.position, normal=mid.normal)
            if second_stage == "uniform":
                idx, pmf2, ok_seg, state = sample_second_stage_uniform(
                    sampler, lsub, state)
            elif use_table:
                idx, pmf2, ok_seg, state = sample_second_stage_table(
                    sampler, lsub, state)
            elif second_stage == "mixture":
                idx, pmf2, ok_seg, state = sample_second_stage_mixture(
                    sampler, lsub, state)
            else:
                idx, pmf2, ok_seg, state = sample_second_stage(
                    sampler, lsub, state)
        draws.append((idx, pmf1, pmf2, ok_seg))
    # one occlusion wavefront for all connection_n draws
    expand = lambda a: a.expand(n) if a.dim() == 0 else a
    idx_all = torch.cat([expand(d[0]) for d in draws])
    rows = sampler.packed[idx_all]           # one row gather per draw
    lv_all = unpack_rows(rows)
    wb_all = unpack_weight_b(rows) if sampler.has_weight_b else None
    tile = lambda a: a.repeat((connection_n,) + (1,) * (a.dim() - 1))
    pos_all = tile(mid.position)
    # env light vertices are directions: their target lies 10r beyond the
    # eye vertex, against the stored normal (-direction)
    target_all = torch.where(lv_all.is_env[..., None],
                             pos_all - 10.0 * ts.env.r * lv_all.normal,
                             lv_all.position)
    # contribution and pmf BEFORE the occlusion test, so lanes that cannot
    # contribute are masked out of the traversal (visibility mask=)
    eye_all = _ConnEye(map_fields(tile, mid), tile(eye_ratio))
    pmf1_all = torch.cat([expand(d[1]) for d in draws])
    pmf2_all = torch.cat([expand(d[2]) for d in draws])
    ok_seg_all = torch.cat([expand(d[3]) for d in draws])
    # eye_parts once per eye vertex; weight_b from the packed LVC column;
    # the strategy weight from pmf1 when the first stage sampled Gamma rows
    parts = rmis.tracing_weight_eye_parts(ts, ss, mid, mid.position)
    eye_parts = (tile(parts[0]), tile(parts[1]))
    pmf1_is_gamma = (not uniform) and ss.trained and ss.nn is None
    contrib_all = connect_vertex_fused(
        ts, ss, eye_all, lv_all,
        pmf1=pmf1_all if pmf1_is_gamma else None,
        eye_parts=eye_parts, weight_b=wb_all)
    pmf_all = sampler.path_count.to(torch.float32) * pmf1_all * pmf2_all
    can_contribute = (ok_seg_all & lv_all.valid & (pmf_all > 0.0)
                      & torch.any(contrib_all != 0.0, dim=-1))
    if live is not None:
        # dead eye lanes: the caller zeroes their result; skip their rays
        can_contribute = can_contribute & tile(live)
    vis_all = visibility(ts, pos_all, target_all, SCENE_EPSILON,
                         mask=can_contribute)
    ok_all = can_contribute & vis_all
    term = torch.where(ok_all[..., None],
                       contrib_all / torch.clamp(pmf_all, min=1e-30)[..., None],
                       0.0)
    total = term.reshape(connection_n, n, 3).sum(dim=0)
    return total, state


def _eye_bounce(ts, ss, sampler, c, connection_n, uniform, second_stage,
                live):
    """The shared per-bounce body of the eye loop (make_spcbpt_step and
    spcbpt_pool.render_pool): trace, emitter hit with the cached light_hit
    weight, the sky's escape with light_hit_env_cached, the new eye vertex, its connections, then RR + BSDF bounce.
    `c` holds o, d, state, v, ratio, pending_f, pending_single, result and
    depth; `live` masks the lanes that trace. Returns a dict of the
    per-bounce results the two loops assemble their carries from."""
    last = c["v"]
    hit = trace_closest(ts, c["o"], c["d"], SCENE_EPSILON,
                        torch.where(live, 1e16, -1.0), CULL_BACKFACE)
    geom = local_geometry(ts, hit, c["o"], c["d"])
    miss = ~hit.valid & live
    hit_light = hit.valid & (geom["light_id"] >= 0) & live
    hit_surf = hit.valid & (geom["light_id"] < 0) & live

    d = c["d"]
    cos_mid_l = torch.abs(vec.dot(geom["Ns"], d))
    # camera vertex "normal" is the primary ray direction, so this is
    # exactly 1 on the first segment (init_EyeSubpath raygen.cu:222)
    cos_last = torch.abs(vec.dot(last.normal, d))
    inv_t2 = 1.0 / torch.clamp(hit.t * hit.t, min=1e-20)

    # RMIS recursion update for the next vertex, computed first so the
    # emitter-hit weight reuses its products (rmis.light_hit_cached);
    # in_dir=d is exact for miss lanes too
    rmis3_new, rmis_u_new = rmis.tracing_update_eye(
        ts, ss, last, geom["P"], torch.zeros_like(hit.valid), in_dir=d)

    # ---- emitter hit (hit_program.cu:62-147) ----
    lid = torch.clamp(geom["light_id"], min=0)
    ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
    front = vec.dot(d, ls_rev.normal) <= 0.0
    # depth>=2: the pending BSDF factor from the previous bounce folds in
    # here (hit_program.cu:99-106)
    step = (cos_last / torch.clamp(c["pending_single"], min=1e-30))[..., None]
    carried = torch.where((last.depth == 0)[..., None], c["ratio"],
                          c["pending_f"] * c["ratio"])
    ratio_l = carried * (step * ls_rev.emission)
    w_hit = rmis.light_hit_cached(
        ss, last, rmis3_new, rmis_u_new, d, cos_last, inv_t2,
        c["pending_single"], ls_rev.normal, ls_rev.emission,
        ls_rev.pdf, ls_rev.subspace_id)
    w_hit = torch.where(c["depth"] == 0, 1.0, w_hit)   # direct hit
    emit = ratio_l * w_hit[..., None]
    result = c["result"] + torch.where((hit_light & front)[..., None],
                                       vec.scrub(emit), 0.0)

    # ---- env escape: a virtual direction-light hit, weighed against the
    # env LVC connections (the reference drops it, raygen.cu:699) ----
    if ts.has_env:
        env_rad = env_mod.env_color(ts.env, d)
        ratio_env = carried * (step * env_rad)
        e_pdf = env_mod.env_pdf(ts.env, d) / ts.num_lights
        w_env = rmis.light_hit_env_cached(
            ts, ss, last, rmis3_new, rmis_u_new, d, cos_last,
            c["pending_single"], env_rad, e_pdf, env_mod.env_label(ts.env, d))
        w_env = torch.where(c["depth"] == 0, 1.0, w_env)
        result = result + torch.where(
            miss[..., None], vec.scrub(ratio_env * w_env[..., None]), 0.0)

    # ---- new eye vertex (hit_program.cu:246-340) ----
    pdf_g = cos_mid_l * cos_last * inv_t2
    ratio_mid = carried * step
    single_mid = c["pending_single"] * pdf_g / torch.clamp(cos_last,
                                                           min=1e-20)
    first = last.depth == 0
    rmis3 = torch.where(first[..., None], torch.zeros_like(rmis3_new),
                        rmis3_new)
    rmis_u = torch.where(first, 0.0, rmis_u_new)
    zb = torch.zeros_like(hit_surf)
    mid = EyeVertices(
        position=geom["P"], normal=geom["Ns"], color=geom["base_color"],
        last_position=last.position, single_pdf=single_mid,
        last_normal_proj=cos_last, rmis3=rmis3, rmis_u=rmis_u,
        mat_id=geom["mat_id"],
        subspace_id=classify.label_eye(ss, geom["P"], geom["Ns"]),
        light_label=classify.label_light(ss, geom["P"], geom["Ns"]),
        last_zone_id=last.subspace_id, depth=last.depth + 1,
        is_ll_direction=zb, is_brdf=zb, last_brdf=last.is_brdf,
    )

    # ---- CONNECTION_N probabilistic connections (raygen.cu:390-420) ----
    state = c["state"]
    if connection_n > 0:
        conn_total, state = _connections(
            ts, ss, sampler, mid, ratio_mid, state, connection_n, uniform,
            second_stage, live=hit_surf)
        result = result + torch.where(hit_surf[..., None],
                                      conn_total / connection_n, 0.0)

    # ---- RR + bounce ----
    v_dir = -d
    mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
    new_d, state = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, state)
    bpdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
    f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
    rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
    r, state = rng_mod.next_float(state)
    cont = hit_surf & (r <= rr) & (bpdf > 0.0)
    return dict(P=geom["P"], miss=miss, hit_light=hit_light,
                hit_surf=hit_surf, mid=mid, ratio_mid=ratio_mid,
                result=result, state=state, new_d=new_d, f=f,
                pdf_rr=bpdf * rr, cont=cont)


def _select(mask, new, old):
    """Per-lane select of a record of tensors (mask over the lane axis)."""
    return map_fields(
        lambda a, b: torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                                 a, b), new, old)


def make_spcbpt_step(ts: TraceScene, ss: classify.SubspaceState,
                     sampler: LVCSampler, max_depth: int = SUBPATH_MAX_DEPTH,
                     connection_n: int = CONNECTION_N, uniform: bool = False,
                     second_stage=None, record: bool = False):
    """Returns f(origins, dirs, rng_state) -> (N, 3) one SPCBPT sample/lane.

    record=True additionally returns the per-depth eye vertices (dict with
    v: EyeVertices, ratio and valid, leading axis = depth-1) so tests can
    rebuild complete paths."""

    def step(origins, dirs, state):
        n = origins.shape[0]
        dev = origins.device
        c = dict(o=origins, d=dirs, state=state,
                 v=_init_eye_vertices(origins, dirs),
                 ratio=torch.ones((n, 3), device=dev),
                 pending_f=torch.ones((n, 3), device=dev),
                 pending_single=torch.ones((n,), device=dev),
                 result=torch.zeros((n, 3), device=dev),
                 depth=torch.zeros((n,), dtype=torch.int32, device=dev))
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        ys = []
        for _ in range(max_depth + 1):
            live = ~done
            b = _eye_bounce(ts, ss, sampler, c, connection_n, uniform,
                            second_stage, live)
            cont, keep = b["cont"], b["hit_surf"]
            depth = c["depth"] + live.to(torch.int32)
            done = done | b["miss"] | b["hit_light"] | (keep & ~cont) \
                | (depth > max_depth)
            if record:
                ys.append(dict(v=b["mid"], ratio=b["ratio_mid"], valid=keep))
            c = dict(
                o=vec.where3(cont, b["P"], c["o"]),
                d=vec.where3(cont, b["new_d"], c["d"]),
                state=b["state"],
                v=_select(keep, b["mid"], c["v"]),
                ratio=vec.where3(keep, b["ratio_mid"], c["ratio"]),
                pending_f=vec.where3(cont, b["f"], c["pending_f"]),
                pending_single=torch.where(cont, b["pdf_rr"],
                                           c["pending_single"]),
                result=b["result"],
                depth=depth)
        if record:
            return c["result"], dict(
                v=map_fields(lambda *xs: torch.stack(xs),
                             *[y["v"] for y in ys]),
                ratio=torch.stack([y["ratio"] for y in ys]),
                valid=torch.stack([y["valid"] for y in ys]))
        return c["result"]

    return step


def trace_eye_paths(ts: TraceScene, ss: classify.SubspaceState,
                    origins, dirs, state, max_depth: int):
    """Trace eye sub-paths and return the per-depth EyeVertices records
    (dict with v: EyeVertices, ratio, valid; leading axis = depth-1). Runs
    the same loop body as the SPCBPT renderer with connections disabled, so
    the cached RMIS state is exactly what the renderer would use."""
    step = make_spcbpt_step(ts, ss, None, max_depth=max_depth,
                            connection_n=0, record=True)
    _, ys = step(origins, dirs, state)
    return ys


def render_frame(ts, ss, sampler, cam_uvw, width, height, subframe,
                 max_depth=SUBPATH_MAX_DEPTH, connection_n=CONNECTION_N,
                 uniform=False):
    """One SPCBPT sample for every pixel. Returns (W*H, 3)."""
    eye, U, V, W = cam_uvw
    o, d, state = common.camera_rays(eye, U, V, W, width, height, subframe,
                                     device=ts.device)
    return make_spcbpt_step(ts, ss, sampler, max_depth, connection_n,
                            uniform)(o, d, state)

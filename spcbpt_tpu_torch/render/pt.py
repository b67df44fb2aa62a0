"""Wavefront unidirectional path tracer with NEE + MIS (baseline algorithm).

Port of spcbpt_tpu/render/pt.py (reference: __raygen__pinhole
raygen.cu:71-170, __closesthit__radiance hit_program.cu:439-552,
__closesthit__lightsource hit_program.cu:148-180):

per bounce: trace -> if miss, the sky's radiance only at depth 0
(raygen.cu:691-695) -> if emitter, one-sided emission with area-vs-bsdf MIS
(weight 1 at depth 0) -> else NEE to one uniformly picked light (a quad
with the reciprocal MIS weight, or the sky with none, hit_program.cu:505-521)
and a deferred visibility ray, then RR
(rate = clamp(max base_color, MIN_RR_RATE, 1)) and Disney BSDF bounce.
30-bounce cap. All pixels advance together through a Python loop over the
depth cap with an alive mask; the two traversal calls per bounce (closest +
shadow) are batched over the full wavefront.
"""
from __future__ import annotations

import torch

from ..config import (CULL_BACKFACE, MIN_RR_RATE, PT_MAX_DEPTH,
                      SCENE_EPSILON)
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene import envmap as env_mod
from ..scene.scene import TraceScene, local_geometry, trace_any, trace_closest
from ..utils import rng as rng_mod
from ..utils import vec
from . import common


def _nee(ts: TraceScene, geom, v_dir, throughput, state, mask=None):
    """Next-event estimation at a surface hit (hit_program.cu:462-525).
    Returns (contribution, state); contribution already includes the
    visibility test. mask: lanes where False are not shadow-traced
    (dead-lane tmax convention); their contribution is zeroed."""
    ls, state = lights_mod.sample_light(ts, state)
    P = geom["P"]
    N = geom["Ns"]
    mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
    rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)

    to_l = ls.position - P
    l_dist = torch.clamp(vec.length(to_l), min=1e-8)
    L_q = to_l / l_dist[..., None]
    ln = ls.normal
    l_dot_ln = vec.dot(-L_q, ln)
    n_dot_l = vec.dot(N, L_q)
    n_dot_v = vec.dot(N, v_dir)
    ok_q = (n_dot_l > 0.0) & (n_dot_v > 0.0) & (l_dot_ln > 0.0) & ~ls.is_env
    f_q = bsdf_mod.eval_bsdf(mat, N, v_dir, L_q)
    pdf_hit = (bsdf_mod.pdf_bsdf(mat, N, v_dir, L_q)
               * torch.abs(l_dot_ln) / torch.clamp(l_dist * l_dist, min=1e-12)
               * rr)
    mis_q = ls.pdf / torch.clamp(pdf_hit + ls.pdf, min=1e-30)
    contrib_q = (throughput * ls.emission / ls.pdf[..., None]
                 * (n_dot_l * l_dot_ln / (l_dist * l_dist) * mis_q)[..., None]
                 * f_q)
    contrib_q = torch.where(ok_q[..., None], contrib_q, 0.0)
    target = ls.position

    if ts.has_env:
        # env branch (hit_program.cu:505-521): no MIS weight in the reference
        L_e = ls.direction
        l_dot_n = vec.dot(L_e, N)
        ok_e = (l_dot_n > 0.0) & ls.is_env
        f_e = bsdf_mod.eval_bsdf(mat, N, v_dir, L_e)
        contrib_e = (throughput * ls.emission / ls.pdf[..., None]
                     * l_dot_n[..., None] * f_e)
        contrib = torch.where(ok_e[..., None], contrib_e, contrib_q)
        target = vec.where3(ls.is_env, P + L_e * (2.0 * ts.env.r),
                            ls.position)
        ok = ok_q | ok_e
    else:
        contrib = contrib_q
        ok = ok_q

    # deferred visibility ray (raygen.cu:134-143); lanes that cannot
    # contribute drop their tmax below tmin so the walk skips them
    if mask is not None:
        ok = ok & mask
    seg = target - P
    seg_len = torch.clamp(vec.length(seg), min=1e-8)
    seg_dir = seg / seg_len[..., None]
    tmax_v = torch.where(ok, seg_len - SCENE_EPSILON, -1.0)
    occluded = trace_any(ts, P, seg_dir,
                         torch.full_like(seg_len, SCENE_EPSILON), tmax_v)
    contrib = torch.where((ok & ~occluded)[..., None], contrib, 0.0)
    return vec.scrub(contrib), state


def escape(ts: TraceScene, miss, d, throughput, depth):
    """The sky's radiance on lanes that miss everything, for primary rays
    only (raygen.cu:691-695). Callers add it when the scene has a sky."""
    env_rad = throughput * env_mod.env_color(ts.env, d)
    return vec.scrub(torch.where((miss & (depth == 0))[..., None], env_rad,
                                 0.0))


def emitter_hit(ts: TraceScene, geom, hit, d, throughput, bsdf_pdf, depth):
    """Radiance of a path that hits an emitter (hit_program.cu:148-180):
    one-sided emission with the area-vs-bsdf MIS weight, weight 1 at depth 0.
    Returns (contribution, front-facing mask)."""
    lid = torch.clamp(geom["light_id"], min=0)
    ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
    front = vec.dot(d, ls_rev.normal) <= 0.0
    pdf_hit = (bsdf_pdf * torch.abs(vec.dot(d, ls_rev.normal))
               / torch.clamp(hit.t * hit.t, min=1e-12))
    mis = torch.where(depth == 0, 1.0,
                      pdf_hit / torch.clamp(ls_rev.pdf + pdf_hit, min=1e-30))
    return throughput * ls_rev.emission * mis[..., None], front


def bounce(ts: TraceScene, geom, d, state):
    """RR + BSDF bounce (hit_program.cu:527-551). Returns (new direction,
    bsdf pdf, RR rate, throughput ratio, killed-by-RR mask, new state); the
    ratio includes the RR rate, the pdf does not."""
    v_dir = -d
    rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
    r, state = rng_mod.next_float(state)
    kill = r > rr
    mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
    new_d, state = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, state)
    pdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
    f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
    cos = torch.abs(vec.dot(new_d, geom["Ns"]))
    ratio = f * (cos / torch.clamp(pdf, min=1e-20) / rr)[..., None]
    return new_d, pdf, rr, ratio, kill, state


def make_pt_step(ts: TraceScene, max_depth: int = PT_MAX_DEPTH):
    """Returns f(origins, dirs, rng_state) -> radiance (N, 3): one sample per
    lane of the full PT estimator."""

    def step(origins, dirs, state):
        n = origins.shape[0]
        dev = origins.device
        o, d = origins, dirs
        throughput = torch.ones((n, 3), device=dev)
        result = torch.zeros((n, 3), device=dev)
        bsdf_pdf = torch.zeros((n,), device=dev)
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        depth = torch.zeros((n,), dtype=torch.int32, device=dev)
        for _ in range(max_depth + 1):
            live = ~done
            # done lanes keep their last (o, d); the dead-lane tmax makes
            # the walk skip them
            hit = trace_closest(ts, o, d, SCENE_EPSILON,
                                torch.where(live, 1e16, -1.0), CULL_BACKFACE)
            miss = ~hit.valid & live
            if ts.has_env:
                result = result + escape(ts, miss, d, throughput, depth)
            geom = local_geometry(ts, hit, o, d)
            hit_light = hit.valid & (geom["light_id"] >= 0) & live
            hit_surface = hit.valid & (geom["light_id"] < 0) & live

            emit, front = emitter_hit(ts, geom, hit, d, throughput, bsdf_pdf,
                                      depth)
            result = result + vec.scrub(
                torch.where((hit_light & front)[..., None], emit, 0.0))

            nee, state2 = _nee(ts, geom, -d, throughput, state,
                               mask=hit_surface)
            result = result + torch.where(hit_surface[..., None], nee, 0.0)

            new_d, pdf, rr, ratio, kill, state2 = bounce(ts, geom, d, state2)
            cont = hit_surface & ~kill & (pdf > 0.0)
            throughput = vec.where3(cont, throughput * ratio, throughput)

            depth = depth + live.to(torch.int32)
            done = done | miss | hit_light | (hit_surface & ~cont) \
                | (depth > max_depth)
            o = vec.where3(cont, geom["P"], o)
            d = vec.where3(cont, new_d, d)
            state = state2
            bsdf_pdf = torch.where(cont, pdf * rr, bsdf_pdf)
        return result

    return step


def render_frame(ts: TraceScene, cam_uvw, width: int, height: int,
                 subframe: int, max_depth: int = PT_MAX_DEPTH):
    """One progressive PT sample for every pixel. Returns (W*H, 3)."""
    eye, U, V, W = cam_uvw
    o, d, state = common.camera_rays(eye, U, V, W, width, height, subframe,
                                     device=ts.device)
    return make_pt_step(ts, max_depth)(o, d, state)

"""Training-data tracer: NEE path tracer that records, per sampled path, its
contribution/pdf and a connection record for every prefix-suffix split.

Port of spcbpt_tpu/train/pretrace.py (reference: __raygen__TrainData
raygen.cu:751-868, PreTrace_buildPathInfo raygen.cu:708-739,
nVertex/nVertex_device optixPathTracer.h:264-385 + cuProg.h:1128-1292): each
lane traces one eye path per launch; at every vertex it samples one light
(NEE) and, if visible, reservoir-accepts the completed path with
probability 1/(n+1); hitting an emitter likewise completes a path. An
accepted path replaces the lane's stored record: contribution, sample_pdf
(BSDF-strategy pdf + NEE pdf; divided at the end by the number of resample
candidates), fix_pdf, and one connection node per split with peak_pdf =
eye_prefix_pdf * light_suffix_contribution.

Fixed (n_core,) lanes; eye prefix vertices live in per-lane buffers of
`padding` slots. The JAX lax.scan over the bounces is a Python loop that
stops once no lane is live: a dead lane never accepts and never writes its
buffers, so the draws it would still make change nothing. With a sky, NEE
may pick the environment: its visibility target lies 10r along the sampled
direction, and its light record is a direction (is_dir), whose
light-source pdf in the backward walk is the projected disk's
(scene/envmap.env_project_pdf).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import (CULL_BACKFACE, MIN_RR_RATE, PRETRACE_CONN_PADDING,
                      SCENE_EPSILON)
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene import envmap as env_mod
from ..scene.scene import TraceScene, local_geometry, trace_closest, visibility
from ..utils import rng as rng_mod
from ..utils import vec


class PretraceBatch(NamedTuple):
    """One launch worth of pathInfo_sample + padded pathInfo_node records
    (optixPathTracer.h:316-364); torch tensors from a launch, numpy arrays
    in the host corpus."""
    contri: torch.Tensor       # (P, 3)
    sample_pdf: torch.Tensor   # (P,)
    fix_pdf: torch.Tensor      # (P,)
    n_conns: torch.Tensor      # (P,) int32
    pixel: torch.Tensor        # (P, 2) int32
    valid: torch.Tensor        # (P,) bool
    a_position: torch.Tensor   # (P, C, 3) eye-side split vertex
    a_normal: torch.Tensor     # (P, C, 3)
    a_dir: torch.Tensor        # (P, C, 3)
    b_position: torch.Tensor   # (P, C, 3) light-side aggregate vertex
    b_normal: torch.Tensor     # (P, C, 3)
    b_dir: torch.Tensor        # (P, C, 3)
    peak_pdf: torch.Tensor     # (P, C)
    label_a: torch.Tensor      # (P, C) int32 (filled after tree build)
    label_b: torch.Tensor      # (P, C) int32 (light-source bins pre-filled)
    light_source: torch.Tensor  # (P, C) bool
    conn_valid: torch.Tensor   # (P, C) bool


_INT_FIELDS = ("n_conns", "pixel", "label_a", "label_b")
_BOOL_FIELDS = ("valid", "light_source", "conn_valid")


def to_host(batch: PretraceBatch) -> PretraceBatch:
    """The same batch as numpy arrays."""
    return PretraceBatch(*[x.cpu().numpy() for x in batch])


def from_jax_batch(jbatch, device) -> PretraceBatch:
    """The port's PretraceBatch from a JAX spcbpt_tpu PretraceBatch, whose
    arrays are read as numpy (no jax import here)."""
    out = {}
    for name in PretraceBatch._fields:
        dt = (torch.int32 if name in _INT_FIELDS else
              torch.bool if name in _BOOL_FIELDS else torch.float32)
        out[name] = torch.tensor(np.asarray(getattr(jbatch, name)), dtype=dt,
                                 device=device)
    return PretraceBatch(**out)


def _pdf_rr(ts, mat_id, color, normal, in_dir, out_dir):
    mat = bsdf_mod.gather_mat(ts.mats, torch.clamp(mat_id, min=0), color)
    pdf = bsdf_mod.pdf_bsdf(mat, normal, in_dir, out_dir)
    rr = torch.clamp(torch.amax(color, dim=-1), min=MIN_RR_RATE)
    return pdf * rr


def _eval_at(ts, mat_id, color, normal, in_dir, out_dir):
    mat = bsdf_mod.gather_mat(ts.mats, torch.clamp(mat_id, min=0), color)
    return bsdf_mod.eval_bsdf(mat, normal, in_dir, out_dir)


def _build_path_info(ts: TraceScene, buf, k, light):
    """PreTrace_buildPathInfo (raygen.cu:708-739), vectorized over lanes.

    buf: dict of (N, C[, 3]) eye-vertex buffers (slot 0 = camera vertex;
      fields: position, normal, dir (toward previous), color, mat_id, flux,
      pdf, depth);
    k: (N,) number of filled eye slots; the path connects at slot k-1;
    light: dict light-source nVertex: position, normal, weight (3,) emission,
      pdf, label, is_dir.
    Returns (path dict, conn dict of (N, C, ...) tensors)."""
    n, cpad = buf["position"].shape[:2]
    dev = buf["position"].device
    lanes = torch.arange(n, device=dev)

    def slot(name, i):
        return buf[name][lanes, i.long()]

    ke = torch.clamp(k - 1, min=0)
    eye_pos = slot("position", ke)
    eye_norm = slot("normal", ke)
    eye_dirv = slot("dir", ke)
    eye_color = slot("color", ke)
    eye_mat = slot("mat_id", ke)
    eye_pdf = slot("pdf", ke)
    eye_flux = slot("flux", ke)

    # n_eye.forward_eye(light): BSDF-strategy pdf of generating the light
    # vertex from the eye vertex (cuProg.h:1221-1242)
    is_dir = light["is_dir"]
    vecl = light["position"] - eye_pos
    c_dir = torch.where(is_dir[..., None], -light["normal"],
                        vec.normalize(vecl))
    dist2 = torch.clamp(vec.dot(vecl, vecl), min=1e-20)
    g_e = torch.abs(vec.dot(c_dir, light["normal"])) / dist2
    d_pdf = _pdf_rr(ts, eye_mat, eye_color, eye_norm, eye_dirv, c_dir)
    fwd_eye_pdf = eye_pdf * d_pdf * torch.where(is_dir, 1.0, g_e)

    seg_contri = _eval_at(ts, eye_mat, eye_color, eye_norm, eye_dirv, c_dir)

    # light.forward_light(n_eye) (cuProg.h:1244-1258): this = light source
    cdir_le = -c_dir  # light -> eye (abs() makes the sign immaterial)
    g_area = (torch.abs(vec.dot(cdir_le, eye_norm))
              * torch.abs(vec.dot(cdir_le, light["normal"])) / dist2)
    fwd_light = light["weight"] * torch.where(
        is_dir, torch.abs(vec.dot(light["normal"], eye_norm)),
        g_area)[..., None]

    path = dict(
        contri=eye_flux * fwd_light * seg_contri,
        sample_pdf=fwd_eye_pdf + eye_pdf * light["pdf"],
        fix_pdf=fwd_eye_pdf,
        n_conns=torch.clamp(k - 1, min=0),
    )

    # --- backward walk creating one conn per split (raygen.cu:726-733) ---
    z3 = lambda: torch.zeros((n, cpad, 3), device=dev)
    conn = dict(
        a_position=z3(), a_normal=z3(), a_dir=z3(), b_position=z3(),
        b_normal=z3(), b_dir=z3(),
        peak_pdf=torch.zeros((n, cpad), device=dev),
        label_a=torch.zeros((n, cpad), dtype=torch.int32, device=dev),
        label_b=torch.zeros((n, cpad), dtype=torch.int32, device=dev),
        light_source=torch.zeros((n, cpad), dtype=torch.bool, device=dev),
        conn_valid=torch.zeros((n, cpad), dtype=torch.bool, device=dev),
    )

    # current light-side aggregate vertex ("this" of forward_light)
    b = dict(pos=light["position"], norm=light["normal"],
             dir=torch.zeros((n, 3), device=dev), weight=light["weight"],
             pdf=light["pdf"],
             is_src=torch.ones((n,), dtype=torch.bool, device=dev),
             is_dir=is_dir, label=light["label"],
             mat=torch.full((n,), -1, dtype=torch.int32, device=dev),
             color=torch.ones((n, 3), device=dev))

    end_ind = path["n_conns"]
    for step in range(cpad - 1):
        ei = torch.clamp(k - 1 - step, min=0)    # eye slot of this split's A
        a_pos = slot("position", ei)
        a_norm = slot("normal", ei)
        a_dirv = slot("dir", ei)
        a_color = slot("color", ei)
        a_mat = slot("mat_id", ei)
        a_pdfw = slot("pdf", ei)
        a_depth = slot("depth", ei)

        do = step < end_ind
        widx = torch.clamp(end_ind - 1 - step, min=0).long()

        peak = a_pdfw * vec.float3weight(b["weight"])
        writes = dict(a_position=a_pos, a_normal=a_norm, a_dir=a_dirv,
                      b_position=b["pos"], b_normal=b["norm"], b_dir=b["dir"],
                      peak_pdf=peak, label_a=a_depth, label_b=b["label"],
                      light_source=b["is_src"], conn_valid=do)
        for name, val in writes.items():
            cur = conn[name]
            old = cur[lanes, widx]
            msk = do if cur.ndim == 2 else do[:, None]
            cur[lanes, widx] = torch.where(msk, val.to(cur.dtype), old)

        # b' = nVertex_device(a, b, eye_side=False) (cuProg.h:1130-1147):
        # sits at a, dir points back to old b, weight/pdf via b.forward_*(a)
        vec_ba = a_pos - b["pos"]
        cdir = torch.where(b["is_dir"][..., None], -b["norm"],
                           vec.normalize(vec_ba))  # b -> a
        dist2 = torch.clamp(vec.dot(vec_ba, vec_ba), min=1e-20)
        g_gen = (torch.abs(vec.dot(cdir, a_norm))
                 * torch.abs(vec.dot(cdir, b["norm"])) / dist2)
        f_b = _eval_at(ts, b["mat"], b["color"], b["norm"], b["dir"], cdir)
        w_general = b["weight"] * f_b * g_gen[..., None]
        w_area = b["weight"] * g_gen[..., None]
        w_dir = b["weight"] * torch.abs(vec.dot(b["norm"], a_norm))[..., None]
        new_weight = torch.where(
            b["is_src"][..., None],
            torch.where(b["is_dir"][..., None], w_dir, w_area), w_general)

        g_pdf = torch.abs(vec.dot(cdir, a_norm)) / dist2
        pdf_area = (b["pdf"] * g_pdf * torch.abs(vec.dot(b["norm"], cdir))
                    / math.pi)
        if ts.has_env:
            pdf_dirl = (b["pdf"] * torch.abs(vec.dot(cdir, a_norm))
                        * env_mod.env_project_pdf(ts.env))
        else:
            pdf_dirl = pdf_area
        d_pdf_b = _pdf_rr(ts, b["mat"], b["color"], b["norm"], b["dir"], cdir)
        pdf_general = b["pdf"] * d_pdf_b * g_pdf
        new_pdf = torch.where(b["is_src"],
                              torch.where(b["is_dir"], pdf_dirl, pdf_area),
                              pdf_general)

        sel3 = lambda nw, od: torch.where(do[..., None], nw, od)
        sel = lambda nw, od: torch.where(do, nw, od)
        no = torch.zeros_like(do)
        b = dict(pos=sel3(a_pos, b["pos"]), norm=sel3(a_norm, b["norm"]),
                 dir=sel3(-cdir, b["dir"]),     # new vertex's dir -> old b
                 weight=sel3(new_weight, b["weight"]),
                 pdf=sel(new_pdf, b["pdf"]),
                 is_src=sel(no, b["is_src"]), is_dir=sel(no, b["is_dir"]),
                 label=sel(torch.zeros_like(b["label"]), b["label"]),
                 mat=sel(a_mat, b["mat"]), color=sel3(a_color, b["color"]))

    return path, conn


def make_pretracer(cam_uvw, n_core: int,
                   padding: int = PRETRACE_CONN_PADDING,
                   max_depth: int | None = None):
    """Returns f(ts, frame) -> PretraceBatch of tensors on the scene's
    device: n_core lanes, up to max_depth (default padding - 1) bounces."""
    if max_depth is None:
        max_depth = padding - 1

    def launch(ts: TraceScene, frame) -> PretraceBatch:
        dev = ts.device
        eye, U, V, W = [torch.as_tensor(np.asarray(x, np.float32), device=dev)
                        for x in cam_uvw]
        lanes = torch.arange(n_core, dtype=torch.int64, device=dev)
        state = rng_mod.seed(lanes, (int(frame) + 0x51000000) & 0xFFFFFFFF)
        r1, state = rng_mod.next_float(state)
        r2, state = rng_mod.next_float(state)
        d = (2.0 * r1 - 1.0)[:, None] * U + (2.0 * r2 - 1.0)[:, None] * V + W
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = eye.expand(d.shape)
        pixel = torch.stack([r1, r2], dim=-1)

        zeros = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,
                                                         device=dev)
        ones = lambda *s: torch.ones(s, device=dev)
        buf = dict(position=zeros(n_core, padding, 3),
                   normal=zeros(n_core, padding, 3),
                   dir=zeros(n_core, padding, 3),
                   color=ones(n_core, padding, 3),
                   flux=ones(n_core, padding, 3),
                   mat_id=zeros(n_core, padding, dt=torch.int32),
                   pdf=ones(n_core, padding),
                   depth=zeros(n_core, padding, dt=torch.int32))
        buf["position"][:, 0] = o
        buf["normal"][:, 0] = d

        # reservoir state: the chosen candidate (split index + light record)
        chosen = dict(k=torch.ones((n_core,), dtype=torch.int32, device=dev),
                      position=zeros(n_core, 3), normal=zeros(n_core, 3),
                      weight=zeros(n_core, 3), pdf=ones(n_core),
                      label=zeros(n_core, dt=torch.int32),
                      is_dir=zeros(n_core, dt=torch.bool))
        k = torch.ones((n_core,), dtype=torch.int32, device=dev)
        flux, pdf = ones(n_core, 3), ones(n_core)
        pending_f, pending_single = ones(n_core, 3), ones(n_core)
        n_resample = zeros(n_core, dt=torch.int32)
        done = zeros(n_core, dt=torch.bool)
        idx = torch.arange(n_core, device=dev)

        def accept(state, n_resample, k, light, cond):
            """Reservoir-accept (rr_acc_accept raygen.cu:741-749): streaming
            1/(n+1) replacement of the lane's chosen candidate (split index
            k + light record); the path info is built once after the loop."""
            r, state = rng_mod.next_float(state)
            take = cond & (1.0 / (n_resample.to(torch.float32) + 1.0) > r)
            for kk, vv in (("k", k),) + tuple(light.items()):
                old = chosen[kk]
                chosen[kk] = torch.where(
                    take.reshape(take.shape + (1,) * (old.ndim - 1)), vv, old)
            return state, n_resample + cond.to(torch.int32)

        for _ in range(max_depth):
            live = ~done
            if not bool(live.any()):
                break
            # dead-lane tmax: see render/pt.py
            hit = trace_closest(ts, o, d, SCENE_EPSILON,
                                torch.where(live, 1e16, -1.0), CULL_BACKFACE)
            geom = local_geometry(ts, hit, o, d)
            hit_light = hit.valid & (geom["light_id"] >= 0) & live
            hit_surf = hit.valid & (geom["light_id"] < 0) & live

            last_norm = buf["normal"][idx, torch.clamp(k - 1, min=0).long()]
            cos_mid = torch.abs(vec.dot(geom["Ns"], d))
            cos_last = torch.abs(vec.dot(last_norm, d))
            inv_t2 = 1.0 / torch.clamp(hit.t * hit.t, min=1e-20)
            pdf_g = cos_mid * cos_last * inv_t2

            first = k == 1
            flux_mid = torch.where(first[..., None], flux * pdf_g[..., None],
                                   pending_f * flux * pdf_g[..., None])
            single = pending_single * pdf_g / torch.clamp(cos_last, min=1e-20)
            pdf_mid = pdf * single

            # --- emitter hit: complete path via ReverseSample
            # (raygen.cu:804-817)
            lid = torch.clamp(geom["light_id"], min=0)
            ls_rev = lights_mod.reverse_sample_quad(ts, lid, geom["uv"])
            light_rec = dict(position=ls_rev.position, normal=ls_rev.normal,
                             weight=ls_rev.emission, pdf=ls_rev.pdf,
                             label=ls_rev.subspace_id,
                             is_dir=zeros(n_core, dt=torch.bool))
            state, n_resample = accept(state, n_resample, k, light_rec,
                                       hit_light & (k >= 2))

            # --- store the surface vertex in the buffer ---
            kcl = torch.clamp(k, max=padding - 1).long()
            for name, val in (("position", geom["P"]), ("normal", geom["Ns"]),
                              ("dir", -d), ("color", geom["base_color"]),
                              ("flux", flux_mid), ("mat_id", geom["mat_id"]),
                              ("pdf", pdf_mid), ("depth", k)):
                cur = buf[name]
                msk = hit_surf if cur.ndim == 2 else hit_surf[:, None]
                cur[idx, kcl] = torch.where(msk, val.to(cur.dtype),
                                            cur[idx, kcl])
            k = k + hit_surf.to(torch.int32)
            flux = torch.where(hit_surf[..., None], flux_mid, flux)
            pdf = torch.where(hit_surf, pdf_mid, pdf)

            # --- NEE + reservoir accept (raygen.cu:823-841) ---
            ls, state = lights_mod.sample_light(ts, state)
            # visibility target: env lights along +direction
            # (cuProg.h:489-501)
            target = torch.where(
                ls.is_env[..., None],
                geom["P"] + ls.direction * 10.0 * ts.env.r, ls.position)
            vis_ok = visibility(ts, geom["P"], target, SCENE_EPSILON,
                                mask=hit_surf)
            # one-sidedness checks (raygen.cu:835-837)
            facing = torch.where(
                ls.is_env, vec.dot(-ls.direction, geom["Ns"]) < 0,
                vec.dot(ls.position - geom["P"], ls.normal) < 0)
            light_rec2 = dict(position=ls.position, normal=ls.normal,
                              weight=ls.emission, pdf=ls.pdf,
                              label=ls.subspace_id, is_dir=ls.is_env)
            state, n_resample = accept(state, n_resample, k, light_rec2,
                                       hit_surf & vis_ok & facing)

            # --- bounce ---
            v_dir = -d
            mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"],
                                      geom["base_color"])
            new_d, state = bsdf_mod.sample_bsdf(mat, geom["Ns"], v_dir, state)
            bpdf = bsdf_mod.pdf_bsdf(mat, geom["Ns"], v_dir, new_d)
            f = bsdf_mod.eval_bsdf(mat, geom["Ns"], v_dir, new_d)
            rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
            r, state = rng_mod.next_float(state)
            cont = hit_surf & (r <= rr) & (bpdf > 0.0) & (k < padding)
            done = done | ~cont
            o = vec.where3(cont, geom["P"], o)
            d = vec.where3(cont, new_d, d)
            pending_f = vec.where3(cont, f, pending_f)
            pending_single = torch.where(cont, bpdf * rr, pending_single)

        # build the chosen candidate's records once (vs per-acceptance in
        # the reference trace loop)
        light_rec = {kk: chosen[kk] for kk in
                     ("position", "normal", "weight", "pdf", "label",
                      "is_dir")}
        path, conn = _build_path_info(ts, buf, chosen["k"], light_rec)

        n_res = torch.clamp(n_resample, min=1)
        sample_pdf = path["sample_pdf"] / n_res.to(torch.float32)
        w = vec.float3weight(path["contri"])
        valid = ((n_resample > 0) & (path["n_conns"] > 0) & (w > 0)
                 & torch.isfinite(sample_pdf) & torch.isfinite(w))
        px = (pixel * 65535).to(torch.int32)
        nc = path["n_conns"].to(torch.int32)
        slot_valid = ((torch.arange(padding, device=dev)[None, :]
                       < nc[:, None]) & valid[:, None])
        return PretraceBatch(
            contri=path["contri"], sample_pdf=sample_pdf,
            fix_pdf=path["fix_pdf"], n_conns=nc, pixel=px, valid=valid,
            a_position=conn["a_position"], a_normal=conn["a_normal"],
            a_dir=conn["a_dir"], b_position=conn["b_position"],
            b_normal=conn["b_normal"], b_dir=conn["b_dir"],
            peak_pdf=conn["peak_pdf"], label_a=conn["label_a"],
            label_b=conn["label_b"], light_source=conn["light_source"],
            conn_valid=conn["conn_valid"] & slot_valid)

    return launch

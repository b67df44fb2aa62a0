"""Light sub-path tracing into the light vertex cache (LVC).

Port of spcbpt_tpu/render/light_trace.py (reference: __raygen__lightTrace
raygen.cu:620-685, __closesthit__lightSubpath hit_program.cu:341-438,
vertex init raygen.cu:173-216): sample a light uniformly, draw a cosine
start direction (env: an origin on the disk projected 10r out, travelling
against the sampled direction), store the origin vertex (is_env from the
sample), then bounce with Disney sampling
under RR, storing at every hit a vertex with the cumulative flux/pdf RATIO,
its subspace label (light classifier) and the light-side recursive-MIS
accumulator updated per rmis.h:22-98.

One lane per light path; the JAX lax.scan over the depth cap is a Python
loop. The per-depth vertex batches are the LVC: a fixed
(max_depth+1, n_paths) SoA with valid flags, no compaction.
"""
from __future__ import annotations

import torch

from ..config import CULL_BACKFACE, MIN_RR_RATE, SCENE_EPSILON
from ..ops import bsdf as bsdf_mod
from ..ops import lights as lights_mod
from ..scene.scene import TraceScene, local_geometry, trace_closest
from ..train import classify
from ..utils import profiling
from ..utils import rng as rng_mod
from ..utils import vec
from . import pool, rmis
from .vertex import LightVertices, map_fields


def _origin_vertices(ts: TraceScene, ls: lights_mod.LightSample, n: int):
    """LVC record for the light-source sample itself
    (init_vertex_from_lightSample raygen.cu:173-196)."""
    dev = ls.position.device
    z = lambda dt=torch.float32: torch.zeros((n,), dtype=dt, device=dev)
    o = lambda dt=torch.float32: torch.ones((n,), dtype=dt, device=dev)
    return LightVertices(
        position=ls.position,
        normal=ls.normal,
        ratio=ls.emission / torch.clamp(ls.pdf, min=1e-30)[..., None],
        color=torch.ones((n, 3), device=dev),
        last_position=torch.zeros((n, 3), device=dev),
        single_pdf=ls.pdf,
        last_normal_proj=o(),
        last_lum=z(),
        rmis=o(),
        mat_id=ls.light_id,
        subspace_id=ls.subspace_id,
        eye_label=z(torch.int32),
        last_zone_id=z(torch.int32),
        depth=z(torch.int32),
        is_origin=o(torch.bool),
        is_env=ls.is_env,
        is_ll_direction=z(torch.bool),
        is_brdf=z(torch.bool),
        last_brdf=z(torch.bool),
        valid=o(torch.bool),
    )


class _Pass(pool.Graphed):
    """A light pass's buffers on the graph route: the frame index, and the
    graph of the pass over it with its output buffers."""

    def __init__(self, dev):
        super().__init__()
        self.frame = torch.zeros((), dtype=torch.int64, device=dev)


# (id(scene), id(state), n_paths, max_depth, seed_salt, device) -> _Pass
_PASSES = pool.Cache()


@profiling.traced("light_trace.paths")
def trace_light_paths(ts: TraceScene, ss: classify.SubspaceState,
                      n_paths: int, frame, max_depth: int = 8,
                      seed_salt: int = 0x9E37) -> LightVertices:
    """Trace n_paths light sub-paths on the scene's device; returns
    LightVertices with shape (max_depth+1, n_paths), slot d holding the
    depth-d vertex of each path, the caller's own: no later call writes
    them. Recorded as span `light_trace.paths`.

    On the pools' graph route (pool.graph_route: a CUDA scene in `brute` or
    `walk` mode) the pass is one CUDA graph of its key, captured at the
    key's first call and replayed with the frame index filled into its
    buffer at each later one; elsewhere the same body runs eagerly."""
    dev = ts.device
    # unsigned 32-bit frame, as the JAX uint32 arithmetic
    frame = int(frame) & 0xFFFFFFFF
    if not pool.graph_route(dev, ts.mode):
        return _trace(ts, ss, n_paths, torch.full(
            (), frame, dtype=torch.int64, device=dev), max_depth, seed_salt)
    p = _PASSES.get((ts, ss), (n_paths, max_depth, seed_salt, dev),
                    lambda: _Pass(dev))
    p.frame.fill_(frame)
    out = p("light_trace", lambda: vars(_trace(
        ts, ss, n_paths, p.frame, max_depth, seed_salt)), dev)
    return LightVertices(**out)


def _trace(ts: TraceScene, ss: classify.SubspaceState, n_paths: int,
           frame, max_depth: int, seed_salt: int) -> LightVertices:
    """The light pass of trace_light_paths; frame: an int64 scalar on the
    scene's device holding the uint32 frame index."""
    dev = ts.device
    lane = torch.arange(n_paths, dtype=torch.int64, device=dev)
    # unsigned 32-bit lane + salt, as the JAX uint32 arithmetic
    state = rng_mod.seed((lane + seed_salt) & 0xFFFFFFFF, frame)

    ls, state = lights_mod.sample_light(ts, state)
    last = _origin_vertices(ts, ls, n_paths)
    d, o, pending_single_pdf, state = lights_mod.trace_mode(ts, ls, state)
    pending_f = torch.ones((n_paths, 3), device=dev)   # bsdf value folded at next hit
    done = torch.zeros((n_paths,), dtype=torch.bool, device=dev)

    per_depth = [last]
    for _ in range(max_depth):
        # dead-lane tmax: paths that are done skip their traversal
        hit = trace_closest(ts, o, d, SCENE_EPSILON,
                            torch.where(done, -1.0, 1e16), CULL_BACKFACE)
        geom = local_geometry(ts, hit, o, d)
        # light sub-paths stop on emitters (hit_program.cu:239-244) and misses
        alive = ~done & hit.valid & (geom["light_id"] < 0)

        n_mid = geom["Ns"]
        cos_mid = torch.abs(vec.dot(n_mid, d))
        cos_last = torch.abs(vec.dot(last.normal, d))
        inv_t2 = 1.0 / torch.clamp(hit.t * hit.t, min=1e-20)
        # directional/env previous vertex: no 1/t^2 (hit_program.cu:372-375)
        pdf_g = torch.where(last.is_env, cos_mid * cos_last,
                            cos_mid * cos_last * inv_t2)

        # ratio update: the pdf_g geometry factor cancels between cumulative
        # flux and pdf: ratio *= f * cos / (bpdf * rr)
        step = (cos_last / torch.clamp(pending_single_pdf, min=1e-30))[..., None]
        ratio = torch.where(last.is_origin[..., None], last.ratio * step,
                            last.ratio * pending_f * step)
        single_pdf = pending_single_pdf * pdf_g / torch.clamp(cos_last,
                                                              min=1e-20)

        last_position = torch.where(last.is_env[..., None], geom["P"] - d,
                                    last.position)
        subspace = classify.label_light(ss, geom["P"], n_mid)
        last_lum = vec.float3weight(last.ratio)

        # light-side RMIS update (rmis.h:22-26, 80-98)
        ll_pdf = rmis.get_last_pdf(ts, last, d)
        weight = rmis.tracing_weight_light(ts, ss, last, geom["P"])
        rmis_init = last.rmis / torch.clamp(last.single_pdf, min=1e-30)
        rmis_upd = ((last.rmis * ll_pdf + weight)
                    / torch.clamp(last.single_pdf, min=1e-30))
        rmis_new = torch.where(last.is_origin, rmis_init, rmis_upd)

        zb = torch.zeros_like(alive)
        mid = LightVertices(
            position=geom["P"], normal=n_mid, ratio=ratio,
            color=geom["base_color"], last_position=last_position,
            single_pdf=single_pdf, last_normal_proj=cos_last,
            last_lum=last_lum, rmis=rmis_new, mat_id=geom["mat_id"],
            subspace_id=subspace,
            eye_label=classify.label_eye(ss, geom["P"], n_mid),
            last_zone_id=last.subspace_id, depth=last.depth + 1,
            is_origin=zb, is_env=zb,
            is_ll_direction=last.is_env & (last.depth == 0),
            is_brdf=zb, last_brdf=last.is_brdf, valid=alive)
        per_depth.append(mid)

        # next bounce: Disney sample + RR (hit_program.cu:354-357, 420-436)
        v_dir = -d
        mat = bsdf_mod.gather_mat(ts.mats, geom["mat_id"], geom["base_color"])
        new_d, state = bsdf_mod.sample_bsdf(mat, n_mid, v_dir, state)
        bpdf = bsdf_mod.pdf_bsdf(mat, n_mid, v_dir, new_d)
        f = bsdf_mod.eval_bsdf(mat, n_mid, v_dir, new_d)
        rr = bsdf_mod.rr_rate(geom["base_color"], MIN_RR_RATE)
        r, state = rng_mod.next_float(state)
        cont = alive & (r <= rr) & (bpdf > 0.0)

        # dead lanes keep their carry; only advancing lanes update
        last = map_fields(
            lambda new, old: torch.where(
                alive.reshape(alive.shape + (1,) * (new.ndim - 1)), new, old),
            mid, last)
        o = vec.where3(cont, geom["P"], o)
        d = vec.where3(cont, new_d, d)
        pending_single_pdf = torch.where(cont, bpdf * rr, pending_single_pdf)
        pending_f = vec.where3(cont, f, pending_f)
        done = done | ~cont
    return map_fields(lambda *xs: torch.stack(xs), *per_depth)

"""Disney principled BRDF: eval / sample / pdf, batched.

The benchmark's plain reference: a frozen copy of
`spcbpt_tpu_torch/ops/bsdf.py` (what the rendered configurations use;
skies, textures and the close-set network left out), importing
nothing of the program. Float tensors take torch's default dtype,
so that the control runs it in bfloat16.

Port of spcbpt_tpu/ops/bsdf.py (reference src/OptiXPathTracer/cuProg.h:
684-899 — Burley's Disney BRDF: diffuse+retro with subsurface lerp, GTR2
specular with Schlick fresnel and smith-GGX shadowing at roughness
(r/2+0.5)^2, GTR1 clearcoat, sheen). Sampling is the reference's
50/50*(1-metallic) cosine-diffuse vs GGX-half-vector mixture, with the draw
order (probability, r1, r2).

The reference's `#ifdef BRDF` pure-specular branches are never compiled
there; ENABLE_PURE_BRDF=True activates the equivalent branches here.

`mat` is a dict of per-lane tensors (base_color (...,3), metallic,
roughness, specular, specular_tint, subsurface, sheen, sheen_tint,
clearcoat, clearcoat_gloss, brdf). V points toward the previous vertex, L
toward the next; both away from the surface.
"""
from __future__ import annotations

import math

import torch

from . import vec
from .rng import next_float

ENABLE_PURE_BRDF = False


def _sqr(x):
    return x * x


def schlick_fresnel(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    return _sqr(_sqr(m)) * m


def gtr1(ndoth, a):
    a = torch.as_tensor(a, dtype=torch.get_default_dtype(),
                        device=ndoth.device)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    out = (a2 - 1.0) / (math.pi * torch.log(a2) * t)
    return torch.where(a >= 1.0, 1.0 / math.pi, out)


def gtr2(ndoth, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (math.pi * t * t)


def smith_g_ggx(ndotv, alpha_g):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / (ndotv + torch.sqrt(torch.clamp(a + b - a * b, min=0.0)))


def gather_mat(mats, mat_id, base_color=None):
    """Slice the Materials SoA at mat_id; optionally override base_color with
    the texture-modulated color. Ids past the table take its last row, as
    JAX clamps an out-of-bounds gather: a light-source vertex stores its
    light id there, and the sky's id is the number of quads."""
    i = torch.clamp(mat_id.long(), max=mats.base_color.shape[0] - 1)
    m = dict(
        base_color=mats.base_color[i],
        metallic=mats.metallic[i],
        roughness=mats.roughness[i],
        specular=mats.specular[i],
        specular_tint=mats.specular_tint[i],
        subsurface=mats.subsurface[i],
        sheen=mats.sheen[i],
        sheen_tint=mats.sheen_tint[i],
        clearcoat=mats.clearcoat[i],
        clearcoat_gloss=mats.clearcoat_gloss[i],
        brdf=mats.brdf[i],
    )
    if base_color is not None:
        m["base_color"] = base_color
    return m


def eval_bsdf(mat, n, v, l):
    """Disney BRDF value (cuProg.h:735-799). Returns (..., 3)."""
    ndotl = vec.dot(n, l)
    ndotv = vec.dot(n, v)
    valid = (ndotl > 0.0) & (ndotv > 0.0)
    # guard values for masked lanes
    ndotl_s = torch.clamp(ndotl, min=1e-6)
    ndotv_s = torch.clamp(ndotv, min=1e-6)

    h = vec.normalize(l + v)
    ndoth = vec.dot(n, h)
    ldoth = vec.dot(l, h)

    cdlin = mat["base_color"]
    cdlum = 0.3 * cdlin[..., 0] + 0.6 * cdlin[..., 1] + 0.1 * cdlin[..., 2]
    ones = torch.ones_like(cdlin)
    ctint = torch.where((cdlum > 0.0)[..., None],
                        cdlin / torch.clamp(cdlum, min=1e-20)[..., None], ones)
    spec0 = (mat["specular"] * 0.08)[..., None] * vec.lerp(
        ones, ctint, mat["specular_tint"][..., None])
    cspec0 = vec.lerp(spec0, cdlin, mat["metallic"][..., None])
    csheen = vec.lerp(ones, ctint, mat["sheen_tint"][..., None])

    fl = schlick_fresnel(ndotl_s)
    fv = schlick_fresnel(ndotv_s)
    one = torch.ones_like(fl)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat["roughness"]
    fd = vec.lerp(one, fd90, fl) * vec.lerp(one, fd90, fv)

    fss90 = ldoth * ldoth * mat["roughness"]
    fss = vec.lerp(one, fss90, fl) * vec.lerp(one, fss90, fv)
    ss = 1.25 * (fss * (1.0 / (ndotl_s + ndotv_s) - 0.5) + 0.5)

    a = torch.clamp(mat["roughness"], min=0.001)
    ds = gtr2(ndoth, a)
    fh = schlick_fresnel(ldoth)
    fs = vec.lerp(cspec0, torch.ones_like(cspec0), fh[..., None])
    roughg = _sqr(mat["roughness"] * 0.5 + 0.5)
    gs = smith_g_ggx(ndotl_s, roughg) * smith_g_ggx(ndotv_s, roughg)

    fsheen = fh[..., None] * mat["sheen"][..., None] * csheen

    dr = gtr1(ndoth, vec.lerp(0.1, 0.001, mat["clearcoat_gloss"]))
    fr = vec.lerp(0.04, 1.0, fh)
    gr = smith_g_ggx(ndotl_s, 0.25) * smith_g_ggx(ndotv_s, 0.25)

    diffuse = ((1.0 / math.pi) * vec.lerp(fd, ss, mat["subsurface"])[..., None]
               * cdlin + fsheen) * (1.0 - mat["metallic"])[..., None]
    specular = (gs * ds)[..., None] * fs
    clear = (0.25 * mat["clearcoat"] * gr * fr * dr)[..., None]
    out = diffuse + specular + clear
    out = torch.where(valid[..., None], out, torch.zeros_like(out))
    if ENABLE_PURE_BRDF:
        out = torch.where(mat["brdf"][..., None], mat["base_color"], out)
    return out


def pdf_bsdf(mat, n, v, l):
    """Sampling pdf of sample_bsdf (cuProg.h:868-899)."""
    spec_alpha = torch.clamp(mat["roughness"], min=0.001)
    cc_alpha = vec.lerp(0.1, 0.001, mat["clearcoat_gloss"])
    diffuse_ratio = 0.5 * (1.0 - mat["metallic"])
    specular_ratio = 1.0 - diffuse_ratio

    h = vec.normalize(l + v)
    cos_theta = torch.abs(vec.dot(h, n))
    pdf_gtr2 = gtr2(cos_theta, spec_alpha) * cos_theta
    pdf_gtr1 = gtr1(cos_theta, cc_alpha) * cos_theta
    ratio = 1.0 / (1.0 + mat["clearcoat"])
    ldoth = torch.abs(vec.dot(l, h))
    pdf_spec = vec.lerp(pdf_gtr1, pdf_gtr2, ratio) / torch.clamp(
        4.0 * ldoth, min=1e-12)
    pdf_diff = torch.abs(vec.dot(l, n)) * (1.0 / math.pi)
    pdf = diffuse_ratio * pdf_diff + specular_ratio * pdf_spec
    if ENABLE_PURE_BRDF:
        pdf = torch.where(mat["brdf"], torch.ones_like(pdf), pdf)
    return pdf


def pdf_bsdf_pair(mat, n, a, b):
    """(pdf_bsdf(mat,n,v=a,l=b), pdf_bsdf(mat,n,v=b,l=a)) sharing the
    specular half-vector term; bit-identical to two pdf_bsdf calls."""
    spec_alpha = torch.clamp(mat["roughness"], min=0.001)
    cc_alpha = vec.lerp(0.1, 0.001, mat["clearcoat_gloss"])
    diffuse_ratio = 0.5 * (1.0 - mat["metallic"])
    specular_ratio = 1.0 - diffuse_ratio

    h = vec.normalize(a + b)
    cos_theta = torch.abs(vec.dot(h, n))
    pdf_gtr2 = gtr2(cos_theta, spec_alpha) * cos_theta
    pdf_gtr1 = gtr1(cos_theta, cc_alpha) * cos_theta
    ratio = 1.0 / (1.0 + mat["clearcoat"])
    pdf_mix = vec.lerp(pdf_gtr1, pdf_gtr2, ratio)
    adoth = torch.abs(vec.dot(a, h))
    bdoth = torch.abs(vec.dot(b, h))
    pdf_ab = (diffuse_ratio * torch.abs(vec.dot(b, n)) * (1.0 / math.pi)
              + specular_ratio * pdf_mix / torch.clamp(4.0 * bdoth, min=1e-12))
    pdf_ba = (diffuse_ratio * torch.abs(vec.dot(a, n)) * (1.0 / math.pi)
              + specular_ratio * pdf_mix / torch.clamp(4.0 * adoth, min=1e-12))
    if ENABLE_PURE_BRDF:
        pdf_ab = torch.where(mat["brdf"], torch.ones_like(pdf_ab), pdf_ab)
        pdf_ba = torch.where(mat["brdf"], torch.ones_like(pdf_ba), pdf_ba)
    return pdf_ab, pdf_ba


def sample_bsdf(mat, n, v, state):
    """Draw an outgoing direction (cuProg.h:826-866): with probability
    0.5*(1-metallic) cosine hemisphere, else GGX half-vector reflection.
    Returns (direction, new rng state)."""
    prob, state = next_float(state)
    r1, state = next_float(state)
    r2, state = next_float(state)
    diffuse_ratio = 0.5 * (1.0 - mat["metallic"])

    d_local = vec.cosine_sample_hemisphere(r1, r2)
    d_diff = vec.onb_transform(n, d_local)

    a = torch.clamp(mat["roughness"], min=0.001)
    phi = r1 * 2.0 * math.pi
    cos_t = torch.sqrt(torch.clamp((1.0 - r2) / (1.0 + (a * a - 1.0) * r2),
                                   0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    half_local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                              cos_t], dim=-1)
    half = vec.onb_transform(n, half_local)
    d_spec = vec.reflect(v, half)

    d = vec.where3(prob < diffuse_ratio, d_diff, d_spec)
    return d, state


def rr_rate(color, rr_min: float = 0.3):
    """Russian-roulette continuation rate: max channel, floored at
    MIN_RR_RATE (hit_program.cu:324-337 with RR_MIN_LIMIT defined)."""
    return torch.clamp(torch.amax(color, dim=-1), rr_min, 1.0)

"""BDPT vertex record (SoA) shared by the light tracer, LVC and SPCBPT.

The benchmark's plain reference: a frozen copy of
`spcbpt_tpu_torch/render/vertex.py` (what the rendered configurations use;
skies, textures and the close-set network left out), importing
nothing of the program. Float tensors take torch's default dtype,
so that the control runs it in bfloat16.

Port of spcbpt_tpu/render/vertex.py: the fields of the reference
BDPTVertex (BDPTVertex.h:9-70) that the connection/RMIS math consumes, as
a dataclass of tensors, plus the packed (V, 32) row layout that lets a
connection draw fetch a whole record with one row gather.
`from_jax_vertices` carries a JAX LightVertices over, array by array.
"""
from __future__ import annotations

import dataclasses

import torch



@dataclasses.dataclass
class LightVertices:
    """A batch of light sub-path vertices; leading axes arbitrary.

    `ratio` is the cumulative flux / cumulative pdf as one unit-invariant
    quantity (the separate products underflow f32 in large-unit scenes;
    every consumer uses only their ratio), and `single_pdf` the per-segment
    pdf that the RMIS recursion consumes."""
    position: torch.Tensor        # (..., 3)
    normal: torch.Tensor          # (..., 3)
    ratio: torch.Tensor           # (..., 3) cumulative flux / cumulative pdf
    color: torch.Tensor           # (..., 3) texture-modulated base color
    last_position: torch.Tensor   # (..., 3)
    single_pdf: torch.Tensor      # (...,) segment pdf for this vertex
    last_normal_proj: torch.Tensor  # (...,) |dot(N_prev, dir)|
    last_lum: torch.Tensor        # (...,) float3sum(prev.ratio)
    rmis: torch.Tensor            # (...,) light-side RMIS_pointer
    mat_id: torch.Tensor          # (...,) int32
    subspace_id: torch.Tensor     # (...,) int32
    eye_label: torch.Tensor       # (...,) int32 eye-tree label at this vertex
    last_zone_id: torch.Tensor    # (...,) int32
    depth: torch.Tensor           # (...,) int32
    is_origin: torch.Tensor       # (...,) bool — on the light source
    is_env: torch.Tensor          # (...,) bool — directional/env
    is_ll_direction: torch.Tensor  # (...,) bool — previous vertex directional
    is_brdf: torch.Tensor         # (...,) bool (dormant, reference parity)
    last_brdf: torch.Tensor       # (...,) bool
    valid: torch.Tensor           # (...,) bool


def map_fields(fn, *objs):
    """A dataclass of tensors with fn applied field by field (the port's
    counterpart of jax.tree_util.tree_map over one record type)."""
    first = objs[0]
    return type(first)(**{f.name: fn(*(getattr(o, f.name) for o in objs))
                          for f in dataclasses.fields(first)})


# Packed-matrix layout: one (V, 32) f32 row per vertex. Ints are stored as
# f32 (all ids < 2^24, exact); bools as 0/1.
_VEC3_FIELDS = ("position", "normal", "ratio", "color", "last_position")
_F32_FIELDS = ("single_pdf", "last_normal_proj", "last_lum", "rmis")
_INT_FIELDS = ("mat_id", "subspace_id", "eye_label", "last_zone_id", "depth")
_BOOL_FIELDS = ("is_origin", "is_env", "is_ll_direction", "is_brdf",
                "last_brdf", "valid")
PACK_WIDTH = 32    # 15 + 4 + 5 + 6 = 30 (+1 optional weight_b)
WEIGHT_B_COL = 30  # precomputed rmis.tracing_weight_light (see pack_matrix)


def pack_matrix(lv: LightVertices, weight_b=None) -> torch.Tensor:
    """Pack a flat (V,) LightVertices into one (V, 32) f32 matrix.

    weight_b (optional, (V,) f32): the vertex's light-side connection
    strategy weight rmis.tracing_weight_light, precomputed once per LVC
    vertex per frame, stored in the otherwise-padded column WEIGHT_B_COL."""
    # the rows hold ids, so they are float32 whatever the computation's
    # precision
    cols = [getattr(lv, f).to(torch.float32) for f in _VEC3_FIELDS]
    cols += [getattr(lv, f).to(torch.float32)[..., None]
             for f in _F32_FIELDS + _INT_FIELDS + _BOOL_FIELDS]
    if weight_b is not None:
        cols += [weight_b.to(torch.float32)[..., None]]
    m = torch.cat(cols, dim=-1)
    return torch.nn.functional.pad(m, (0, PACK_WIDTH - m.shape[-1]))


def unpack_weight_b(rows: torch.Tensor) -> torch.Tensor:
    """The precomputed tracing_weight_light column of gathered packed rows
    (only meaningful when the sampler was built with a SubspaceState —
    LVCSampler.has_weight_b)."""
    return rows[..., WEIGHT_B_COL].to(torch.get_default_dtype())


def unpack_rows(rows: torch.Tensor) -> LightVertices:
    """Inverse of pack_matrix for gathered (N, 32) rows."""
    kw = {}
    o = 0
    fdt = torch.get_default_dtype()
    for f in _VEC3_FIELDS:
        kw[f] = rows[..., o:o + 3].to(fdt)
        o += 3
    for f in _F32_FIELDS:
        kw[f] = rows[..., o].to(fdt)
        o += 1
    for f in _INT_FIELDS:
        kw[f] = rows[..., o].to(torch.int32)
        o += 1
    for f in _BOOL_FIELDS:
        kw[f] = rows[..., o] != 0.0
        o += 1
    return LightVertices(**kw)


def reshape_flat(lv: LightVertices) -> LightVertices:
    """Collapse the batch axes to one flat vertex axis. The batch rank is
    taken from `valid` (a pure-batch field), so feature axes like xyz
    survive regardless of how many batch dims the input has."""
    batch_ndim = lv.valid.ndim
    return map_fields(lambda a: a.reshape((-1,) + a.shape[batch_ndim:]), lv)

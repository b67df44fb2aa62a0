"""LVC processing: per-subspace vertex CMFs + the two-stage sampler.

Port of spcbpt_tpu/render/lvc.py. The reference groups up to 800k vertices
by subspace on the host every frame (MyThrustOp::LVC_Process
device_thrust.cu:241-332); here, as in the JAX package, the grouping is a
device-side stable sort by subspace plus a segmented cumulative sum.

Sampler semantics match SubspaceSampler_device (cuProg.h:266-302): the
first stage picks a light subspace from the eye subspace's Gamma row, the
second a cached vertex of that subspace (weight = float3weight(flux)/pdf,
device_thrust.cu:200-207). The final pmf is path_count * pmf1 * pmf2
(raygen.cu:410-414).

On the card, the two scatter-adds of `build_sampler` are atomic
`index_add_`s and `cumsum` is a parallel scan, so the last bits of
`seg_sum` and `cmf` vary from run to run; the integer tables (`order`,
`seg_start`, `seg_size`, counts) are exact.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import NUM_SUBSPACE
from ..ops.cmf import segment_pmf, segment_searchsorted
from ..train import classify
from ..train import nn_classifier as nn_mod
from ..utils import rng as rng_mod
from ..utils import vec
from .vertex import LightVertices, pack_matrix, reshape_flat


@dataclasses.dataclass
class LVCSampler:
    vertices: LightVertices      # flat (V,) SoA
    order: torch.Tensor          # (V,) int64: sorted-by-subspace vertex index
    cmf: torch.Tensor            # (V,) segment-local cumulative weights
    seg_start: torch.Tensor      # (NUM_SUBSPACE,) int64
    seg_size: torch.Tensor       # (NUM_SUBSPACE,) int64
    seg_sum: torch.Tensor        # (NUM_SUBSPACE,) float32
    vertex_count: torch.Tensor   # () int64 valid vertices
    path_count: torch.Tensor     # () int64 valid light paths
    # packed (V, 32) copy of `vertices` (vertex.pack_matrix)
    packed: torch.Tensor = None
    # per-subspace presampled second-stage tables (presample_tables):
    # table_idx[s, k] = vertex flat index of the k-th presampled draw for
    # subspace s; table_pmf[s, k] = the density that draw was made from
    table_idx: torch.Tensor = None    # (NUM_SUBSPACE, K)
    table_pmf: torch.Tensor = None    # (NUM_SUBSPACE, K) f32
    # fused (idx, pmf) copy; pmf is zeroed on empty subspaces
    table_pack: torch.Tensor = None   # (NUM_SUBSPACE, K, 2) f32
    table_mode: str = None
    # True when `packed` carries the precomputed tracing_weight_light
    # column (vertex.WEIGHT_B_COL)
    has_weight_b: bool = False


def build_sampler(lv: LightVertices, table_mode: str = None,
                  table_k: int = 128, table_seed: int = 0,
                  ss=None) -> LVCSampler:
    """table_mode: presample per-subspace connection tables for this
    second-stage mode ("weighted" | "mixture"; "uniform" needs none). It
    MUST match the SubspaceState's second_stage or the MIS rate calibration
    breaks; renderers only use a table whose mode matches.

    ss (optional SubspaceState): when given, the packed matrix also carries
    each vertex's light-side strategy weight (rmis.tracing_weight_light)."""
    flat = reshape_flat(lv)
    dev = flat.valid.device

    w = vec.float3weight(flat.ratio)
    w = torch.where(torch.isnan(w) | torch.isinf(w), 0.0, w)
    w = torch.where(flat.valid, w, 0.0)

    key = torch.where(flat.valid, flat.subspace_id.long(), NUM_SUBSPACE)
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    sw = w[order]

    csum = torch.cumsum(sw, dim=0)
    ones = flat.valid.to(torch.int64)
    counts = torch.zeros(NUM_SUBSPACE + 1, dtype=torch.int64,
                         device=dev).index_add_(0, key, ones)
    seg_sum = torch.zeros(NUM_SUBSPACE + 1, device=dev).index_add_(0, key, w)
    start = torch.cumsum(counts, dim=0) - counts

    base = torch.where(start > 0, csum[torch.clamp(start - 1, min=0)], 0.0)
    denom = torch.clamp(seg_sum, min=1e-30)
    cmf = (csum - base[skey]) / denom[skey]

    wb = None
    if ss is not None:
        from . import rmis
        wb = rmis.tracing_weight_light(None, ss, flat, None)
    s = LVCSampler(
        vertices=flat, order=order, cmf=cmf,
        seg_start=start[:NUM_SUBSPACE], seg_size=counts[:NUM_SUBSPACE],
        seg_sum=seg_sum[:NUM_SUBSPACE],
        vertex_count=ones.sum(),
        path_count=(flat.valid & (flat.depth == 0)).sum(),
        packed=pack_matrix(flat, weight_b=wb),
        has_weight_b=wb is not None,
    )
    if table_mode in ("weighted", "mixture"):
        idx, pmf = presample_tables(s, table_mode, table_k, table_seed)
        pmf_ok = torch.where((s.seg_size > 0)[:, None], pmf, 0.0)
        pack = torch.stack([idx.to(torch.float32), pmf_ok], dim=-1)
        s = dataclasses.replace(s, table_idx=idx, table_pmf=pmf,
                                table_pack=pack, table_mode=table_mode)
    return s


def table_mode_for(ss) -> str:
    """The presample mode matching a SubspaceState's second stage (None when
    no table helps: untrained states connect uniformly; the 'uniform' second
    stage is already O(1))."""
    if ss is None or not ss.trained:
        return None
    return ss.second_stage if ss.second_stage in ("weighted", "mixture") \
        else None


def make_builder(ss, table_k: int = 128):
    """Per-frame sampler builder whose presampled table mode matches ss —
    the common caller pattern (build(light_trace(frame), frame))."""
    mode = table_mode_for(ss)

    def build(lv, seed=0):
        return build_sampler(lv, table_mode=mode, table_k=table_k,
                             table_seed=seed, ss=ss)
    return build


def presample_tables(s: LVCSampler, mode: str, k: int, seed: int = 0):
    """Draw K i.i.d. second-stage samples per subspace once per frame and
    record the density each was drawn from. Render-time draws pick a uniform
    slot; since every slot is an i.i.d. draw from the mode's density p and
    the estimator divides by the recorded p(v_slot), E[f/p] equals the
    segment sum (same marginal targeting as the per-draw CMF bisection,
    cuProg.h:268-288), shared across the frame's eye vertices."""
    dev = s.cmf.device
    lsub = torch.arange(NUM_SUBSPACE, dtype=torch.int64, device=dev).repeat(k)
    # unsigned 32-bit seed + salt, as the JAX uint32 arithmetic
    state = rng_mod.seed(torch.arange(lsub.shape[0], dtype=torch.int64,
                                      device=dev),
                         (int(seed) + 0x7ab1e) & 0xFFFFFFFF)
    if mode == "mixture":
        idx, pmf, _, _ = sample_second_stage_mixture(s, lsub, state)
    else:
        idx, pmf, _, _ = sample_second_stage(s, lsub, state)
    # (k*S,) -> (S, k)
    return (idx.reshape(k, NUM_SUBSPACE).T.contiguous(),
            pmf.reshape(k, NUM_SUBSPACE).T.contiguous())


def sample_second_stage_table(s: LVCSampler, light_subspace, state):
    """O(1) presampled second stage: uniform slot from the subspace's table
    (presample_tables). Returns (vertex flat-index, pmf, valid, state); with
    the fused pack, empty subspaces are signalled by pmf == 0."""
    r, state = rng_mod.next_float(state)
    k = s.table_idx.shape[1]
    slot = torch.clamp((r * k).to(torch.int64), 0, k - 1)
    row = light_subspace.long()
    if s.table_pack is not None:
        packed = s.table_pack[row, slot]
        pmf = packed[..., 1]
        return packed[..., 0].to(torch.int64), pmf, pmf > 0.0, state
    idx = s.table_idx[row, slot]
    pmf = s.table_pmf[row, slot]
    return idx, pmf, s.seg_size[row] > 0, state


def sample_first_stage(ss: classify.SubspaceState, eye_subspace, state,
                       position=None, normal=None):
    """Pick a light subspace from the eye subspace's Gamma row: O(1) alias
    tables when published (identical distribution to the reference's CMF
    binary search, cuProg.h:290-302), else the CMF bisection. Returns
    (light_subspace, pmf, state).

    When ss.nn is set (the close-set network, train/nn_classifier) and the
    eye vertex is supplied, samples the blended mixture
        (1-b) * Gamma_row + b * nn_close(x)
    and reports its exact pmf. Each draw takes r_sel, r_cl and then the
    row sampler's own draw, in JAX's order."""
    if ss.nn is not None and position is not None:
        row = eye_subspace.long()
        probs, ids = nn_mod.close_probs(ss.nn, row, position, normal)
        r_sel, state = rng_mod.next_float(state)
        r_cl, state = rng_mod.next_float(state)
        # close-set categorical via the row's cumulative sum (K=32 lanes)
        cum = torch.cumsum(probs, dim=-1)
        k = torch.sum(cum < r_cl[..., None] * cum[..., -1:], dim=-1)
        k = torch.clamp(k, 0, probs.shape[-1] - 1)
        l_nn = torch.gather(ids, -1, k[..., None])[..., 0]
        l_row, _, state = sample_first_stage(ss.replace(nn=None),
                                             eye_subspace, state)
        b = ss.nn.blend
        l = torch.where(r_sel < b, l_nn, l_row).to(torch.int32)
        pmf = ((1.0 - b) * classify.gamma_block(ss, row, l)
               + b * nn_mod.close_pmf_of(probs, ids, l))
        return l, pmf, state
    r, state = rng_mod.next_float(state)
    row = eye_subspace.long()
    if ss.alias_pack is not None:
        # fused alias row: [prob, idx, pmf_take, pmf_alias] in one gather
        scaled = r * NUM_SUBSPACE
        j = torch.clamp(scaled.to(torch.int64), 0, NUM_SUBSPACE - 1)
        frac = scaled - j.to(torch.float32)
        packed = ss.alias_pack[row, j]
        take = frac < packed[..., 0]
        l = torch.where(take, j, packed[..., 1].to(torch.int64))
        pmf = torch.where(take, packed[..., 2], packed[..., 3])
        return l.to(torch.int32), pmf, state
    if ss.alias_prob is not None and ss.alias_prob.shape[0] == NUM_SUBSPACE:
        scaled = r * NUM_SUBSPACE
        j = torch.clamp(scaled.to(torch.int64), 0, NUM_SUBSPACE - 1)
        frac = scaled - j.to(torch.float32)
        take = frac < ss.alias_prob[row, j]
        l = torch.where(take, j, ss.alias_idx[row, j].long())
        pmf = classify.gamma_block(ss, row, l)
        return l.to(torch.int32), pmf, state
    flat = ss.cmf_gamma.reshape(-1)
    base = row * NUM_SUBSPACE
    size = torch.full_like(base, NUM_SUBSPACE)
    l = segment_searchsorted(flat, base, size, r, NUM_SUBSPACE)
    pmf = segment_pmf(flat, base, l)
    return l.to(torch.int32), pmf, state


def _segment(s: LVCSampler, light_subspace):
    row = light_subspace.long()
    return s.seg_start[row], s.seg_size[row]


def _order_at(s: LVCSampler, pos):
    return s.order[torch.clamp(pos, 0, s.order.shape[0] - 1)]


def sample_second_stage(s: LVCSampler, light_subspace, state):
    """Pick a cached vertex from the subspace's weight CMF (cuProg.h:268-288).
    Returns (vertex flat-index, pmf, valid, state)."""
    r, state = rng_mod.next_float(state)
    base, size = _segment(s, light_subspace)
    l = segment_searchsorted(s.cmf, base, size, r, int(s.cmf.shape[0]))
    pmf = segment_pmf(s.cmf, base, l)
    return _order_at(s, base + l), pmf, size > 0, state


def sample_uniform(s: LVCSampler, state):
    """Classic-BDPT uniform vertex pick (cuProg.h:279-287 uniformSample).
    Returns (vertex flat-index, pmf, valid, state)."""
    r, state = rng_mod.next_float(state)
    # valid vertices occupy the first vertex_count slots of `order`
    count = s.vertex_count
    j = torch.minimum(torch.clamp((r * count).to(torch.int64), min=0),
                      torch.clamp(count - 1, min=0))
    pmf = 1.0 / torch.clamp(count.to(torch.float32), min=1.0)
    return s.order[j], pmf, count > 0, state


def sample_second_stage_mixture(s: LVCSampler, light_subspace, state):
    """Defensive 50/50 mixture second stage: half the draws pick uniformly
    within the subspace, half by the flux-weighted CMF; the reported pmf is
    the exact mixture density 0.5/n_l + 0.5*w_v/W_l."""
    rsel, state = rng_mod.next_float(state)
    r, state = rng_mod.next_float(state)
    base, size = _segment(s, light_subspace)
    # flux-CMF pick
    l_w = segment_searchsorted(s.cmf, base, size, r, int(s.cmf.shape[0]))
    # uniform pick
    l_u = torch.minimum(
        torch.clamp((r * size.to(torch.float32)).to(torch.int64), min=0),
        torch.clamp(size - 1, min=0))
    l = torch.where(rsel < 0.5, l_u, l_w)
    pmf_w = segment_pmf(s.cmf, base, l)
    pmf_u = 1.0 / torch.clamp(size.to(torch.float32), min=1.0)
    return _order_at(s, base + l), 0.5 * pmf_u + 0.5 * pmf_w, size > 0, state


def sample_second_stage_uniform(s: LVCSampler, light_subspace, state):
    """O(1) second stage: uniform vertex pick within the chosen subspace
    (pmf = 1/segment_size)."""
    r, state = rng_mod.next_float(state)
    base, size = _segment(s, light_subspace)
    l = torch.minimum(
        torch.clamp((r * size.to(torch.float32)).to(torch.int64), min=0),
        torch.clamp(size - 1, min=0))
    pmf = 1.0 / torch.clamp(size.to(torch.float32), min=1.0)
    return _order_at(s, base + l), pmf, size > 0, state

"""The port's LVC (ops/cmf.py, render/lvc.py, render/vertex.py) against the
JAX package: the segmented CMF bisection, build_sampler on the same
light-vertex cache carried across with from_jax_vertices, and every
sampler on the same RNG state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.config import NUM_SUBSPACE
from spcbpt_tpu.ops import cmf as jcmf
from spcbpt_tpu.render import light_trace as jlt
from spcbpt_tpu.render import lvc as jlvc
from spcbpt_tpu.render import vertex as jvertex
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu.train import classify as jcls
from spcbpt_tpu.utils import rng as jrng
from spcbpt_tpu_torch.ops import cmf as tcmf
from spcbpt_tpu_torch.render import lvc as tlvc
from spcbpt_tpu_torch.render import vertex as tvertex
from spcbpt_tpu_torch.train import classify as tcls
from spcbpt_tpu_torch.utils import rng as trng

torch.set_num_threads(1)

N_PATHS = 2048
DEPTH = 8
N_DRAWS = 8192
# Float tables built by sums. The segment CMF is one float32 running sum
# over all ~18k cached vertices (total ~8e5 here, ulp 0.06) minus the sum
# before the segment, over the segment's sum. XLA's cumsum strays up to
# ~0.12 from the exact running total and torch's ~0.03, so over segment
# sums of ~1e3 the CMFs differ by up to ~1.3e-4 (measured): bound 5e-4
# absolute, and twice that for a pmf (a difference of two CMF entries).
# The per-subspace sums are scatter-adds: 1e-6 relative. Integer tables
# are exact.
CMF_ATOL = 5e-4
SUM_RTOL = 1e-6


@pytest.fixture(scope="module")
def lvcs():
    """A JAX light trace of Cornell under the synthetic trained state, its
    JAX samplers, and the port's samplers built from the same vertices."""
    jts, _, _ = jload(default_scene_path())
    jss = jcls.synthetic_trained_state(jts, seed=1)
    jlv = jax.jit(lambda: jlt.trace_light_paths(jts, jss, N_PATHS, 4,
                                                max_depth=DEPTH))()
    tss = tcls.from_jax_state(jss, "cpu")
    tlv = tvertex.from_jax_vertices(jlv, "cpu")
    out = {}
    for mode in ("mixture", "weighted", None):
        js = jlvc.build_sampler(jlv, table_mode=mode, table_k=32,
                                table_seed=9, ss=jss if mode else None)
        ts_ = tlvc.build_sampler(tlv, table_mode=mode, table_k=32,
                                 table_seed=9, ss=tss if mode else None)
        out[mode] = (js, ts_)
    return jss, tss, jlv, tlv, out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _states(n, salt):
    lane = np.arange(n, dtype=np.uint32)
    return (jrng.seed(jnp.asarray(lane), jnp.uint32(salt)),
            trng.seed(torch.from_numpy(lane.astype(np.int64)), salt))


def test_segment_searchsorted_and_pmf_match_jax():
    rng = np.random.default_rng(0)
    sizes = rng.integers(0, 40, 50)
    cmfs = [np.cumsum(w) / max(w.sum(), 1e-30) for w in
            (rng.uniform(0.0, 1.0, s) for s in sizes)]
    flat = np.concatenate(cmfs).astype(np.float32)
    base = (np.cumsum(sizes) - sizes).astype(np.int32)
    seg = rng.integers(0, len(sizes), 5000)
    x = rng.uniform(0, 1, 5000).astype(np.float32)
    b, s = base[seg], sizes[seg].astype(np.int32)
    got = tcmf.segment_searchsorted(torch.from_numpy(flat),
                                    torch.from_numpy(b.astype(np.int64)),
                                    torch.from_numpy(s.astype(np.int64)),
                                    torch.from_numpy(x), 64)
    ref = jcmf.segment_searchsorted(jnp.asarray(flat), jnp.asarray(b),
                                    jnp.asarray(s), jnp.asarray(x), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pmf_t = tcmf.segment_pmf(torch.from_numpy(flat),
                             torch.from_numpy(b.astype(np.int64)), got)
    pmf_j = jcmf.segment_pmf(jnp.asarray(flat), jnp.asarray(b), ref)
    np.testing.assert_array_equal(pmf_t.numpy(), np.asarray(pmf_j))


def test_from_jax_vertices_and_pack_roundtrip(lvcs):
    _, _, jlv, tlv, _ = lvcs
    for f in dataclasses.fields(tlv):
        a, b = getattr(tlv, f.name), np.asarray(getattr(jlv, f.name))
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
    flat = tvertex.reshape_flat(tlv)
    assert flat.valid.shape == ((DEPTH + 1) * N_PATHS,)
    back = tvertex.unpack_rows(tvertex.pack_matrix(flat))
    for f in dataclasses.fields(flat):
        a, b = getattr(back, f.name), getattr(flat, f.name)
        assert a.dtype == b.dtype, f.name
        assert torch.equal(a, b), f.name
    np.testing.assert_array_equal(
        tvertex.pack_matrix(flat).numpy(),
        np.asarray(jvertex.pack_matrix(jvertex.reshape_flat(jlv))))


@pytest.mark.parametrize("mode", ["mixture", "weighted", None])
def test_build_sampler_matches_jax(lvcs, mode):
    js, ts_ = lvcs[4][mode]
    for f in ("order", "seg_start", "seg_size", "vertex_count", "path_count"):
        np.testing.assert_array_equal(_np(getattr(ts_, f)),
                                      _np(getattr(js, f)), err_msg=f)
    assert int(ts_.path_count) == N_PATHS
    np.testing.assert_allclose(ts_.seg_sum.numpy(), _np(js.seg_sum),
                               rtol=SUM_RTOL)
    # the first vertex_count entries are the valid vertices' segments; the
    # rest is the invalid tail (weight 0 over a 1e-30 denominator), which
    # no sampler reads
    nv = int(ts_.vertex_count)
    np.testing.assert_allclose(ts_.cmf.numpy()[:nv], _np(js.cmf)[:nv],
                               rtol=0, atol=CMF_ATOL)
    # packed rows: the vertex columns exactly; the weight_b column (a
    # product the XLA CPU compiler may contract into an FMA) to 1e-6
    pj, pt = _np(js.packed), ts_.packed.numpy()
    np.testing.assert_array_equal(pt[:, :30], pj[:, :30])
    np.testing.assert_allclose(pt[:, 30:], pj[:, 30:], rtol=1e-6)
    assert ts_.has_weight_b == js.has_weight_b == (mode is not None)
    assert ts_.table_mode == js.table_mode == mode
    if mode is None:
        assert ts_.table_idx is None
        return
    # the presampled tables bisect the CMF: a draw may land on a neighbour
    # where the two CMFs differ at a bin edge
    ti, tp = ts_.table_idx.numpy(), ts_.table_pmf.numpy()
    assert ti.shape == (NUM_SUBSPACE, 32)
    assert (ti == np.asarray(js.table_idx)).mean() >= 0.999
    same = ti == np.asarray(js.table_idx)
    np.testing.assert_allclose(tp[same], np.asarray(js.table_pmf)[same],
                               rtol=1e-4, atol=2 * CMF_ATOL)
    np.testing.assert_array_equal(ts_.table_pack.numpy()[..., 0][same],
                                  np.asarray(js.table_pack)[..., 0][same])


def test_table_mode_for_and_make_builder(lvcs):
    jss, tss, _, tlv, _ = lvcs
    for second in ("mixture", "weighted", "uniform"):
        s = tss.replace(second_stage=second)
        assert tlvc.table_mode_for(s) == jlvc.table_mode_for(
            jss.replace(second_stage=second))
    assert tlvc.table_mode_for(None) is None
    assert tlvc.table_mode_for(tcls.untrained_state()) is None
    built = tlvc.make_builder(tss, table_k=8)(tlv, 3)
    assert built.table_mode == tss.second_stage and built.has_weight_b
    assert built.table_idx.shape == (NUM_SUBSPACE, 8)


def _compare_draws(got, ref, min_equal=0.999):
    """(idx, pmf, valid, state) of both packages: states and validity exact,
    indices exact except where the CMFs part at a bin edge, pmfs close."""
    gi, gp, gv, gs = got
    ri, rp, rv, rs = ref
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs).astype(np.int64))
    np.testing.assert_array_equal(np.broadcast_to(gv.numpy(), gi.shape),
                                  np.broadcast_to(np.asarray(rv), gi.shape))
    same = gi.numpy() == np.asarray(ri)
    assert same.mean() >= min_equal
    gp = np.broadcast_to(gp.numpy(), gi.shape)
    rp = np.broadcast_to(np.asarray(rp), gi.shape)
    np.testing.assert_allclose(gp[same], rp[same], rtol=1e-4,
                               atol=2 * CMF_ATOL)


@pytest.mark.parametrize("which", ["second_stage", "mixture", "uniform",
                                   "table", "bdpt_uniform"])
def test_second_stage_samplers_match_jax(lvcs, which):
    mode = {"second_stage": "weighted", "table": "mixture",
            "bdpt_uniform": None}.get(which, "mixture")
    js, ts_ = lvcs[4][mode]
    js_state, ts_state = _states(N_DRAWS, 21)
    lsub = np.random.default_rng(2).integers(0, NUM_SUBSPACE, N_DRAWS)
    jl, tl = jnp.asarray(lsub.astype(np.int32)), torch.from_numpy(lsub)
    if which == "bdpt_uniform":
        got = tlvc.sample_uniform(ts_, ts_state)
        ref = jlvc.sample_uniform(js, js_state)
    else:
        fn = {"second_stage": "sample_second_stage",
              "mixture": "sample_second_stage_mixture",
              "uniform": "sample_second_stage_uniform",
              "table": "sample_second_stage_table"}[which]
        got = getattr(tlvc, fn)(ts_, tl, ts_state)
        ref = getattr(jlvc, fn)(js, jl, js_state)
    _compare_draws(got, ref)
    assert got[2].any()


@pytest.mark.parametrize("path", ["alias_pack", "alias_prob", "cmf"])
def test_first_stage_sampler_matches_jax(lvcs, path):
    """All three first-stage routes on the carried state: the fused alias
    row, the separate alias tables, and the Gamma-CMF bisection."""
    jss, tss, _, _, _ = lvcs
    if path == "alias_prob":
        jss, tss = (s.replace(alias_pack=None) for s in (jss, tss))
    elif path == "cmf":
        jss, tss = (s.replace(alias_pack=None, alias_prob=None)
                    for s in (jss, tss))
    js_state, ts_state = _states(N_DRAWS, 33)
    rows = np.random.default_rng(3).integers(0, NUM_SUBSPACE, N_DRAWS)
    tl, tp, ts2 = tlvc.sample_first_stage(tss, torch.from_numpy(rows),
                                          ts_state)
    jl, jp, js2 = jlvc.sample_first_stage(jss, jnp.asarray(rows, jnp.int32),
                                          js_state)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts2.numpy(),
                                  np.asarray(js2).astype(np.int64))
    assert tl.dtype == torch.int32 and len(np.unique(tl.numpy())) > 500

"""The port's brute-force traversal (ops/brute_trace, the plain version of
kernel K3 on CPU tensors) against the JAX package: the Pallas kernels of
ops/pallas_trace.py in interpret mode and the XLA brute force of
ops/intersect.py, on Cornell, both cull settings, with dead lanes. The
kernel's design (tests/tile_designs.brute_walk: live lanes packed per
block, the float4-padded table, the staged pair test) is held bit for bit
to the plain version and to the Pallas kernels, on Cornell, on hand-made
edge cases and on 512 triangles; the binding's and the wrapper's handling
of tmin/tmax (numbers by value, tensors by a stride of 0 or 1, no copy)."""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spcbpt_tpu.ops import intersect as jintersect
from spcbpt_tpu.render.common import camera_rays as jcamera_rays
from spcbpt_tpu.scene.cornell import default_scene_path
from spcbpt_tpu.scene.scene import load_trace_scene as jload
from spcbpt_tpu_torch.kernels import brute_trace as kernels
from spcbpt_tpu_torch.ops import brute_trace
from spcbpt_tpu_torch.scene import scene as tscene
from spcbpt_tpu_torch.scene.scene import from_jax_scene

import chip_smoke
import tile_designs
from jax_native import native_jax_route  # noqa: F401 (autouse)

torch.set_num_threads(1)

SIDE = 32            # 1024 camera rays
# t, u, v on hit lanes: XLA's CPU compiler contracts the Moller-Trumbore
# multiply-adds into FMAs and torch does not, so they differ in the last
# bits (up to ~5e-6 relative at grazing hits); triangle ids are exact.
RTOL = 1e-5
ATOL = 1e-6
# The random soup of test_brute_design_512_triangles has grazing hits (det
# near 0, thin triangles) where the FMAs move u or v by up to ~7e-5
# relative (one lane in 135 on 509 triangles); ids and flags stay exact.
SOUP_RTOL = 2e-4


@pytest.fixture(scope="module")
def pallas_interpret():
    """ops.pallas_trace reloaded with pallas_call forced to interpret mode
    (as tests/test_pallas.py runs it on the CPU)."""
    from jax.experimental import pallas as pl
    import spcbpt_tpu.ops.pallas_trace as P

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pl.pallas_call = patched
    try:
        importlib.reload(P)
        yield P
    finally:
        pl.pallas_call = orig
        importlib.reload(P)


@pytest.fixture(scope="module")
def rays():
    """Cornell scene in both packages and 1024 camera rays, every fourth
    lane dead (tmax < tmin)."""
    jts, _, cam = jload(default_scene_path())
    cam.aspect = 1.0
    eye, U, V, W = cam.uvw()
    o, d, _ = jcamera_rays(jnp.asarray(eye), jnp.asarray(U), jnp.asarray(V),
                           jnp.asarray(W), SIDE, SIDE, 3)
    n = SIDE * SIDE
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[::4] = -1.0
    return jts, from_jax_scene(jts, "cpu"), np.array(o), np.array(d), \
        tmin, tmax


def _tris_j(jts):
    return jts.tri_p0, jts.tri_e1, jts.tri_e2


def _tris_t(ts):
    return ts.tri_p0, ts.tri_e1, ts.tri_e2


def _port_closest(ts, o, d, tmin, tmax, cull):
    t = torch.from_numpy
    return brute_trace.brute_closest(t(o), t(d), t(tmin), t(tmax),
                                     *_tris_t(ts), cull)


@pytest.mark.parametrize("cull", [True, False])
def test_closest_matches_pallas(pallas_interpret, rays, cull):
    jts, ts, o, d, tmin, tmax = rays
    P = pallas_interpret
    jt, jtri, ju, jv = (np.asarray(a) for a in P.pallas_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
        *_tris_j(jts), cull))
    got = _port_closest(ts, o, d, tmin, tmax, cull)
    tri = got.tri.numpy()
    np.testing.assert_array_equal(tri, jtri)
    hit = tri >= 0
    assert 0.5 < hit.mean() < 0.75         # a quarter dead, some misses
    assert not hit[::4].any()
    for a, b in ((got.t, jt), (got.u, ju), (got.v, jv)):
        np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=RTOL,
                                   atol=ATOL)
    # miss convention: the port keeps t=1e30, u=v=0 (the trace API's);
    # Pallas leaves t=min(tmax, 1e30)
    assert (got.t.numpy()[~hit] == np.float32(1e30)).all()
    assert (got.u.numpy()[~hit] == 0).all() and (got.v.numpy()[~hit] == 0).all()
    np.testing.assert_array_equal(jt[~hit], np.minimum(tmax[~hit], 1e30))


@pytest.mark.parametrize("cull", [True, False])
def test_closest_matches_jax_brute_force(rays, cull):
    jts, ts, o, d, tmin, tmax = rays
    ref = jintersect.brute_force_closest(
        jnp.asarray(o), jnp.asarray(d), *_tris_j(jts), jnp.asarray(tmin),
        jnp.asarray(tmax), cull, chunk=32)
    got = _port_closest(ts, o, d, tmin, tmax, cull)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=RTOL,
                                   atol=ATOL)


def test_any_matches_pallas_and_jax_brute_force(pallas_interpret, rays):
    """Segments ending just short of the closest hit, and at 2x past it:
    occlusion exactly as both JAX versions give it, dead lanes never
    occluded."""
    jts, ts, o, d, tmin, tmax = rays
    ref = _port_closest(ts, o, d, tmin, tmax, False)
    t_hit = np.where(ref.tri.numpy() >= 0, ref.t.numpy(), 10.0)
    lanes = np.arange(len(t_hit))
    seg = np.where(lanes % 2 == 0, 0.99 * t_hit, 2.0 * t_hit)
    seg = np.where(tmax < 0, -1.0, seg).astype(np.float32)
    got = brute_trace.brute_any(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(tmin),
                                torch.from_numpy(seg), *_tris_t(ts)).numpy()
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    pal = np.asarray(pallas_interpret.pallas_any(
        jo, jd, jnp.asarray(tmin), jnp.asarray(seg), *_tris_j(jts)))
    xla = np.asarray(jintersect.brute_force_any(
        jo, jd, *_tris_j(jts), jnp.asarray(tmin), jnp.asarray(seg), chunk=32))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, xla)
    assert not got[tmax < 0].any()
    assert 0.1 < got.mean() < 0.6


def test_scene_brute_mode_routes_through_brute_trace(rays, monkeypatch):
    """trace_closest/trace_any of a brute-mode scene go through
    ops/brute_trace (which launches K3 on CUDA tensors)."""
    _, ts, o, d, tmin, tmax = rays
    assert ts.mode == "brute"
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(brute_trace, name, wrapped)

    spy("brute_closest", brute_trace.brute_closest)
    spy("brute_any", brute_trace.brute_any)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hit = tscene.trace_closest(ts, o, d, 1e-3, torch.from_numpy(tmax), True)
    occ = tscene.trace_any(ts, o, d, 1e-3, 0.5)
    assert calls == ["brute_closest", "brute_any"]
    assert (hit.tri >= 0).any() and occ.dtype == torch.bool


def test_kernel_binding_refuses_what_it_cannot_take(rays):
    """No fallback: the K3 binding raises on CPU tensors and on no or more
    triangles than its shared-memory table holds. Its bounds take a number
    (by value) or a float32 (n,) tensor of stride 0 or 1 on the rays'
    device, read in place, and refuse any other stride, dtype, shape,
    device or type."""
    _, ts, o, d, tmin, tmax = rays
    args = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.closest(*args, *_tris_t(ts), True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.any_hit(*args, *_tris_t(ts))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.any_hit(*args[:2], 1e-3, 1e16, *_tris_t(ts))
    for t_total in (0, kernels.MAX_TRIS + 1):
        tri = torch.zeros((t_total, 3))
        with pytest.raises(ValueError, match="triangles"):
            kernels.closest(*args, tri, tri, tri, True)
        with pytest.raises(ValueError, match="triangles"):
            kernels.any_hit(*args, tri, tri, tri)
    n, cpu = 16, torch.device("cpu")
    x = torch.rand(n)
    assert kernels._bound("tmin", 1e-3, n, cpu) == (None, 0, 1e-3)
    assert kernels._bound("tmin", x, n, cpu) == (x.data_ptr(), 1, 0.0)
    b = torch.tensor([2.0]).expand(n)
    assert kernels._bound("tmax", b, n, cpu) == (b.data_ptr(), 0, 0.0)
    with pytest.raises(ValueError, match="stride 2"):
        kernels._bound("tmax", torch.rand(2 * n)[::2], n, cpu)
    with pytest.raises(TypeError, match="float64"):
        kernels._bound("tmax", torch.rand(n, dtype=torch.float64), n, cpu)
    with pytest.raises(ValueError, match="shape"):
        kernels._bound("tmax", torch.rand(n + 1), n, cpu)
    with pytest.raises(ValueError, match="shape"):
        kernels._bound("tmax", torch.tensor(2.0), n, cpu)
    with pytest.raises(ValueError, match="expected cuda"):
        kernels._bound("tmax", x, n, torch.device("cuda", 0))
    with pytest.raises(TypeError, match="a number or a tensor"):
        kernels._bound("tmax", "1e16", n, cpu)


# ---------------------------------------------------------------------------
# the kernel's design (tests/tile_designs.brute_walk)
# ---------------------------------------------------------------------------

def _segments(ts, o, d, tmin, tmax):
    """Any-hit segments ending just short of the closest hit or at 2x past
    it (10 on a miss), dead lanes dead."""
    ref = _port_closest(ts, o, d, tmin, tmax, False)
    t_hit = np.where(ref.tri.numpy() >= 0, ref.t.numpy(), 10.0)
    lanes = np.arange(len(t_hit))
    seg = np.where(lanes % 2 == 0, 0.99 * t_hit, 2.0 * t_hit)
    return np.where(tmax < 0, -1.0, seg).astype(np.float32)


def _check_design(P, tris, o, d, tmin, tmax, queries, rtol=RTOL):
    """The design against the plain version (torch.equal) and against the
    Pallas kernels in interpret mode (ids and flags exact, t/u/v on hits
    within rtol/ATOL: XLA's CPU FMAs) for each (query, cull) of `queries`;
    returns the design's results by query."""
    tt = [torch.from_numpy(np.asarray(a, np.float32)) for a in tris]
    jt = [jnp.asarray(np.asarray(a, np.float32)) for a in tris]
    args = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    jargs = [jnp.asarray(a) for a in (o, d, tmin, tmax)]
    out = {}
    for query, cull in queries:
        got = tile_designs.brute_walk(o, d, tmin, tmax, *tris, cull, query)
        if query == "any":
            ref = brute_trace.brute_any_plain(*args, *tt)
            assert torch.equal(got, ref)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(P.pallas_any(*jargs, *jt)))
        else:
            ref = brute_trace.brute_closest_plain(*args, *tt, cull)
            for a, f in zip(got, ("t", "tri", "u", "v")):
                assert torch.equal(a, getattr(ref, f)), (query, cull, f)
            jres = [np.asarray(a) for a in P.pallas_closest(*jargs, *jt,
                                                            cull)]
            np.testing.assert_array_equal(got[1].numpy(), jres[1])
            hit = jres[1] >= 0
            for a, b in zip((got[0], got[2], got[3]),
                            (jres[0], jres[2], jres[3])):
                np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=rtol,
                                           atol=ATOL)
        out[(query, cull)] = got
    return out


_ALL = (("closest", True), ("closest", False), ("any", False))


def test_brute_design_matches_plain_and_pallas(pallas_interpret, rays):
    """Cornell camera rays, every fourth lane dead: the design's closest
    (both culls) and any hit equal the plain version and the Pallas
    kernels."""
    jts, ts, o, d, tmin, tmax = rays
    seg = _segments(ts, o, d, tmin, tmax)
    tris = [np.array(a) for a in _tris_j(jts)]
    _check_design(pallas_interpret, tris, o, d, tmin, tmax, _ALL[:2])
    got = _check_design(pallas_interpret, tris, o, d, tmin, seg,
                        (("any", False),))
    assert 0.1 < got[("any", False)].float().mean() < 0.6


_A = ((0, 0, 0), (1, 0, 0), (0, 1, 0))        # p0, e1, e2: det 1 from above
_B = ((1, 1, 0), (-1, 0, 0), (0, -1, 0))      # A's partner across u + v = 1
_DOWN = (0.0, 0.0, -1.0)
_NEXT_EPS = float(np.nextafter(np.float32(1e-10), np.float32(1)))
_F32_EPS = float(np.float32(1e-10))
_HALF_UP = float(np.nextafter(np.float32(0.5), np.float32(1)))


def _tri_at(tri, z=0.0, x=0.0):
    p0, e1, e2 = tri
    return ((p0[0] + x, p0[1], p0[2] + z), e1, e2)


def _det_tri(b, x):
    """A sliver with det = b exactly for a ray straight down."""
    return ((x, 0, 0), (1, 0, 0), (0, b, 0))


# name -> (triangles, rays (origin, direction, tmin, tmax), expected tri
# ids of the closest hit with cull=True and with cull=False)
_EDGE_CASES = {
    # three copies at t = 1 behind one at t = 2: the smallest id wins
    "tie_duplicates": ([_tri_at(_A, -1.0), _A, _A, _A],
                       [((0.25, 0.25, 1), _DOWN, 1e-3, 1e16)], [1], [1]),
    # a closer triangle with a larger id still wins
    "closer_larger_id": ([_A, _tri_at(_A, 0.5)],
                         [((0.25, 0.25, 1), _DOWN, 1e-3, 1e16)], [1], [1]),
    # a ray on the shared edge of two coplanar triangles: both at t = 1
    "shared_edge": ([_B, _A], [((0.5, 0.5, 1), _DOWN, 1e-3, 1e16),
                               ((0.25, 0.75, 1), _DOWN, 1e-3, 1e16)],
                    [0, 0], [0, 0]),
    "shared_edge_swapped": ([_A, _B], [((0.5, 0.5, 1), _DOWN, 1e-3, 1e16)],
                            [0], [0]),
    # through each vertex (u, v in {0, 1}), and just outside one
    "vertices": ([_A], [((0, 0, 1), _DOWN, 1e-3, 1e16),
                        ((1, 0, 1), _DOWN, 1e-3, 1e16),
                        ((0, 1, 1), _DOWN, 1e-3, 1e16),
                        ((-1e-30, 0, 1), _DOWN, 1e-3, 1e16)],
                 [0, 0, 0, -1], [0, 0, 0, -1]),
    # u + v exactly 1; one float past 0.5 in u rounds back to 1 (a tie
    # to even), one float past in both does not
    "u_plus_v_one": ([_A], [((0.5, 0.5, 1), _DOWN, 1e-3, 1e16),
                            ((0.25, 0.75, 1), _DOWN, 1e-3, 1e16),
                            ((0.875, 0.125, 1), _DOWN, 1e-3, 1e16),
                            ((_HALF_UP, 0.5, 1), _DOWN, 1e-3, 1e16),
                            ((_HALF_UP, _HALF_UP, 1), _DOWN, 1e-3, 1e16)],
                     [0, 0, 0, 0, -1], [0, 0, 0, 0, -1]),
    # det at +-1e-10 (rejected: not above) and one float beyond
    "det_at_eps": ([_det_tri(_F32_EPS, 0), _det_tri(_NEXT_EPS, 10),
                    _det_tri(-_F32_EPS, 20), _det_tri(-_NEXT_EPS, 30)],
                   [((0.25, 0.25 * _F32_EPS, 1), _DOWN, 1e-3, 1e16),
                    ((10.25, 0.25 * _NEXT_EPS, 1), _DOWN, 1e-3, 1e16),
                    ((20.25, -0.25 * _F32_EPS, 1), _DOWN, 1e-3, 1e16),
                    ((30.25, -0.25 * _NEXT_EPS, 1), _DOWN, 1e-3, 1e16)],
                   [-1, 1, -1, -1], [-1, 1, -1, 3]),
    # the hit at t = 1 exactly against tmax and tmin at 1 and one float in
    "bounds_at_t": ([_A], [((0.25, 0.25, 1), _DOWN, 1e-3, 1.0),
                           ((0.25, 0.25, 1), _DOWN, 1e-3,
                            float(np.nextafter(np.float32(1), np.float32(2)))),
                           ((0.25, 0.25, 1), _DOWN, 1.0, 2.0),
                           ((0.25, 0.25, 1), _DOWN,
                            float(np.nextafter(np.float32(1), np.float32(0))),
                            2.0)],
                    [-1, 0, -1, 0], [-1, 0, -1, 0]),
    # dead lanes: tmax below tmin, equal to it, NaN bounds
    "dead_lanes": ([_A], [((0.25, 0.25, 1), _DOWN, 1e-3, -1.0),
                          ((0.25, 0.25, 1), _DOWN, 0.5, 0.5),
                          ((0.25, 0.25, 1), _DOWN, 1e-3, math.nan),
                          ((0.25, 0.25, 1), _DOWN, math.nan, 2.0),
                          ((0.25, 0.25, 1), _DOWN, 1e-3, 1e16)],
                   [-1, -1, -1, -1, 0], [-1, -1, -1, -1, 0]),
    # from below: a back face, culled only with cull=True
    "back_face": ([_A], [((0.25, 0.25, -1), (0, 0, 1), 1e-3, 1e16)],
                  [-1], [0]),
}


@pytest.mark.parametrize("case", sorted(_EDGE_CASES))
def test_brute_design_edge_cases(pallas_interpret, case):
    """Hand-made edges: ties on t (duplicates, a shared edge), vertices,
    u + v exactly 1, det at +-1e-10, the hit at tmax and at tmin, dead lanes
    (tmax <= tmin, NaN bounds), a back face. The design equals the plain
    version and the Pallas kernels and gives the expected ids; its any hit
    flags exactly the lanes the closest hit finds."""
    tris, rays, want_cull, want = _EDGE_CASES[case]
    tris = [np.array([t[k] for t in tris], np.float32) for k in range(3)]
    o, d, tmin, tmax = (np.array([r[k] for r in rays], np.float32)
                        for k in range(4))
    got = _check_design(pallas_interpret, tris, o, d, tmin, tmax, _ALL)
    np.testing.assert_array_equal(got[("closest", True)][1].numpy(),
                                  want_cull)
    np.testing.assert_array_equal(got[("closest", False)][1].numpy(), want)
    np.testing.assert_array_equal(got[("any", False)].numpy(),
                                  np.asarray(want) >= 0)


@pytest.mark.parametrize("t_total", [512, 509])
def test_brute_design_512_triangles(pallas_interpret, t_total):
    """The card's largest table (and one that pads to a multiple of 4): a
    seeded soup of triangles in a box against 256 rays from
    inside, a tenth of them dead; closest (both culls) and any hit equal
    the plain version and the Pallas kernels."""
    rs = np.random.RandomState(t_total)
    p0 = rs.uniform(-1, 1, (t_total, 3)).astype(np.float32)
    e1 = rs.uniform(-0.5, 0.5, (t_total, 3)).astype(np.float32)
    e2 = rs.uniform(-0.5, 0.5, (t_total, 3)).astype(np.float32)
    n = 256
    o = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.where(rs.rand(n) < 0.1, -1.0, 1e16).astype(np.float32)
    got = _check_design(pallas_interpret, (p0, e1, e2), o, d, tmin, tmax,
                        _ALL[:2], rtol=SOUP_RTOL)
    assert 0.5 < (got[("closest", False)][1] >= 0).float().mean() < 0.95
    seg = np.where(got[("closest", False)][1].numpy() >= 0,
                   got[("closest", False)][0].numpy(), 3.0)
    seg = np.where(tmax < 0, -1.0, seg * rs.uniform(0.5, 1.5, n))
    _check_design(pallas_interpret, (p0, e1, e2), o, d, tmin,
                  seg.astype(np.float32), (("any", False),))


def test_brute_design_packs_live_lanes_and_counts_stages(rays):
    """The design's block lists: 1024 lanes with every fourth dead fill 6
    warps of each 256-lane block instead of 8. Its stage counts are what
    chip_smoke.pair_census (the K3 phase's bound and shares) counts from
    the plain version's tensors, and the census's operations are those
    counts times each stage's operations, for closest over every live pair
    and for any up to each lane's first occluder."""
    ops = lambda rec: sum(n * rec[k] for k, n in
                          chip_smoke.FLOPS_STAGES.items())
    jts, ts, o, d, tmin, tmax = rays
    tris = [np.array(a) for a in _tris_j(jts)]
    rec = {}
    tile_designs.brute_walk(o, d, tmin, tmax, *tris, False, "closest",
                            rec=rec)
    np.testing.assert_array_equal(rec["live"], [192] * 4)
    assert rec["warps"] == 24
    args = [torch.from_numpy(a) for a in (o, d, tmin, tmax)]
    census = chip_smoke.pair_census(*args, _tris_t(ts), False, chunk=300)
    pairs = census["live"] * 32
    assert rec["tests"] == pairs == 768 * 32
    for k in chip_smoke.FLOPS_STAGES:
        assert rec[k] == round(census[k] * pairs), k
    assert rec["det"] + rec["u"] + rec["v"] + rec["t"] == pairs
    assert census["flops"] == ops(rec) < pairs * chip_smoke.FLOPS_PER_TEST
    seg = _segments(ts, o, d, tmin, tmax)
    rec = {}
    tile_designs.brute_walk(o, d, tmin, seg, *tris, False, "any", rec=rec)
    args[3] = torch.from_numpy(seg)
    census = chip_smoke.pair_census(*args, _tris_t(ts), False, chunk=300)
    assert rec["tests"] == census["any_tests"] < pairs
    assert census["any_flops"] == ops(rec)


def test_ops_bounds_reach_the_kernel_uncopied(monkeypatch):
    """ops/brute_trace hands tmin/tmax to the binding as they come, on
    tensors off the CPU (here the meta device): numbers stay numbers and
    tensors are the caller's objects, whatever their stride or dtype (the
    binding checks them), and the any hit is the binding's result."""
    n = 8
    seen = []

    def spy(name, out):
        def wrapped(o, d, lo, hi, *a):
            seen.append((name, lo, hi))
            return out
        monkeypatch.setattr(kernels, name, wrapped)

    spy("closest", (None,) * 4)
    spy("any_hit", "flags")
    o = torch.empty((n, 3), device="meta")
    tris = [torch.empty((4, 3), device="meta")] * 3
    for lo, hi in ((1e-3, torch.empty(n, device="meta")),
                   (torch.empty(1, device="meta").expand(n), 2.0),
                   (torch.empty(2 * n, device="meta")[::2],
                    torch.empty(n, dtype=torch.float64, device="meta"))):
        seen.clear()
        brute_trace.brute_closest(o, o, lo, hi, *tris, False)
        assert brute_trace.brute_any(o, o, lo, hi, *tris) == "flags"
        assert [(k, a is lo, b is hi) for k, a, b in seen] == \
            [("closest", True, True), ("any_hit", True, True)]


def test_scene_brute_mode_passes_bounds_through(rays, monkeypatch):
    """A brute-mode trace hands its bounds to ops/brute_trace untouched (a
    number stays a number: no host-to-device copy and no fill), and the
    result is the plain version's."""
    _, ts, o, d, tmin, tmax = rays
    seen = []

    def spy(name, fn):
        def wrapped(origins, dirs, lo, hi, *a, **k):
            seen.append((name, lo, hi))
            return fn(origins, dirs, lo, hi, *a, **k)
        monkeypatch.setattr(brute_trace, name, wrapped)

    spy("brute_closest", brute_trace.brute_closest)
    spy("brute_any", brute_trace.brute_any)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hi = torch.from_numpy(tmax)
    hit = tscene.trace_closest(ts, o, d, 1e-3, hi, False)
    occ = tscene.trace_any(ts, o, d, 1e-3, 0.5)
    assert [(n, type(a), b if isinstance(b, float) else b is hi)
            for n, a, b in seen] == [("brute_closest", float, True),
                                     ("brute_any", float, 0.5)]
    ref = brute_trace.brute_closest_plain(
        o, d, torch.full_like(hi, 1e-3), hi, *_tris_t(ts), False)
    assert torch.equal(hit.tri, ref.tri) and torch.equal(hit.t, ref.t)
    assert occ.dtype == torch.bool

"""The port's rng and vec modules against the JAX package on the same inputs.

The rng stream must be bit-identical; vector math agrees to 1e-6."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spcbpt_tpu.utils import rng as jrng
from spcbpt_tpu.utils import vec as jvec
from spcbpt_tpu_torch.utils import rng as trng
from spcbpt_tpu_torch.utils import vec as tvec

# the tensors here are small: one thread per xdist worker avoids
# oversubscribing the cores
torch.set_num_threads(1)

LANES = 4096


@pytest.mark.parametrize("frame", [0, 1, 7, 2 ** 31])
def test_rng_stream_bit_exact(frame):
    lanes = np.arange(LANES, dtype=np.uint32)
    j_tea = np.asarray(jrng.tea(jnp.asarray(lanes), jnp.uint32(frame)))
    t_tea = trng.tea(torch.from_numpy(lanes.astype(np.int64)), frame)
    np.testing.assert_array_equal(t_tea.numpy(), j_tea.astype(np.int64))

    js = jrng.seed(jnp.asarray(lanes), jnp.uint32(frame))
    ts = trng.seed(torch.from_numpy(lanes.astype(np.int64)), frame)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for _ in range(10):
        jx, js = jrng.next_float(js)
        tx, ts = trng.next_float(ts)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(js).astype(np.int64))
    (ja, jb), _ = jrng.next_floats(js, 2)
    (ta, tb), _ = trng.next_floats(ts, 2)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def _vectors(seed, n=512):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    u = rng.uniform(size=(n,)).astype(np.float32)
    return a, b, u


_CASES = {
    "dot": lambda m, a, b, u: m.dot(a, b),
    "cross": lambda m, a, b, u: m.cross(a, b),
    "length": lambda m, a, b, u: m.length(a),
    "normalize": lambda m, a, b, u: m.normalize(a),
    "lerp": lambda m, a, b, u: m.lerp(a, b, u[:, None]),
    "luminance": lambda m, a, b, u: m.luminance(a),
    "float3weight": lambda m, a, b, u: m.float3weight(a),
    "vmax": lambda m, a, b, u: m.vmax(a),
    "onb": lambda m, a, b, u: m.onb(m.normalize(a))[0],
    "onb_transform": lambda m, a, b, u: m.onb_transform(m.normalize(a), b),
    "cosine_sample_hemisphere":
        lambda m, a, b, u: m.cosine_sample_hemisphere(u, 1.0 - u),
    "reflect": lambda m, a, b, u: m.reflect(a, m.normalize(b)),
    "where3": lambda m, a, b, u: m.where3(u > 0.5, a, b),
    "scrub": lambda m, a, b, u: m.scrub(a * 1e5),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_vec_matches_jax(name):
    a, b, u = _vectors(3)
    fn = _CASES[name]
    ref = np.asarray(fn(jvec, jnp.asarray(a), jnp.asarray(b), jnp.asarray(u)))
    got = fn(tvec, torch.from_numpy(a), torch.from_numpy(b),
             torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)

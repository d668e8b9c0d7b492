"""core/ of the port against the JAX package: PCG2D and the seed hash bit
for bit, Vec3 and math3d to 1e-6."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdpathtracing_tpu.core import math3d as jm3
from gdpathtracing_tpu.core import rng as jrng
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.core import vec as jvec

from gdpathtracing_torch.core import math3d as tm3
from gdpathtracing_torch.core import rng as trng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.core import vec as tvec

torch.set_num_threads(1)
N = 100_000
TOL = 1e-6  # f32 elementwise arithmetic in the same order on both sides


def _u32(g, n):
    """Uniform over all of uint32 plus the edge values 0, 2^31-1, 2^31,
    2^32-1."""
    x = g.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    return x


def test_pcg2d_bit_equal():
    g = np.random.default_rng(0)
    sx, sy = _u32(g, N), _u32(g, N)
    assert (sx >= 2 ** 31).mean() > 0.4
    js = (jnp.asarray(sx), jnp.asarray(sy))
    ts = (torch.from_numpy(sx.astype(np.int64)),
          torch.from_numpy(sy.astype(np.int64)))
    for _ in range(3):  # chained draws, as along a path
        (ju, jv), js = jrng.pcg2d(js)
        (tu, tv), ts = trng.pcg2d(ts)
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b.numpy(),
                                          np.asarray(a).astype(np.int64))
        for a, b in ((ju, tu), (jv, tv)):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                          np.asarray(a).view(np.uint32))
        assert (tu.numpy() >= 0).all() and (tu.numpy() <= 1).all()


@pytest.mark.parametrize("frame", [0, 7, 2 ** 31 + 5, 2 ** 32 - 1])
def test_prng_seed_bit_equal(frame):
    g = np.random.default_rng(frame % 1000)
    px, py = _u32(g, N), _u32(g, N)
    jx, jy = jrng.prng_seed(jnp.asarray(px), jnp.asarray(py),
                            jnp.uint32(frame))
    tx, ty = trng.prng_seed(torch.from_numpy(px.astype(np.int64)),
                            torch.from_numpy(py.astype(np.int64)), frame)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx).astype(np.int64))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy).astype(np.int64))


def _vecs(g, n=4096):
    a = g.normal(size=(2, 3, n)).astype(np.float32)
    return ((JVec3(*map(jnp.asarray, a[0])), JVec3(*map(jnp.asarray, a[1]))),
            (Vec3(*map(torch.from_numpy, a[0])),
             Vec3(*map(torch.from_numpy, a[1]))))


def _close(t, j):
    if isinstance(t, Vec3):
        for a, b in zip(t, j):
            _close(a, b)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("op", [
    "add", "sub", "mul", "div", "neg", "dot", "cross", "length",
    "normalize", "normalize_eps", "minmax", "luminance", "reflect", "lerp",
    "where", "scalar"])
def test_vec3_matches_jax(op):
    (ja, jb), (ta, tb) = _vecs(np.random.default_rng(1))
    f = {
        "add": lambda a, b, m: a + b, "sub": lambda a, b, m: a - b,
        "mul": lambda a, b, m: a * b, "div": lambda a, b, m: a / b,
        "neg": lambda a, b, m: -a, "dot": lambda a, b, m: a.dot(b),
        "cross": lambda a, b, m: a.cross(b),
        "length": lambda a, b, m: a.length(),
        "normalize": lambda a, b, m: a.normalize(),
        "normalize_eps": lambda a, b, m: (a * 0.0).normalize(eps=1e-8),
        "minmax": lambda a, b, m: a.minimum(b).max_component()
        + a.maximum(b).min_component(),
        "luminance": lambda a, b, m: a.luminance(),
        "reflect": lambda a, b, m: m.reflect(a, b.normalize()),
        "lerp": lambda a, b, m: m.lerp(a, b, a.x),
        "where": lambda a, b, m: m.where(a.x > 0, a, b),
        "scalar": lambda a, b, m: 2.0 - a * 0.5 + 1.0 / b,
    }[op]
    _close(f(ta, tb, tvec), f(ja, jb, jvec))


def test_math3d_matches_jax():
    g = np.random.default_rng(2)
    m = g.normal(size=(3, 4)).astype(np.float32)
    m4 = g.normal(size=(4, 4)).astype(np.float32)
    p = g.normal(size=(3, 1024)).astype(np.float32)
    jp, tp = JVec3(*map(jnp.asarray, p)), Vec3(*map(torch.from_numpy, p))
    _close(tm3.affine_apply_point(torch.from_numpy(m), tp),
           jm3.affine_apply_point(jnp.asarray(m), jp))
    _close(tm3.affine_apply_dir(torch.from_numpy(m), tp),
           jm3.affine_apply_dir(jnp.asarray(m), jp))
    for a, b in zip(tm3.mat4_apply(torch.from_numpy(m4), tuple(tp) + (tp.x,)),
                    jm3.mat4_apply(jnp.asarray(m4), tuple(jp) + (jp.x,))):
        _close(a, b)
    # Host-side builders are the same NumPy code.
    np.testing.assert_array_equal(tm3.perspective(60, 1.5, 0.1, 100),
                                  jm3.perspective(60, 1.5, 0.1, 100))
    np.testing.assert_array_equal(tm3.look_at((1, 2, 3), (0, 0, 0)),
                                  jm3.look_at((1, 2, 3), (0, 0, 0)))
    np.testing.assert_array_equal(tm3.affine_inverse(m),
                                  jm3.affine_inverse(m))

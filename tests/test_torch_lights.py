"""NEE light sampling of the port (render/lights.py) against the JAX package:
``sample_light`` and ``light_pdf_from_rows`` on the demo scene (970
emitters: JAX's compare-all pick) and the simple Cornell box (2 emitters:
JAX's one-hot pick), from positions and random numbers made with numpy."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render import lights as jl
from gdpathtracing_tpu.scene.demo import (build_cornell_simple as jax_cornell,
                                          build_demo_scene as jax_demo_scene)

from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.render import lights as tl
from gdpathtracing_torch.scene.demo import (build_cornell_simple,
                                            build_demo_scene)

torch.set_num_threads(1)
# wi, dist and pdf_solid: the two frameworks round sqrt, the reciprocal and
# the light table's cumulative sum in their own order (~1 ulp per step).
RTOL = 1e-6
N = 4096


def _scenes(name):
    if name == "demo":
        return (jax_demo_scene(texture_resolution=8, sphere_detail=6),
                build_demo_scene(texture_resolution=8, sphere_detail=6,
                                 device="cpu"))
    return jax_cornell(), build_cornell_simple(device="cpu")


@pytest.fixture(scope="module", params=["demo", "cornell"])
def tables(request):
    js, ts = _scenes(request.param)
    return js, ts, jl.build_light_table(js), tl.build_light_table(ts)


def _inputs(seed=0):
    g = np.random.default_rng(seed)
    pos = g.uniform(-2.5, 2.5, (3, N)).astype(np.float32)
    r = g.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    return pos, r


def test_light_table_matches_jax(tables):
    js, ts, jt, tt = tables
    assert tt.rows.shape == (js.n_lights, 17) == tuple(jt.rows.shape)
    np.testing.assert_allclose(tt.rows.numpy(), np.asarray(jt.rows),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tt.cdf.numpy(), np.asarray(jt.cdf),
                               rtol=RTOL)


def test_sample_light_matches_jax(tables):
    js, ts, jt, tt = tables
    pos, (r_pick, r1, r2) = _inputs()
    ls_j = jl.sample_light(jt, JVec3(*map(jnp.asarray, pos)),
                           jnp.asarray(r_pick), jnp.asarray(r1),
                           jnp.asarray(r2))
    ls_t = tl.sample_light(tt, Vec3(*map(torch.from_numpy, pos)),
                           torch.from_numpy(r_pick), torch.from_numpy(r1),
                           torch.from_numpy(r2))
    # The row JAX picks: clip(#(cdf < r), 0, L-1), on either of its paths.
    n_l = js.n_lights
    cdf_j, cdf_t = np.asarray(jt.cdf), tt.cdf.numpy()
    pick_j = np.clip((cdf_j[None, :] < r_pick[:, None]).sum(1), 0, n_l - 1)
    pick_t = np.clip((cdf_t[None, :] < r_pick[:, None]).sum(1), 0, n_l - 1)
    # The two cumulative sums differ by ~1 ulp per entry (summation order),
    # so an r that falls between them ranks differently: allowed for at
    # most 0.1% of samples, each of which must sit in such a gap.
    flip = pick_j != pick_t
    assert flip.mean() <= 1e-3, flip.sum()
    lo = np.minimum(cdf_j, cdf_t)[np.minimum(pick_j, pick_t)[flip]]
    hi = np.maximum(cdf_j, cdf_t)[np.minimum(pick_j, pick_t)[flip]]
    assert ((r_pick[flip] >= lo) & (r_pick[flip] <= hi)).all()
    same = ~flip
    rows = tt.rows.numpy()[pick_t]
    for k, f in enumerate(("normal", "emission")):
        got = getattr(ls_t, f).to_array().numpy()
        np.testing.assert_array_equal(got, rows[:, 9 + 3 * k:12 + 3 * k])
        np.testing.assert_allclose(
            got[same], np.asarray(getattr(ls_j, f).to_array())[same],
            rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(ls_t.wi.to_array().numpy()[same],
                               np.asarray(ls_j.wi.to_array())[same],
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(ls_t.dist.numpy()[same],
                               np.asarray(ls_j.dist)[same], rtol=RTOL)
    pdf_j = np.asarray(ls_j.pdf_solid)[same]
    pdf_t = ls_t.pdf_solid.numpy()[same]
    np.testing.assert_array_equal(np.isinf(pdf_t), np.isinf(pdf_j))
    fin = np.isfinite(pdf_j)
    assert fin.mean() > 0.9
    np.testing.assert_allclose(pdf_t[fin], pdf_j[fin], rtol=RTOL)


def test_pick_rule_at_ties_and_past_the_end(tables):
    """searchsorted(right=False): r equal to cdf[k] picks k, and an r past
    cdf[-1] picks the last emitter."""
    _, ts, _, tt = tables
    n_l = ts.n_lights
    k = np.arange(n_l)
    r = np.concatenate([tt.cdf.numpy(), np.float32([0.99999994, 0.0])])
    pos = torch.zeros(r.shape[0])
    ls = tl.sample_light(tt, Vec3(pos, pos + 0.5, pos), torch.from_numpy(r),
                         pos + 0.25, pos + 0.5)
    want = np.clip(np.searchsorted(tt.cdf.numpy(), r, side="left"), 0,
                   n_l - 1)
    assert (want[:n_l] <= k).all() and want[n_l] == n_l - 1 and want[-1] == 0
    np.testing.assert_array_equal(ls.emission.to_array().numpy(),
                                  tt.rows.numpy()[want, 12:15])
    np.testing.assert_array_equal(ls.normal.to_array().numpy(),
                                  tt.rows.numpy()[want, 9:12])


def test_light_pdf_from_rows_matches_jax():
    g = np.random.default_rng(1)
    rows = np.zeros((48, N), np.float32)
    # Half emitters (pdf term > 0, unit normals), half not.
    rows[30] = np.where(g.uniform(size=N) < 0.5,
                        g.uniform(0.01, 2.0, N), 0.0)
    nrm = g.normal(size=(3, N))
    rows[31:34] = nrm / np.linalg.norm(nrm, axis=0)
    d = g.normal(size=(3, N))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    t = g.uniform(0.0, 6.0, N).astype(np.float32)
    got = tl.light_pdf_from_rows(torch.from_numpy(rows),
                                 Vec3(*map(torch.from_numpy, d)),
                                 torch.from_numpy(t)).numpy()
    want = np.asarray(jl.light_pdf_from_rows(
        jnp.asarray(rows), JVec3(*map(jnp.asarray, d)), jnp.asarray(t)))
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert (got > 0).mean() > 0.4

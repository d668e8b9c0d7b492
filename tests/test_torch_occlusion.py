"""Kernels 2 (any-hit occlusion) and 4 (closest hit + occlusion in one pass)
of the port, on the CPU through their plain versions, against the JAX
package's ``occluded_pallas`` and ``trace_occlude_pallas`` run in Pallas
interpret mode, on the demo scene.

Two ray sets: shadow rays from the hits of a 32x16 demo camera toward
sampled light points (the NEE queries a frame makes), and the random rays
of tests/test_nee.py ``test_trace_occlude_pallas_unit``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render.types import Ray as JRay
from gdpathtracing_tpu.scene.demo import build_demo_scene as jax_demo_scene

from gdpathtracing_torch.config import Jitter, RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render import lights
from gdpathtracing_torch.render.shading import shading_from_rows
from gdpathtracing_torch.render.types import MISS_T, Ray
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

torch.set_num_threads(1)

# Kernel 1's tolerances (tests/test_torch_intersect.py): t rtol 1e-6 plus
# atol 1e-6 for short hits; at most 0.5% of rays may take the other
# triangle of a shared edge at the same t; u within 1e-5.
T_RTOL, T_ATOL, MAX_EIDX_MISMATCH, UV_ATOL = 1e-6, 1e-6, 0.005, 1e-5
# Occlusion is compared exactly: a shadow ray whose answer hangs on the
# last ulp would have to end within an ulp of a triangle edge or of tlim.
# None does on these rays.


@pytest.fixture(scope="module")
def scenes():
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6)
    ts = build_demo_scene(texture_resolution=8, sphere_detail=6,
                          device="cpu")
    return js, ts, ti.prepare_trace_inputs(ts)


def _light_rays(ts, prep):
    """(o, d, tmax, active) of the shadow rays NEE posts from the hits of
    a 32x16 frame (numpy float32 / bool), and the primary rays (o, d)."""
    cam = demo_camera(32, 16)
    pids = torch.arange(32 * 16)
    ray, _ = cam.generate_rays(pids, rng.prng_seed(pids % 32, pids // 32, 7),
                               RenderConfig(jitter=Jitter.UNIFORM))
    hit = ti.trace_pallas(ts, ray, None, prep)
    s = shading_from_rows(ts, hit, ray)
    r = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(3, 512)).astype(np.float32))
    ls = lights.sample_light(prep.lights, s.position, r[0], r[1], r[2])
    active = hit.hit & (s.normal.dot(ls.wi) > 0.0) & \
        torch.isfinite(ls.pdf_solid)
    o = s.position + s.normal * 1e-3
    sh = (np.stack([c.numpy() for c in o]), np.stack([c.numpy()
                                                       for c in ls.wi]),
          (ls.dist * (1.0 - 1e-3)).numpy(), active.numpy())
    prim = (np.stack([c.numpy() for c in ray.o]),
            np.stack([c.numpy() for c in ray.d]))
    return sh, prim


def _nee_test_rays():
    """The rays of tests/test_nee.py test_trace_occlude_pallas_unit:
    bounce rays (o, d, active) and their shadow set (o, d, tmax, active)."""
    n = 512
    k = jax.random.split(jax.random.PRNGKey(3), 7)
    o = [jax.random.uniform(k[i], (n,), minval=-3.0, maxval=3.0)
         for i in range(3)]
    d_raw = [jax.random.normal(k[3 + i], (n,)) for i in range(3)]
    norm = jnp.sqrt(sum(x * x for x in d_raw)) + 1e-9
    d = [x / norm for x in d_raw]
    active = jax.random.uniform(k[6], (n,)) > 0.3
    sh_o, sh_d = [o[1], o[2], o[0]], [-d[0], d[1], -d[2]]
    sh_active = jax.random.uniform(k[0], (n,)) > 0.5
    npf = lambda xs: np.stack([np.array(x) for x in xs])  # noqa: E731
    return ((npf(o), npf(d), np.array(active)),
            (npf(sh_o), npf(sh_d), np.full(n, 4.0, np.float32),
             np.array(sh_active)))


def _ray_sets(ts, prep):
    """{name: (bounce rays (o, d, active), shadow rays (o, d, tmax,
    active))}."""
    sh, prim = _light_rays(ts, prep)
    return {"light": ((*prim, np.ones(prim[0].shape[1], bool)), sh),
            "random": _nee_test_rays()}


def _jray(o, d):
    return JRay(JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)))


def _tray(o, d):
    return Ray(Vec3(*map(torch.from_numpy, o)),
               Vec3(*map(torch.from_numpy, d)))


def test_sub_bounds_match_jax(scenes):
    js, ts, prep = scenes
    nc = ts.isect_mu.shape[1] // ti.BT
    got = prep.sub_bounds
    assert got.shape == (8, ti.SUB * nc)
    # XLA's einsum and the port's products round the world-space vertices
    # differently by ~1 ulp.
    np.testing.assert_allclose(got.T.reshape(-1).numpy(),
                               np.asarray(jip._sub_bounds(js)), rtol=1e-6,
                               atol=1e-6)
    # Each half lies inside its (inflated) chunk box.
    sub = got.view(8, nc, ti.SUB)
    assert (sub[0:3] >= prep.bounds[0:3, :, None]).all()
    assert (sub[3:6] <= prep.bounds[3:6, :, None]).all()


@pytest.mark.parametrize("rays", ["light", "random"])
def test_occluded_pallas_matches_jax(scenes, rays):
    js, ts, prep = scenes
    _, (o, d, tmax, active) = _ray_sets(ts, prep)[rays]
    got = ti.occluded_pallas(ts, _tray(o, d), torch.from_numpy(tmax),
                             torch.from_numpy(active), prep).numpy()
    want = np.asarray(jip.occluded_pallas(
        js, _jray(o, d), jnp.asarray(tmax), jnp.asarray(active),
        interpret=True))
    np.testing.assert_array_equal(got, want)
    assert not got[~active].any()
    assert 0.05 < got[active].mean() < 0.95  # both answers occur


@pytest.mark.parametrize("rays", ["light", "random"])
def test_trace_occlude_pallas_matches_jax(scenes, rays):
    js, ts, prep = scenes
    (o, d, act), (so, sd, tmax, sact) = _ray_sets(ts, prep)[rays]
    hit_j, occ_j = jip.trace_occlude_pallas(
        js, _jray(o, d), jnp.asarray(act), _jray(so, sd), jnp.asarray(tmax),
        jnp.asarray(sact), interpret=True)
    hit_t, occ_t = ti.trace_occlude_pallas(
        ts, _tray(o, d), torch.from_numpy(act), _tray(so, sd),
        torch.from_numpy(tmax), torch.from_numpy(sact), prep)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    t_j, t_t = np.asarray(hit_j.t), hit_t.t.numpy()
    np.testing.assert_allclose(t_t, t_j, rtol=T_RTOL, atol=T_ATOL)
    same = np.asarray(hit_j.eidx) == hit_t.eidx.numpy()
    assert (~same).mean() <= MAX_EIDX_MISMATCH, (~same).sum()
    assert (t_j[~same] < MISS_T).all()  # a disagreement is a tie of hits
    np.testing.assert_allclose(hit_t.u.numpy()[same],
                               np.asarray(hit_j.u)[same], atol=UV_ATOL)
    assert (t_t < MISS_T).sum() > 50


@pytest.mark.parametrize("rays", ["light", "random"])
def test_fused_equals_separate_launches(scenes, rays):
    """Kernel 4's plain version gives kernel 1's rows 0-46 and kernel 2's
    answer, bit for bit; row 47 counts the shadow sweeps."""
    _, ts, prep = scenes
    (o, d, act), (so, sd, tmax, sact) = _ray_sets(ts, prep)[rays]
    hit_f, occ_f = ti.trace_occlude_pallas(
        ts, _tray(o, d), torch.from_numpy(act), _tray(so, sd),
        torch.from_numpy(tmax), torch.from_numpy(sact), prep)
    hit_s = ti.trace_pallas(ts, _tray(o, d), torch.from_numpy(act), prep)
    occ_s = ti.occluded_pallas(ts, _tray(so, sd), torch.from_numpy(tmax),
                               torch.from_numpy(sact), prep)
    assert torch.equal(hit_f.rows[:47], hit_s.rows[:47])
    assert torch.equal(occ_f, occ_s)
    assert (hit_f.rows[47] > 0).any()


def test_occluded_plain_counts_needed_tests(scenes):
    _, ts, prep = scenes
    sh, _ = _light_rays(ts, prep)
    o4t, d4t, tlim = ti.pack_shadow_rays(_tray(sh[0], sh[1]),
                                         torch.from_numpy(sh[3]),
                                         torch.from_numpy(sh[2]))
    res = ti.occluded_plain(o4t, d4t, tlim, prep.bounds, prep.sub_bounds,
                            prep.mu, prep.mv, prep.mw)
    tests, occ = res.tests.numpy(), res.occ.numpy().astype(bool)
    assert (tests % ti.SW == 0).all()
    assert (tests <= ts.isect_mu.shape[1]).all()
    assert (tests[tlim.numpy() == 0.0] == 0).all()  # parked: nothing
    assert (tests[occ] >= ti.SW).all()
    # Counting stops at the first blocking half, so occluded rays need
    # fewer tests than a full sweep of the chunks they enter.
    assert tests[occ].mean() < ts.isect_mu.shape[1]
    assert (res.sweeps.numpy().reshape(-1, ti.BN)
            == res.sweeps.numpy()[::ti.BN, None]).all()


def _kernel_args(prep, n=256):
    g = np.random.default_rng(5)
    o4 = np.concatenate([g.uniform(-2.5, 2.5, (3, n)),
                         np.ones((1, n))]).astype(np.float32)
    d = g.normal(size=(3, n))
    d4 = np.concatenate([d / np.linalg.norm(d, axis=0),
                         np.zeros((1, n))]).astype(np.float32)
    tlim = np.full(n, 3.0, np.float32)
    o4t, d4t, tlim = map(torch.from_numpy, (o4, d4, tlim))
    common = (prep.bounds, prep.sub_bounds, prep.mu, prep.mv, prep.mw)
    return {"occluded": [o4t, d4t, tlim, *common],
            "closest_hit_rows_nee": [o4t, d4t, d4t.neg(), o4t, tlim, *common,
                                     prep.tab]}


@pytest.mark.parametrize("kernel", ["occluded", "closest_hit_rows_nee"])
@pytest.mark.parametrize("bad", ["dtype", "layout", "shape", "device"])
def test_wrappers_reject_bad_inputs(scenes, kernel, bad):
    args = _kernel_args(scenes[2])[kernel]
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "layout":
        args[3] = args[3].T.contiguous().T
    elif bad == "shape":
        args[-1] = args[-1][:, :512].contiguous()
    else:
        args = [a.to("meta") for a in args]
    with pytest.raises((TypeError, ValueError)):
        getattr(ti, kernel)(*args)


@pytest.mark.parametrize("kernel", ["occluded", "closest_hit_rows_nee"])
def test_cpu_tensors_take_the_plain_version(scenes, kernel):
    args = _kernel_args(scenes[2])[kernel]
    wrapper = getattr(ti, kernel)
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before  # no kernel launched
    plain = getattr(ti, f"{kernel}_plain")(*args)
    if kernel == "occluded":
        assert torch.equal(got, plain.occ)
    else:
        assert all(torch.equal(a, b) for a, b in zip(got, plain))

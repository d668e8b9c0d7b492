"""render/ modules of the port against the JAX package on identical inputs
made with numpy: camera rays, sky, BRDF sampling/evaluation/pdf, shading
from winner rows and the tonemap."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gdpathtracing_tpu.config import Jitter as JJitter
from gdpathtracing_tpu.config import RenderConfig as JRenderConfig
from gdpathtracing_tpu.core import rng as jrng
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.post.tonemap import aces_film as jax_aces
from gdpathtracing_tpu.render import brdf as jbrdf
from gdpathtracing_tpu.render import shading as jshading
from gdpathtracing_tpu.render.sky import sample_sky as jax_sky
from gdpathtracing_tpu.render.types import (HitInfo as JHitInfo,
                                            Ray as JRay,
                                            ShadingInfo as JShadingInfo)
from gdpathtracing_tpu.scene.demo import (build_demo_scene as jax_scene,
                                          demo_camera as jax_camera)

from gdpathtracing_torch.config import Jitter, RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.post.tonemap import aces_film
from gdpathtracing_torch.render import brdf, shading
from gdpathtracing_torch.render.sky import sample_sky
from gdpathtracing_torch.render.types import HitInfo, Ray, ShadingInfo
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

torch.set_num_threads(1)
# Same f32 expressions on both sides; XLA and torch differ by ~1 ulp in
# tan/sin/cos/sqrt-heavy chains and in FMA contraction.
RTOL, ATOL = 1e-5, 1e-6
N = 2048


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, rtol=RTOL, atol=ATOL):
    if isinstance(t, tuple):
        for a, b in zip(t, j):
            _close(a, b, rtol, atol)
        return
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("jitter", ["NONE", "UNIFORM", "GAUSS", "CIRCLE"])
def test_generate_rays_matches_jax(jitter):
    w, h = 40, 24
    pids = np.arange(w * h)
    jseed = jrng.prng_seed(jnp.asarray(pids % w, jnp.uint32),
                           jnp.asarray(pids // w, jnp.uint32), jnp.uint32(5))
    jray, jseed = jax_camera(w, h).generate_rays(
        jnp.asarray(pids, jnp.int32), jseed,
        JRenderConfig(jitter=getattr(JJitter, jitter)))
    tp = torch.from_numpy(pids)
    ray, seed = demo_camera(w, h).generate_rays(
        tp, rng.prng_seed(tp % w, tp // w, 5),
        RenderConfig(jitter=getattr(Jitter, jitter)))
    _close(tuple(ray.o) + tuple(ray.d), tuple(jray.o) + tuple(jray.d))
    for a, b in zip(seed, jseed):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b).astype(np.int64))


def _shading_inputs(seed=0):
    g = np.random.default_rng(seed)

    def unit(n):
        v = g.normal(size=(3, n)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0, keepdims=True)

    nrm, out = unit(N), unit(N)
    out = np.where((nrm * out).sum(0) < 0, -out, out).astype(np.float32)
    f = dict(
        position=g.normal(size=(3, N)), normal=nrm, out_dir=out,
        lambert_out=(nrm * out).sum(0), emission=g.uniform(0, 2, (3, N)),
        diffuse_albedo=g.uniform(0, 1, (3, N)),
        fresnel_0=g.uniform(0.02, 1, (3, N)),
        roughness=g.uniform(0.006, 1, N), transmission=np.zeros(N),
        ior=np.full(N, 1.5), albedo=g.uniform(0, 1, (3, N)))
    f = {k: np.asarray(v, np.float32) for k, v in f.items()}
    r1, r2 = g.uniform(size=(2, N)).astype(np.float32)

    def build(cls, vec, conv):
        return cls(**{k: vec(*map(conv, v)) if v.ndim == 2 else conv(v)
                      for k, v in f.items()})

    return (build(ShadingInfo, Vec3, torch.from_numpy),
            build(JShadingInfo, JVec3, jnp.asarray), r1, r2)


def test_brdf_matches_jax():
    ts, js, r1, r2 = _shading_inputs()
    td = brdf.sample_brdf(ts, torch.from_numpy(r1), torch.from_numpy(r2))
    jd = jbrdf.sample_brdf(js, jnp.asarray(r1), jnp.asarray(r2))
    _close(tuple(td), tuple(jd), rtol=1e-4, atol=1e-5)
    # Evaluate both on the same (JAX-sampled) direction.
    td = Vec3(*(torch.from_numpy(np.array(c)) for c in jd))
    _close(brdf.brdf_pdf(ts, td), jbrdf.brdf_pdf(js, jd), rtol=1e-4)
    _close(tuple(brdf.eval_brdf(ts, td)), tuple(jbrdf.eval_brdf(js, jd)),
           rtol=1e-4)


def test_dielectric_helpers_match_jax():
    ts, js, *_ = _shading_inputs(1)
    cos_i = np.abs(np.asarray(js.lambert_out))
    for eta in (1 / 1.5, 1.5):
        _close(brdf.fresnel_dielectric(torch.from_numpy(cos_i), eta),
               jbrdf.fresnel_dielectric(jnp.asarray(cos_i), eta))
        t, tir = brdf.refract(-ts.out_dir, ts.normal, eta)
        jt, jtir = jbrdf.refract(-js.out_dir, js.normal, eta)
        np.testing.assert_array_equal(tir.numpy(), np.asarray(jtir))
        ok = ~tir.numpy()
        _close(tuple(c[ok] for c in t), tuple(np.asarray(c)[ok] for c in jt))


def test_sky_and_tonemap_match_jax():
    g = np.random.default_rng(3)
    d = g.normal(size=(3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    _close(tuple(sample_sky(Vec3(*map(torch.from_numpy, d)),
                            RenderConfig())),
           tuple(jax_sky(JVec3(*map(jnp.asarray, d)), JRenderConfig())))
    x = g.uniform(0, 8, (16, 16, 3)).astype(np.float32)
    _close(aces_film(torch.from_numpy(x)), jax_aces(jnp.asarray(x)))


def test_shading_from_rows_matches_jax():
    """Same winner rows in, same ShadingInfo out (rows from the demo
    scene's table at random triangles)."""
    from gdpathtracing_tpu.ops.intersect_pallas import build_trace_table
    js = jax_scene(texture_resolution=8, sphere_detail=6)
    ts = build_demo_scene(texture_resolution=8, sphere_detail=6,
                          device="cpu")
    g = np.random.default_rng(4)
    tab = np.asarray(build_trace_table(js))
    e = g.integers(0, 2040, N)
    rows = np.zeros((48, N), np.float32)
    rows[:40] = tab[:, e]
    u, v = g.uniform(0, 0.5, (2, N)).astype(np.float32)
    t = g.uniform(0.1, 5, N).astype(np.float32)
    front = g.uniform(size=N) < 0.5
    o, d = g.normal(size=(2, 3, N)).astype(np.float32)
    jh = JHitInfo(t=jnp.asarray(t), tri=None, inst=None, u=jnp.asarray(u),
                  v=jnp.asarray(v), front=jnp.asarray(front), steps=None,
                  eidx=None, rows=jnp.asarray(rows))
    th = HitInfo(t=torch.from_numpy(t), tri=None, inst=None,
                 u=torch.from_numpy(u), v=torch.from_numpy(v),
                 front=torch.from_numpy(front), steps=None, eidx=None,
                 rows=torch.from_numpy(rows))
    jsi = jshading.shading_from_rows(
        js, jh, JRay(JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d))))
    tsi = shading.shading_from_rows(
        ts, th, Ray(Vec3(*map(torch.from_numpy, o)),
                    Vec3(*map(torch.from_numpy, d))))
    for a, b in zip(tsi, jsi):
        _close(tuple(a) if isinstance(a, Vec3) else a,
               tuple(b) if isinstance(b, JVec3) else b)


def test_texture_sampling_matches_jax():
    g = np.random.default_rng(5)
    tex = g.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    idx = g.integers(-1, 2, N).astype(np.int32)
    u, v = g.uniform(-2, 2, (2, N)).astype(np.float32)
    _close(tuple(shading.sample_texture_array(
               torch.from_numpy(tex), torch.from_numpy(idx),
               torch.from_numpy(u), torch.from_numpy(v))),
           tuple(jshading.sample_texture_array(
               jnp.asarray(tex), jnp.asarray(idx), jnp.asarray(u),
               jnp.asarray(v))))


def test_environment_map_matches_jax():
    from gdpathtracing_tpu.render.sky import sample_environment as jenv
    from gdpathtracing_torch.render.sky import sample_environment
    g = np.random.default_rng(6)
    env = g.uniform(0, 4, (8, 16, 3)).astype(np.float32)
    d = g.normal(size=(3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    _close(tuple(sample_environment(torch.from_numpy(env),
                                    Vec3(*map(torch.from_numpy, d)))),
           tuple(jenv(jnp.asarray(env), JVec3(*map(jnp.asarray, d)))),
           rtol=1e-4, atol=1e-4)

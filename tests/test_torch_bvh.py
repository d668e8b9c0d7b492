"""The BVH traversal of the port (``Traversal.BVH``, the default
``RenderConfig()``'s) against the JAX package, on the CPU (the plain
versions):

- render/traverse.py ``trace_bvh`` (``trace_bvh_plain``) against JAX's
  ``trace_bvh`` on the same numpy-seeded rays: demo camera rays, cosine
  bounce rays from their hits, an ``active`` mask, a stack of 3 that
  overflows, axis-aligned rays on box planes (the unguarded 1/d's NaN in
  the slab test) and a scene moved by scene/dynamic.py;
- render/shading.py's gather path (``fast=False``) on BVH hits;
- ``render_radiance`` with ``RenderConfig()``, 2 bounces, with and without
  NEE, against JAX's; ``render(scene, camera)`` with no config;
- what a BVH render refuses.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gdpathtracing_tpu.config import RenderConfig as JRenderConfig
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render.renderer import (
    render_radiance as jax_render_radiance)
from gdpathtracing_tpu.render.shading import (
    get_shading_data as jax_get_shading_data)
from gdpathtracing_tpu.render.traverse import trace_bvh as jax_trace_bvh
from gdpathtracing_tpu.render.types import HitInfo as JHitInfo, Ray as JRay
from gdpathtracing_tpu.scene.demo import (build_demo_scene as jax_demo_scene,
                                          demo_camera as jax_demo_camera)
from gdpathtracing_tpu.scene.dynamic import (
    update_instance_transforms as jax_update_instance_transforms)

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import tiles as kt
from gdpathtracing_torch.post.tonemap import aces_film
from gdpathtracing_torch.render.renderer import render, render_radiance
from gdpathtracing_torch.render.shading import get_shading_data
from gdpathtracing_torch.render.traverse import trace_bvh, trace_bvh_plain
from gdpathtracing_torch.render.types import MISS_T, HitInfo, Ray
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera
from gdpathtracing_torch.scene.dynamic import update_instance_transforms

torch.set_num_threads(1)
# t: both sides sum in the same order, but XLA's CPU code may fuse or
# reorder a product where torch rounds each op (measured: t bit-equal on
# 99% of the demo's camera rays, at most 2.9e-6 apart).
T_RTOL, T_ATOL = 1e-6, 5e-6
# u, v carry t's error times the barycentric gradient (measured: 7.3e-6).
UV_ATOL = 5e-5
# tri, inst, steps equal on this share of the rays: a 1-ulp t can flip
# which of two triangles sharing an edge a grazing ray hits first.
MIN_EQUAL = 0.999
# Renders: the tolerance of tests/test_golden.py on this share of pixels
# (paths are chaotic: a 1-ulp difference between XLA's and torch's tan,
# sin and cos can send a pixel's path elsewhere; ROADMAP §3).
IMG_TOL, MIN_PIXELS_OK = 2e-3, 0.99
W, H = 32, 24
_jax_trace = jax.jit(jax_trace_bvh, static_argnames=("max_stack",))


@pytest.fixture(scope="module")
def scenes():
    return (jax_demo_scene(texture_resolution=8, sphere_detail=6),
            build_demo_scene(texture_resolution=8, sphere_detail=6,
                             device="cpu"))


def _port_ray(o, d) -> Ray:
    return Ray(Vec3(*map(torch.from_numpy, o)), Vec3(*map(torch.from_numpy,
                                                          d)))


def _jax_ray(o, d) -> JRay:
    return JRay(JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)))


def _camera_rays():
    """(3, n) o and d of the demo camera's W x H pixels (frame 1)."""
    pids = torch.arange(W * H)
    ray, _ = demo_camera(W, H).generate_rays(
        pids, rng.prng_seed(pids % W, pids // W, 1), RenderConfig())
    return ray.o.to_array(0).numpy(), ray.d.to_array(0).numpy()


def _bounce_rays(ts, o, d, g):
    """Cosine-distributed rays about the geometric normal (turned toward
    the camera) at the camera rays' hits, 1e-3 off the surface; random
    rays from inside the room where a camera ray missed."""
    hit = trace_bvh_plain(ts, _port_ray(o, d))
    t, tri, inst = (x.numpy() for x in (hit.t, hit.tri, hit.inst))
    p = o + d * np.where(t < MISS_T, t, 0.0)
    tf = ts.inst_transform.numpy()[inst]           # (n, 3, 4)
    v = ts.tri_pos.numpy()[tri]                    # (n, 3, 3) object
    wv = np.einsum("nij,nkj->nki", tf[:, :, :3], v) + tf[:, None, :, 3]
    nrm = np.cross(wv[:, 1] - wv[:, 0], wv[:, 2] - wv[:, 0]).T
    nrm /= np.linalg.norm(nrm, axis=0)
    nrm *= -np.sign((nrm * d).sum(axis=0))
    a = np.where(np.abs(nrm[0]) > 0.9, 0.0, 1.0)
    tan = np.cross(nrm.T, np.stack([a, 1.0 - a, 0.0 * a], axis=1)).T
    tan /= np.linalg.norm(tan, axis=0)
    bit = np.cross(nrm.T, tan.T).T
    r1, r2 = g.uniform(size=(2, t.size))
    phi, r = 2.0 * np.pi * r1, np.sqrt(r2)
    dirs = tan * r * np.cos(phi) + bit * r * np.sin(phi) \
        + nrm * np.sqrt(1.0 - r2)
    rand = g.normal(size=(3, t.size))
    rand /= np.linalg.norm(rand, axis=0)
    miss = t >= MISS_T
    o2 = np.where(miss, g.uniform(-2.5, 2.5, (3, t.size)), p + 1e-3 * nrm)
    d2 = np.where(miss, rand, dirs)
    return o2.astype(np.float32), d2.astype(np.float32)


def _case(kind, scenes):
    """(JAX scene, port scene, o, d, active or None, max_stack,
    max_iters) of a ray set, from a numpy seed."""
    js, ts = scenes
    o, d = _camera_rays()
    g = np.random.default_rng({"camera": 1, "bounce": 2, "active": 3,
                               "overflow": 4, "axis": 5, "moved": 6}[kind])
    active, max_stack, max_iters = None, 64, 1 << 20
    if kind == "bounce":
        o, d = _bounce_rays(ts, o, d, g)
    elif kind == "active":
        active = g.uniform(size=o.shape[1]) > 0.3
    elif kind == "overflow":
        # 3 entries overflow on the demo: the pops past the stack re-read
        # its top, so some rays cycle until the cap.
        max_stack, max_iters = 3, 512
    elif kind == "axis":
        ray = kt.axis_aligned_rays(ts, 512, seed=5)
        o, d = ray.o.to_array(0).numpy(), ray.d.to_array(0).numpy()
    elif kind == "moved":
        # As JAX's tests/test_dynamic.py: move one sphere, shrink another.
        tfs = ts.inst_transform.numpy().copy()
        tfs[2, :, 3] += [0.5, 0.3, -0.4]
        tfs[3, :, :3] *= 0.8
        js = jax_update_instance_transforms(js, jnp.asarray(tfs))
        ts = update_instance_transforms(ts, torch.from_numpy(tfs))
    return js, ts, o, d, active, max_stack, max_iters


@pytest.mark.parametrize("kind", ["camera", "bounce", "active", "overflow",
                                  "axis", "moved"])
def test_plain_matches_jax(scenes, kind):
    js, ts, o, d, active, max_stack, max_iters = _case(kind, scenes)
    before = trace_bvh.launches
    th = trace_bvh(ts, _port_ray(o, d),
                   None if active is None else torch.from_numpy(active),
                   max_stack=max_stack, max_iters=max_iters)
    assert trace_bvh.launches == before  # the plain version
    jh = _jax_trace(js, _jax_ray(o, d),
                    None if active is None else jnp.asarray(active),
                    max_stack=max_stack, max_iters=max_iters)
    n = o.shape[1]
    hit = np.asarray(jh.t) < MISS_T
    assert n // 10 < hit.sum() < n, kind
    same = np.ones(n, bool)
    for f in ("tri", "inst", "steps"):
        same &= getattr(th, f).numpy() == np.asarray(getattr(jh, f))
    assert same.mean() >= MIN_EQUAL, (kind, (~same).sum())
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=T_RTOL, atol=T_ATOL)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(th, f).numpy()[same & hit],
                                   np.asarray(getattr(jh, f))[same & hit],
                                   atol=UV_ATOL)
    np.testing.assert_array_equal(th.front.numpy()[same & hit],
                                  np.asarray(jh.front)[same & hit])
    assert th.rows is None and (th.eidx == -1).all()
    assert th.t.dtype == torch.float32
    assert th.tri.dtype == th.inst.dtype == th.steps.dtype == torch.int32
    if active is not None:
        assert (th.t.numpy()[~active] == MISS_T).all()
        assert (th.steps.numpy()[~active] == 0).all()
    if kind == "overflow":  # the cap binds on some rays, as in JAX
        full = trace_bvh_plain(ts, _port_ray(o, d))
        assert (th.steps != full.steps).any()


def test_gather_shading_matches_jax(scenes):
    """render/shading.py's gather path (material through the instance's
    table, the object-space normal transformed and flipped by front,
    textures) on JAX's BVH hits of the camera rays."""
    js, ts = scenes
    o, d = _camera_rays()
    jh = _jax_trace(js, _jax_ray(o, d))
    th = HitInfo(*(torch.from_numpy(np.array(x)) for x in jh[:8]))
    ts_ = get_shading_data(ts, th, _port_ray(o, d), fast=False)
    js_ = jax_get_shading_data(js, JHitInfo(*jh[:8]), _jax_ray(o, d))
    hit = np.asarray(jh.t) < MISS_T
    assert hit.sum() > 100
    for f in ("position", "normal", "out_dir", "emission", "diffuse_albedo",
              "fresnel_0", "albedo"):
        np.testing.assert_allclose(
            getattr(ts_, f).to_array().numpy()[hit],
            np.asarray(getattr(js_, f).to_array())[hit], rtol=1e-5,
            atol=1e-6, err_msg=f)
    for f in ("lambert_out", "roughness", "transmission", "ior"):
        np.testing.assert_allclose(getattr(ts_, f).numpy()[hit],
                                   np.asarray(getattr(js_, f))[hit],
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("nee", [False, True], ids=["primal", "nee"])
def test_render_matches_jax(scenes, nee):
    """``RenderConfig()`` (BVH, the standard loop), 2 bounces, 16x16, frame
    1, against JAX's: radiance within rtol = atol = 2e-3 on >= 99% of
    pixels, segments and steps equal on those pixels."""
    js, ts = scenes
    ref = jax_render_radiance(js, jax_demo_camera(16, 16),
                              JRenderConfig(bounces=2, nee=nee), 1)
    before = trace_bvh.launches
    got = render_radiance(ts, demo_camera(16, 16),
                          RenderConfig(bounces=2, nee=nee), 1)
    assert trace_bvh.launches == before
    ok = np.isclose(got.radiance.numpy(), np.asarray(ref.radiance),
                    rtol=IMG_TOL, atol=IMG_TOL).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()
    for f in ("segments", "steps"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[ok],
                                      np.asarray(getattr(ref, f))[ok])
    np.testing.assert_allclose(got.depth.numpy()[ok],
                               np.asarray(ref.depth)[ok], rtol=1e-5)
    # NEE posts shadow queries (more segments than pixels' bounces alone).
    assert got.segments.numpy().sum() > (16 * 16 * (1.2 if nee else 1.0))


def test_default_render_on_cpu(scenes):
    """``render(scene, camera)`` with no config: BVH through the standard
    loop, tonemapped, on the CPU."""
    _, ts = scenes
    cam = demo_camera(16, 16)
    img = render(ts, cam)
    assert img.shape == (16, 16, 3) and img.device.type == "cpu"
    assert bool(torch.isfinite(img).all())
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
    assert float(img.mean()) > 0.05
    lin = render_radiance(ts, cam, RenderConfig()).radiance
    assert torch.equal(img, aces_film(lin))


@pytest.mark.parametrize("change, error, match", [
    (dict(differentiable=True), ValueError, "BVH traversal has no gradient"),
    (dict(rr_start=2), None, None),
    (dict(regen=True), ValueError, "regen"),
], ids=["differentiable", "rr", "regen"])
def test_bvh_refuses(scenes, change, error, match):
    """What a BVH render refuses; Russian roulette, which it refused until
    item 3 came in, renders: finite, on the scene's device, and equal to
    JAX's frame at 16x16, 5 bounces."""
    js, ts = scenes
    if error is not None:
        with pytest.raises(error, match=match):
            render_radiance(ts, demo_camera(8, 8), RenderConfig(**change))
        return
    got = render_radiance(ts, demo_camera(16, 16),
                          RenderConfig(bounces=5, **change), 1)
    assert got.radiance.device == ts.device
    assert bool(torch.isfinite(got.radiance).all())
    ref = jax_render_radiance(js, jax_demo_camera(16, 16),
                              JRenderConfig(bounces=5, **change), 1)
    ok = np.isclose(got.radiance.numpy(), np.asarray(ref.radiance),
                    rtol=IMG_TOL, atol=IMG_TOL).all(axis=-1)
    assert ok.mean() >= MIN_PIXELS_OK, (~ok).sum()
    np.testing.assert_array_equal(got.segments.numpy()[ok],
                                  np.asarray(ref.segments)[ok])


def test_trace_bvh_checks(scenes):
    """The wrapper raises on a device that is neither CUDA nor CPU (it
    never falls back to the plain version there), on a scene elsewhere
    than the rays, and on a stack of no entries."""
    _, ts = scenes
    o, d = _camera_rays()
    ray = _port_ray(o, d)
    meta = Ray(Vec3(*(x.to("meta") for x in ray.o)),
               Vec3(*(x.to("meta") for x in ray.d)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        trace_bvh(ts.to("meta"), meta)
    with pytest.raises(ValueError, match="scene is on cpu"):
        trace_bvh(ts, meta)
    with pytest.raises(ValueError, match="max_stack"):
        trace_bvh(ts, ray, max_stack=0)

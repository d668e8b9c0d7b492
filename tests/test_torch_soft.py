"""Kernel 5 of the port (ops/intersect.py soft_occluded, the top-1 blocker
of a soft shadow ray) and the soft relaxations of the differentiable path
(soft shadows, soft primary silhouettes) against the JAX package, whose
Pallas kernel runs in interpret mode.

Inputs are made with numpy from fixed seeds (or are JAX's own camera rays)
and handed to both frameworks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdpathtracing_tpu.ops.intersect_pallas as jip
from gdpathtracing_tpu.config import (Jitter as JJitter,
                                      RenderConfig as JRenderConfig,
                                      Traversal as JTraversal)
from gdpathtracing_tpu.core import rng as jrng
from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render.camera import Camera as JCamera
from gdpathtracing_tpu.render.integrator import path_trace as jax_path_trace
from gdpathtracing_tpu.render.types import Ray as JRay
from gdpathtracing_tpu.scene.demo import build_demo_scene as jax_demo_scene
from gdpathtracing_tpu.scene.dynamic import (
    update_instance_transforms as jax_update_instance_transforms)
from gdpathtracing_tpu.scene.materials import Material as JMaterial
from gdpathtracing_tpu.scene.primitives import plane_mesh as jax_plane_mesh
from gdpathtracing_tpu.scene.scene import SceneBuilder as JSceneBuilder

from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.render.integrator import path_trace, sample_direct
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.shading import get_shading_data
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera
from gdpathtracing_torch.scene.dynamic import update_instance_transforms
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.primitives import plane_mesh
from gdpathtracing_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)
EDGE_EPS = 0.05
# Margins against JAX: JAX's kernel takes u, v and w from a K=4 matmul,
# which sums in another order, so they agree to ulps, not bits: atol 1e-6
# in the soft band (|margin| <= 1), and rtol 1e-6 beyond it, where a ray
# passes tens of edge lengths outside a silhouette (coverage 0).
MARGIN_RTOL = MARGIN_ATOL = 1e-6
# eidx: only where two candidates' margins are within those ulps may the
# winner differ, on at most 0.5% of rays.
MAX_EIDX_FLIPS = 0.005
# Gradients of the slice: the same estimator on the same rays, up to the
# rounding of two frameworks; compared on components above 1% of the
# largest.
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _interpret():
    old = jip._FORCE_INTERPRET
    jip._FORCE_INTERPRET = True
    yield
    jip._FORCE_INTERPRET = old


@pytest.fixture(scope="module")
def demo():
    js = jax_demo_scene(texture_resolution=8, sphere_detail=6)
    ts = build_demo_scene(texture_resolution=8, sphere_detail=6,
                          device="cpu")
    return js, ts


def _eo(ts):
    return ts.tri_edge_open[ts.isect_tri.long()].T.contiguous()


def _jax_soft(js, o4, d4, tmax, bounds, eo):
    eo4 = jnp.concatenate([jnp.asarray(eo), jnp.zeros((1, eo.shape[1]),
                                                      jnp.float32)])
    m, e = jip._soft_occlusion(
        jnp.asarray(o4), jnp.asarray(d4), jnp.asarray(tmax),
        jnp.asarray(bounds),
        jip._m3_layout(js.isect_mu, js.isect_mv, js.isect_mw), eo4,
        interpret=True)
    return np.asarray(m), np.asarray(e)


def _random_rays(n, seed):
    """test_nee.py-style shadow rays: origins in the room, random unit
    directions, limits in (0, 6), a quarter of them parked (limit 0)."""
    g = np.random.default_rng(seed)
    o = g.uniform(-2.5, 2.5, (3, n)).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tmax = g.uniform(0.0, 6.0, n).astype(np.float32)
    tmax[g.uniform(size=n) < 0.25] = 0.0
    return (np.concatenate([o, np.ones((1, n), np.float32)]),
            np.concatenate([d, np.zeros((1, n), np.float32)]), tmax)


def _demo_shadow_rays(ts, w=32, h=16):
    """NEE shadow rays of the demo: primary hits of a w×h camera toward
    sampled light points, packed for the kernel."""
    cfg = RenderConfig(traversal=Traversal.PALLAS, jitter=Jitter.UNIFORM)
    pids = torch.arange(w * h)
    ray, seed = demo_camera(w, h).generate_rays(
        pids, rng.prng_seed(pids % w, pids // w, 3), cfg)
    prep = ti.prepare_trace_inputs(ts)
    hit = ti.trace_pallas(ts, ray, None, prep)
    s = get_shading_data(ts, hit, ray)
    dl, _ = sample_direct(s, s.position * 0.0 + 1.0, hit.hit, seed,
                          prep.lights, cfg)
    return dl


def _compare(mj, ej, mp, ep):
    np.testing.assert_allclose(mp, mj, rtol=MARGIN_RTOL, atol=MARGIN_ATOL)
    flip = ej != ep
    assert flip.mean() <= MAX_EIDX_FLIPS, flip.sum()
    # A flip is a near-tie: both winners' margins within the ulps above.
    assert np.allclose(mp[flip], mj[flip], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rays", ["demo_nee", "random"])
def test_soft_occluded_plain_matches_jax(demo, rays):
    js, ts = demo
    if rays == "random":
        o4, d4, tmax = _random_rays(1024, 0)
    else:
        dl = _demo_shadow_rays(ts)
        o4t, d4t, tl = ti.pack_shadow_rays(dl.shadow, dl.active, dl.tmax)
        o4, d4, tmax = o4t.numpy(), d4t.numpy(), tl.numpy()
    bounds = ti.soft_bounds(ts.isect_chunk_bounds, EDGE_EPS)
    eo = _eo(ts)
    got = ti.soft_occluded_plain(*(torch.from_numpy(x) for x in
                                   (o4, d4, tmax)), bounds, ts.isect_mu,
                                 ts.isect_mv, ts.isect_mw, eo)
    mj, ej = _jax_soft(js, o4, d4, tmax, bounds.numpy(), eo.numpy())
    mp, ep = got.margin.numpy(), got.eidx.numpy()
    _compare(mj, ej, mp, ep)
    found = mp > -1e8
    assert found.sum() > 10 and (~found).sum() > 10  # both answers occur
    assert (ep[~found] == 0).all() and (mp[~found] == -1e9).all()
    assert (mp[tmax <= 0.0] == -1e9).all()  # parked rays find nothing
    # Tests needed: 256 per chunk the ray's own soft slab test passed.
    assert (got.tests % ti.BT == 0).all()
    assert (got.tests[torch.from_numpy(found)] >= ti.BT).all()


def test_soft_bounds_match_jax(demo):
    js, ts = demo
    cb = js.isect_chunk_bounds
    diag = jnp.sqrt(jnp.maximum(((cb[3:6] - cb[0:3]) ** 2).sum(axis=0),
                                0.0))
    infl = (EDGE_EPS * diag)[None, :]
    want = jnp.concatenate([cb[0:3] - infl, cb[3:6] + infl, cb[6:8]], 0)
    np.testing.assert_allclose(ti.soft_bounds(ts.isect_chunk_bounds,
                                              EDGE_EPS).numpy(),
                               np.asarray(want), rtol=1e-6, atol=0)


def test_all_closed_ties_take_the_lowest_eidx(demo):
    """Interior crossings of triangles whose edges are all closed score
    exactly 1.0, so ties are common: the winner must be the lowest eidx
    among the candidates of the largest margin, as a brute-force (N, E)
    evaluation over every triangle finds it."""
    _, ts = demo
    o4, d4, tmax = _random_rays(512, 5)
    tmax[:] = 8.0  # long queries cross several walls
    bounds = ti.soft_bounds(ts.isect_chunk_bounds, EDGE_EPS)
    eo = _eo(ts)
    o4t, d4t, tm = (torch.from_numpy(x) for x in (o4, d4, tmax))
    got = ti.soft_occluded_plain(o4t, d4t, tm, bounds, ts.isect_mu,
                                 ts.isect_mv, ts.isect_mw, eo)
    # Brute force, every triangle of every chunk the ray's gate passes.
    e = ts.isect_mu.shape[1]
    u, v, t, _, wd_ok = ti._uvt(slice(0, e), ts.isect_mu, ts.isect_mv,
                                ts.isect_mw, o4t.unbind(0), d4t.unbind(0))
    m = ti._soft_margins(u, v, t, wd_ok, tm, eo)
    rd = tuple(ti._rcp(x) for x in d4t[:3])
    gate = torch.stack([
        (lambda tmin, tmx: (tmx >= tmin) & (tmx > 0) & (tmin < tm))(
            *ti._slab(bounds[:, c], *o4t[:3], *rd))
        for c in range(e // ti.BT)], dim=1).repeat_interleave(ti.BT, dim=1)
    m = torch.where(gate, m, -1e9)
    best = m.amax(dim=1)
    lowest = torch.where(m == best[:, None], torch.arange(e), e).amin(dim=1)
    found = best > -1e8
    assert torch.equal(got.margin, best)
    assert torch.equal(got.eidx[found], lowest[found].to(torch.int32))
    ties = ((m == 1.0).sum(dim=1) >= 2) & (best == 1.0)
    assert int(ties.sum()) >= 20, int(ties.sum())  # the rule is exercised


def _args(ts, n=256):
    o4, d4, tmax = _random_rays(n, 1)
    return [torch.from_numpy(o4), torch.from_numpy(d4),
            torch.from_numpy(tmax),
            ti.soft_bounds(ts.isect_chunk_bounds, EDGE_EPS), ts.isect_mu,
            ts.isect_mv, ts.isect_mw, _eo(ts)]


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape", "eo_shape",
                                 "ragged", "device", "requires_grad"])
def test_soft_occluded_rejects_bad_inputs(demo, bad):
    args = _args(demo[1])
    if bad == "dtype":
        args[2] = args[2].double()
    elif bad == "layout":
        args[7] = args[7].T.contiguous().T
    elif bad == "shape":
        args[3] = args[3][:, :4].contiguous()
    elif bad == "eo_shape":
        args[7] = torch.cat([args[7], args[7][:1]])
    elif bad == "ragged":
        args[0], args[1], args[2] = (args[0][:, :200].contiguous(),
                                     args[1][:, :200].contiguous(),
                                     args[2][:200].contiguous())
    elif bad == "device":
        args = [a.to("meta") for a in args]
    else:
        args[4] = args[4].clone().requires_grad_(True)
    with pytest.raises((TypeError, ValueError)):
        ti.soft_occluded(*args)


def test_cpu_tensors_take_the_plain_version(demo):
    args = _args(demo[1])
    before = ti.soft_occluded.launches
    margin, eidx = ti.soft_occluded(*args)
    assert ti.soft_occluded.launches == before
    want = ti.soft_occluded_plain(*args)
    assert torch.equal(margin, want.margin) and torch.equal(eidx, want.eidx)
    assert eidx.dtype == torch.int32


def test_soft_occluded_pallas_and_vjp_match_jax(demo):
    """Visibility of the demo's NEE shadow rays through the wrappers, and
    the VJP of sum(w · vis) with respect to isect_cols and the rays'
    origins and directions, against jax.vjp: rtol 1e-4 (the sigmoid's
    slope, 1/edge_eps, scales the ulps of the margin) on components above
    1e-3 of the largest, absolute 1e-6 of the largest below."""
    js, ts = demo
    dl = _demo_shadow_rays(ts)
    n = dl.tmax.shape[0]
    w = np.random.default_rng(7).uniform(size=n).astype(np.float32)
    act = dl.active.numpy()
    o = np.stack([x.numpy() for x in dl.shadow.o])
    d = np.stack([x.numpy() for x in dl.shadow.d])

    def jf(cols, o, d):
        s = dataclasses.replace(js, isect_cols=cols)
        vis = jip.soft_occluded_pallas(
            s, JRay(JVec3(*o), JVec3(*d)), jnp.asarray(dl.tmax.numpy()),
            jnp.asarray(act), edge_eps=EDGE_EPS, interpret=True)
        return jnp.sum(vis * w), vis

    (_, vis_j), vjp = jax.vjp(lambda *a: jf(*a), js.isect_cols,
                              jnp.asarray(o), jnp.asarray(d))
    gj = vjp((jnp.float32(1.0), jnp.zeros(n, jnp.float32)))

    cols = ts.isect_cols.clone().requires_grad_(True)
    ot = torch.from_numpy(o).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    s = dataclasses.replace(ts, isect_cols=cols)
    vis = ti.soft_occluded_pallas(s, Ray(Vec3(*ot), Vec3(*dt)),
                                  dl.tmax, dl.active, EDGE_EPS)
    gp = torch.autograd.grad((vis * torch.from_numpy(w)).sum(),
                             (cols, ot, dt))
    np.testing.assert_allclose(vis.detach().numpy(), np.asarray(vis_j),
                               rtol=0, atol=1e-5)
    soft = (vis.detach() > 1e-4) & (vis.detach() < 1 - 1e-4)
    assert int(soft.sum()) > 0 and float(vis.detach().min()) < 0.5
    for a, b in zip(gp, gj):
        a, b = a.numpy(), np.asarray(b)
        big = np.abs(b) > 1e-3 * np.abs(b).max()
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a[big], b[big], rtol=1e-4)
        np.testing.assert_allclose(a[~big], b[~big], rtol=0,
                                   atol=1e-6 * np.abs(b).max())


# ---- the slice: path_trace on JAX's own rays --------------------------

def _affine(rows, origin):
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = np.asarray(rows, np.float32).reshape(3, 3)
    m[:, 3] = origin
    return m


def _shadow_scene(builder, material, plane, device=None):
    """tests/test_silhouette.py's scene: a floor, an area light and a
    blocker between them."""
    b = builder()
    floor = b.add_mesh(plane(size=8.0))
    light = b.add_mesh(plane(size=2.0))
    blocker = b.add_mesh(plane(size=1.2))
    b.add_instance(floor, _affine([1, 0, 0, 0, 1, 0, 0, 0, 1], (0, 0, 0)),
                   materials=[material(albedo=(0.8, 0.8, 0.8),
                                       roughness=0.8)])
    b.add_instance(light, _affine([1, 0, 0, 0, -1, 0, 0, 0, -1], (0, 4, 0)),
                   materials=[material(emission=(1, 1, 1),
                                       emission_energy=10.0)])
    b.add_instance(blocker, _affine([1, 0, 0, 0, 1, 0, 0, 0, 1], (0, 2, 0)),
                   materials=[material(albedo=(0.2, 0.2, 0.2),
                                       roughness=0.8)])
    return b.build() if device is None else b.build(device=device)


def _primary_scene(builder, material, plane, device=None):
    """tests/test_silhouette.py's emissive card floating in the sky."""
    b = builder()
    card = b.add_mesh(plane(size=1.5))
    b.add_instance(card, _affine([1, 0, 0, 0, 0, -1, 0, 1, 0], (0, 1, 0)),
                   materials=[material(albedo=(1, 1, 1),
                                       emission=(2.0, 0.5, 0.2),
                                       emission_energy=2.0)])
    return b.build() if device is None else b.build(device=device)


SHADOW_EYE, PRIMARY_EYE = ((0.0, 3.0, 5.0), (0.0, 0.0, 0.0), 50.0), \
    ((0.0, 1.0, 4.0), (0.0, 1.0, 0.0), 45.0)


@pytest.fixture(scope="module")
def shadow_scenes():
    return (_shadow_scene(JSceneBuilder, JMaterial, jax_plane_mesh),
            _shadow_scene(SceneBuilder, Material, plane_mesh, "cpu"))


@pytest.fixture(scope="module")
def primary_scenes():
    return (_primary_scene(JSceneBuilder, JMaterial, jax_plane_mesh),
            _primary_scene(SceneBuilder, Material, plane_mesh, "cpu"))


def _slice_grads(scenes, eye, cfg_kw, inst, tx):
    """Gradient of sum(w · radiance) over the agreeing pixels with respect
    to the instance transforms, through update_instance_transforms and
    path_trace on JAX's 32×32 camera rays, in both frameworks."""
    js, ts = scenes
    size = 32
    cam = JCamera.looking_at(eye[0], eye[1], fov_deg=eye[2], width=size,
                             height=size)
    jcfg = JRenderConfig(traversal=JTraversal.PALLAS, jitter=JJitter.NONE,
                         differentiable=True, regen=False, **cfg_kw)
    pids = jnp.arange(size * size, dtype=jnp.int32)
    seed = jrng.prng_seed((pids % size).astype(jnp.uint32),
                          (pids // size).astype(jnp.uint32), jnp.uint32(1))
    ray, seed = cam.generate_rays(pids, seed, jcfg)
    delta = np.zeros(np.asarray(js.inst_transform).shape, np.float32)
    delta[inst, 0, 3] = tx
    tf0 = np.asarray(js.inst_transform) + delta

    def jrad(tf):
        r = jax_path_trace(jax_update_instance_transforms(js, tf), ray,
                           seed, jcfg).radiance
        return jnp.stack([r.x, r.y, r.z])

    tray = Ray(Vec3(*(torch.from_numpy(np.array(x)) for x in ray.o)),
               Vec3(*(torch.from_numpy(np.array(x)) for x in ray.d)))
    tseed = tuple(torch.from_numpy(np.asarray(x).astype(np.int64))
                  for x in seed)
    tcfg = RenderConfig(traversal=Traversal.PALLAS, jitter=Jitter.NONE,
                        differentiable=True, regen=False, **cfg_kw)
    tf = torch.from_numpy(tf0).requires_grad_(True)
    r = path_trace(update_instance_transforms(ts, tf), tray, tseed,
                   tcfg).radiance
    rad_p = torch.stack([r.x, r.y, r.z])
    rad_j = np.asarray(jrad(jnp.asarray(tf0)))
    ok = (np.abs(rad_p.detach().numpy() - rad_j) <= 1e-5).all(axis=0)
    assert ok.mean() >= 0.99, (~ok).sum()
    w = np.random.default_rng(3).uniform(size=rad_j.shape).astype(
        np.float32) * ok
    gj = np.asarray(jax.grad(lambda t: jnp.sum(jrad(t) * w))(
        jnp.asarray(tf0)))
    (gp,) = torch.autograd.grad((rad_p * torch.from_numpy(w)).sum(), tf)
    return gp.numpy(), gj


def _assert_grads_close(gp, gj):
    assert np.isfinite(gp).all() and np.abs(gj).max() > 0
    big = np.abs(gj) > 0.01 * np.abs(gj).max()
    np.testing.assert_allclose(gp[big], gj[big], rtol=GRAD_RTOL)


def test_slice_soft_shadow_transform_grad_matches_jax(shadow_scenes):
    """Instance-transform gradient with NEE and soft shadows (kernel 5, no
    fusion), blocker moved off centre. One bounce, as test_silhouette.py
    renders it: with a second, bounce rays escape to the sky, and the
    reference's geometry gradient is NaN there (see the next test)."""
    gp, gj = _slice_grads(shadow_scenes, SHADOW_EYE,
                          dict(bounces=1, nee=True, soft_shadows=EDGE_EPS),
                          inst=2, tx=0.1)
    _assert_grads_close(gp, gj)
    assert np.abs(gp[2]).max() > 0  # the blocker's pose moves the shadow


@pytest.mark.parametrize("soft", [0.0, EDGE_EPS], ids=["hard", "soft"])
def test_nee_geometry_gradient_is_finite_where_lanes_miss(shadow_scenes,
                                                          soft):
    """Two bounces with NEE: bounce rays escape to the sky. On such a lane
    the reference's light pdf squared overflows to inf, inf/inf is NaN in a
    branch its where() discards, and the backward pass multiplies that NaN
    by a zero cotangent: its transform gradient is NaN. The port sanitises
    the pdf on every lane that posts no shadow query, which changes no
    radiance: the image is the primal render's."""
    ts = shadow_scenes[1]
    cam = Camera.looking_at(*SHADOW_EYE[:2], fov_deg=SHADOW_EYE[2],
                            width=16, height=16)
    cfg = RenderConfig(traversal=Traversal.PALLAS, jitter=Jitter.NONE,
                       regen=False, bounces=2, nee=True, soft_shadows=soft)
    tf = ts.inst_transform.clone().requires_grad_(True)
    got = render_radiance(update_instance_transforms(ts, tf), cam,
                          cfg.replace(differentiable=True), 0)
    (g,) = torch.autograd.grad(got.radiance.sum(), tf)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert bool((got.depth >= 999.0).any() | (got.segments < 3).any())
    want = render_radiance(update_instance_transforms(ts, tf.detach()), cam,
                           cfg, 0)
    np.testing.assert_allclose(got.radiance.detach().numpy(),
                               want.radiance.numpy(), rtol=1e-5, atol=1e-6)


def test_slice_soft_primary_transform_grad_matches_jax(primary_scenes):
    gp, gj = _slice_grads(primary_scenes, PRIMARY_EYE,
                          dict(bounces=2, soft_primary=EDGE_EPS),
                          inst=0, tx=0.1)
    _assert_grads_close(gp, gj)
    assert abs(gp[0, 0, 3]) > 0  # the card's x translation


# ---- renders: the FD checks of tests/test_silhouette.py, PALLAS --------

def _render_moved(scene, cam, inst, tx, cfg):
    base = scene.inst_transform
    delta = torch.zeros_like(base)
    delta[inst, 0, 3] = 1.0
    s = update_instance_transforms(scene, base + delta * tx)
    return render_radiance(s, cam, cfg, 0).radiance


def _fd_check(scene, cam, inst, cfg, target_tx, h):
    """jax.grad and central differences of the MSE against the frame at
    ``target_tx``, at tx = 0: both negative (moving toward the target
    lowers the loss) and within 50% (test_silhouette.py's tolerance: the
    relaxation is smooth only on its band)."""
    with torch.no_grad():
        target = _render_moved(scene, cam, inst, torch.tensor(target_tx),
                               cfg)

    def loss(tx):
        return torch.mean((_render_moved(scene, cam, inst, tx, cfg)
                           - target) ** 2)

    tx = torch.tensor(0.0, requires_grad=True)
    (g,) = torch.autograd.grad(loss(tx), tx)
    g = float(g)
    with torch.no_grad():
        fd = (float(loss(torch.tensor(h))) - float(loss(torch.tensor(-h)))) \
            / (2 * h)
    assert g < 0.0, g
    assert fd < 0.0, fd
    assert abs(g - fd) / abs(fd) < 0.5, (g, fd)


def test_soft_shadow_gradient_matches_fd(shadow_scenes):
    cam = Camera.looking_at(*SHADOW_EYE[:2], fov_deg=SHADOW_EYE[2],
                            width=32, height=32)
    cfg = RenderConfig(bounces=1, spp=2, nee=True, jitter=Jitter.NONE,
                       traversal=Traversal.PALLAS, soft_shadows=EDGE_EPS,
                       differentiable=True)
    _fd_check(shadow_scenes[1], cam, 2, cfg, 0.4, 0.05)


def test_soft_primary_gradient_matches_fd(primary_scenes):
    cam = Camera.looking_at(*PRIMARY_EYE[:2], fov_deg=PRIMARY_EYE[2],
                            width=32, height=32)
    cfg = RenderConfig(bounces=1, spp=1, jitter=Jitter.NONE,
                       traversal=Traversal.PALLAS, soft_primary=EDGE_EPS,
                       differentiable=True)
    _fd_check(primary_scenes[1], cam, 0, cfg, 0.3, 0.04)

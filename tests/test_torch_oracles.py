"""The plain closest-hit oracles of the port (render/intersect.py
``trace_brute``, ``trace_unit``) and BRUTE and UNIT's soft shadow
visibility (``occlusion_soft``) against the JAX package's, on the CPU, on
the same numpy-seeded rays: the demo's and the mid sphere grid's
(``build_sphere_grid(n=4)``) camera rays and cosine bounce rays from their
hits; exact ties (copied triangles) for the first-index winner; the UNIT
remainder chunk, where the port reports the true expanded index
(ROADMAP §3); the oracles against kernel 1's and the BVH kernel's plain
versions on a 1080p tile, with the witness for UNIT's rounding; and the
soft visibility's gradient."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gdpathtracing_tpu.core.vec import Vec3 as JVec3
from gdpathtracing_tpu.render.intersect import (
    occlusion_soft as jax_occlusion_soft, trace_brute as jax_trace_brute,
    trace_unit as jax_trace_unit)
from gdpathtracing_tpu.render.types import Ray as JRay
from gdpathtracing_tpu.scene.demo import (
    build_demo_scene as jax_demo_scene,
    build_sphere_grid as jax_sphere_grid)
from gdpathtracing_tpu.scene.materials import Material as JMaterial
from gdpathtracing_tpu.scene.primitives import quad_ccw as jax_quad_ccw
from gdpathtracing_tpu.scene.scene import SceneBuilder as JSceneBuilder

from gdpathtracing_torch.config import RenderConfig
from gdpathtracing_torch.core import rng
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.render.intersect import (occlusion_soft,
                                                  trace_brute, trace_unit)
from gdpathtracing_torch.render.types import MISS_T, Ray
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.primitives import quad_ccw
from gdpathtracing_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)
# The pinned tolerance of a closest hit (ROADMAP §3): XLA's CPU code may
# fuse or reorder a product where torch rounds each op, and UNIT's t comes
# from a K = 4 contraction that each library may sum in another order.
T_RTOL, T_ATOL, UV_ATOL = 1e-6, 5e-6, 3e-5
# BRUTE on the mid grid (ROADMAP §3): XLA fuses Möller-Trumbore's
# cancelling cross products into FMAs on the CPU; 1-2 rays in ~500 lie
# outside the pinned tolerance (measured: t 3.6e-5 apart at t = 8.3, rel
# 4.4e-6; u 2.7e-4), so it holds on this share of the rays and
# T_RTOL_ALL, UV_ATOL_ALL on every ray.
T_SHARE, T_RTOL_ALL, UV_ATOL_ALL = 0.99, 1e-5, 1e-3
# tri, inst, eidx equal on this share of the rays: a 1-ulp t can flip
# which of two triangles sharing an edge a grazing ray hits first.
MIN_EQUAL = 0.999
W, H = 32, 24


@pytest.fixture(scope="module")
def scenes():
    return {
        "demo": (jax_demo_scene(texture_resolution=8, sphere_detail=6),
                 build_demo_scene(texture_resolution=8, sphere_detail=6,
                                  device="cpu"), demo_camera(W, H)),
        "grid": (jax_sphere_grid(n=4), build_sphere_grid(n=4, device="cpu"),
                 grid_camera(W, H, n=4))}


def _port_ray(o, d) -> Ray:
    return Ray(Vec3(*map(torch.from_numpy, o)), Vec3(*map(torch.from_numpy,
                                                          d)))


def _jax_ray(o, d) -> JRay:
    return JRay(JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)))


def _rays(ts, cam, kind: str):
    """(3, n) o and d: the camera's W x H rays (frame 1), or cosine rays
    about the geometric normal at their hits, 1e-3 off the surface (random
    rays from the scene's middle where a camera ray missed)."""
    pids = torch.arange(W * H)
    ray, _ = cam.generate_rays(pids, rng.prng_seed(pids % W, pids // W, 1),
                               RenderConfig())
    o, d = ray.o.to_array(0).numpy(), ray.d.to_array(0).numpy()
    if kind == "camera":
        return o, d
    g = np.random.default_rng(7)
    hit = trace_brute(ts, ray)
    t, tri, inst = (x.numpy() for x in (hit.t, hit.tri, hit.inst))
    p = o + d * np.where(t < MISS_T, t, 0.0)
    tf = ts.inst_transform.numpy()[inst]
    v = ts.tri_pos.numpy()[tri]
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
    o2 = np.where(miss, g.uniform(-1.5, 1.5, (3, t.size)), p + 1e-3 * nrm)
    return o2.astype(np.float32), np.where(miss, rand, dirs).astype(
        np.float32)


def _check_hits(got, want, what, eidx=True, t_share=1.0):
    ok = want.t < MISS_T
    gh = got.t.numpy() < MISS_T
    assert (gh == np.asarray(ok)).mean() >= MIN_EQUAL, what
    same = (got.tri.numpy() == np.asarray(want.tri)) \
        & (got.inst.numpy() == np.asarray(want.inst))
    if eidx:
        same &= got.eidx.numpy() == np.asarray(want.eidx)
    assert same.mean() >= MIN_EQUAL, (what, same.mean())
    both = same & gh & np.asarray(ok)
    gt, wt = got.t.numpy()[both], np.asarray(want.t)[both]
    assert np.isclose(gt, wt, rtol=T_RTOL, atol=T_ATOL).mean() >= t_share
    np.testing.assert_allclose(gt, wt, rtol=T_RTOL if t_share == 1.0
                               else T_RTOL_ALL, atol=T_ATOL)
    for f in ("u", "v"):
        gf, wf = getattr(got, f).numpy()[both], np.asarray(getattr(want, f)
                                                            )[both]
        assert (np.abs(gf - wf) <= UV_ATOL).mean() >= t_share
        np.testing.assert_allclose(gf, wf, rtol=0, atol=UV_ATOL
                                   if t_share == 1.0 else UV_ATOL_ALL)
    np.testing.assert_array_equal(got.front.numpy()[both],
                                  np.asarray(want.front)[both])
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    return both


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("name", ["demo", "grid"])
def test_trace_brute_matches_jax(scenes, name, kind):
    js, ts, cam = scenes[name]
    o, d = _rays(ts, cam, kind)
    active = np.random.default_rng(3).uniform(size=o.shape[1]) < 0.9
    got = trace_brute(ts, _port_ray(o, d), torch.from_numpy(active))
    want = jax.jit(jax_trace_brute)(js, _jax_ray(o, d), jnp.asarray(active))
    both = _check_hits(got, want, f"{name} {kind}", t_share=T_SHARE)
    assert both.mean() > 0.1
    assert not (got.t.numpy()[~active] < MISS_T).any()


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("name", ["demo", "grid"])
def test_trace_unit_matches_jax(scenes, name, kind):
    """Equal to JAX's but where the grid's winner lies in the remainder
    chunk (E = 15616 = 30 x 512 + 256): there JAX reads the last 512
    columns from a clamped start and reports eidx 256 too high (past E;
    its gather then clamps tri and inst to row E - 1), where the port
    reports the true index (ROADMAP §3)."""
    js, ts, cam = scenes[name]
    o, d = _rays(ts, cam, kind)
    got = trace_unit(ts, _port_ray(o, d))
    want = jax.jit(jax_trace_unit)(js, _jax_ray(o, d))
    e = ts.isect_mu.shape[1]
    tail = got.eidx.numpy() >= e // 512 * 512
    if e % 512:
        # the case the divergence is about occurs on these rays
        assert tail.any() or kind == "camera"
        want_e = np.asarray(want.eidx)
        np.testing.assert_array_equal(
            want_e[tail], got.eidx.numpy()[tail] + 512 - e % 512)
        want = want._replace(
            eidx=jnp.where(jnp.asarray(tail), want_e - 512 + e % 512,
                           want.eidx),
            tri=jnp.where(jnp.asarray(tail), got.tri.numpy(), want.tri),
            inst=jnp.where(jnp.asarray(tail), got.inst.numpy(), want.inst))
    else:
        assert not tail.any()
    both = _check_hits(got, want, f"{name} {kind}")
    assert both.mean() > 0.1
    # The winner is brute force's (whose t is the object space's, so the
    # pinned t tolerance; BRUTE tracks no expanded index).
    brute = trace_brute(ts, _port_ray(o, d))
    same = (brute.tri == got.tri) & (brute.inst == got.inst)
    assert float(same.double().mean()) >= MIN_EQUAL


@pytest.mark.parametrize("tile", ["primary", "bounce 1"])
@pytest.mark.parametrize("name", ["demo", "grid"])
def test_oracles_against_the_kernels_plain_versions(scenes, name, tile):
    """The oracles against kernel 1's and the BVH kernel's plain versions
    (each bit-equal to its kernel on the card) on 4096 rays of the middle
    1080p tile (ops/tiles.py): UNIT's winner is kernel 1's on >= 99.9% of
    the rays; on those, UNIT's epilogue over the kernel's unfused K = 4
    sums (ops/tiles.py unit_t_witness) gives t within the pinned tolerance
    on every ray, and UNIT's own t (the CPU's matrix product, which sums in
    another order) lies within two roundings of that contraction, as on
    the card (ROADMAP §3); BRUTE's triangle and instance are the BVH's on
    >= 99.9%, t within the pinned tolerance on all of those."""
    from gdpathtracing_torch.ops import intersect as ti
    from gdpathtracing_torch.ops import tiles as kt
    from gdpathtracing_torch.render.traverse import trace_bvh
    ts = scenes[name][1]
    cam = demo_camera(kt.W, kt.H) if name == "demo" \
        else grid_camera(kt.W, kt.H, n=4)
    cfg = RenderConfig()
    prep = ti.prepare_trace_inputs(ts)
    ray, hit, sh, seed = kt.middle_rays(ts, cam, prep, cfg, 4096,
                                        kt.middle_tile(cfg))
    ray, active = (ray, None) if tile == "primary" \
        else kt.bounce_rays(sh, hit, seed, cfg)
    unit = trace_unit(ts, ray, active)
    k1 = ti.trace_pallas(ts, ray, active, prep)
    same = unit.eidx == k1.eidx
    assert float(same.double().mean()) >= MIN_EQUAL
    both = same & k1.hit
    assert int(both.sum()) > 1000
    t_w, bound = (x[both] for x in kt.unit_t_witness(ts, ray, k1.eidx,
                                                       k1.t))
    assert bool(torch.isclose(t_w, k1.t[both], rtol=T_RTOL,
                              atol=T_ATOL).all())
    assert bool(((unit.t[both] - k1.t[both]).abs().double() <= bound).all())
    brute = trace_brute(ts, ray, active)
    bvh = trace_bvh(ts, ray, active)
    same = (brute.tri == bvh.tri) & (brute.inst == bvh.inst)
    assert float(same.double().mean()) >= MIN_EQUAL
    on = same & bvh.hit
    assert bool(torch.isclose(brute.t[on], bvh.t[on], rtol=T_RTOL,
                              atol=T_ATOL).all())


def _tie_scenes():
    """The same quad four times over, at one place: every ray that hits
    hits four instances, each with two triangles, at exactly equal t."""
    out = []
    for builder, quad, mat in ((JSceneBuilder, jax_quad_ccw, JMaterial),
                               (SceneBuilder, quad_ccw, Material)):
        b = builder()
        mesh = b.add_mesh([quad([-1, -1, 0], [1, -1, 0], [1, 1, 0],
                                [-1, 1, 0])])
        for k in range(4):
            b.add_instance(mesh, np.eye(4, dtype=np.float32)[:3],
                           materials=[mat(albedo=(0.2 * k, 0.5, 0.5))])
        out.append(b.build() if builder is JSceneBuilder
                   else b.build("cpu"))
    return out


def test_oracles_take_the_first_of_equal_hits():
    """torch.argmin's first index and the strict merge: on exact ties the
    lowest (instance, triangle) wins in BRUTE and the lowest expanded
    index in UNIT, as in JAX."""
    js, ts = _tie_scenes()
    g = np.random.default_rng(5)
    n = 512
    o = np.stack([g.uniform(-0.7, 0.7, n), g.uniform(-0.7, 0.7, n),
                  np.full(n, 2.0)]).astype(np.float32)
    d = np.stack([g.uniform(-0.1, 0.1, n), g.uniform(-0.1, 0.1, n),
                  -np.ones(n)]).astype(np.float32)
    for port, ref in ((trace_brute, jax_trace_brute),
                      (trace_unit, jax_trace_unit)):
        got = port(ts, _port_ray(o, d))
        want = ref(js, _jax_ray(o, d))
        assert (got.t.numpy() < MISS_T).all()
        for f in ("tri", "inst", "eidx"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    brute = trace_brute(ts, _port_ray(o, d))
    assert (brute.inst.numpy() == 0).all()
    unit = trace_unit(ts, _port_ray(o, d))
    # the lowest expanded index among the four copies of the hit triangle
    tri = ts.isect_tri.numpy()
    for k in range(n):
        assert int(unit.eidx[k]) == np.flatnonzero(tri == int(unit.tri[k])
                                                   ).min()


@pytest.mark.parametrize("name", ["demo", "grid"])
def test_occlusion_soft_matches_jax(scenes, name):
    """Shadow rays from the camera rays' hits toward points above the
    scene (the grid's E is no multiple of 512: chunks of 256)."""
    js, ts, cam = scenes[name]
    o, d = _rays(ts, cam, "camera")
    hit = trace_brute(ts, _port_ray(o, d))
    t = hit.t.numpy()
    ok = t < MISS_T
    p = o + d * np.where(ok, t, 0.0) - 1e-3 * d
    g = np.random.default_rng(11)
    target = np.stack([g.uniform(-1, 1, t.size), np.full(t.size, 2.9),
                       g.uniform(-1, 1, t.size)]).astype(np.float32)
    if name == "grid":
        target[1] = 8.0
    dv = target - p
    dist = np.linalg.norm(dv, axis=0)
    d2 = (dv / dist).astype(np.float32)
    tmax = (dist * (1.0 - 1e-3)).astype(np.float32)
    p = p.astype(np.float32)
    for eps in (0.02, 0.2):
        got = occlusion_soft(ts, _port_ray(p, d2), torch.from_numpy(tmax),
                             torch.from_numpy(ok), edge_eps=eps)
        want = jax.jit(jax_occlusion_soft, static_argnames=("edge_eps",))(
            js, _jax_ray(p, d2), jnp.asarray(tmax), jnp.asarray(ok),
            edge_eps=eps)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        assert (got.numpy()[~ok] == 1.0).all()
        vis = got.numpy()[ok]
        assert (vis < 0.5).any() and (vis > 0.5).any()


def test_occlusion_soft_gradient_matches_jax(scenes):
    """d(sum of visibility) / d(the shadow rays' origins) against JAX's,
    where both are finite (the product's sigmoid bands)."""
    js, ts, cam = scenes["demo"]
    o, d = _rays(ts, cam, "camera")
    hit = trace_brute(ts, _port_ray(o, d))
    ok = hit.t.numpy() < MISS_T
    p = (o + d * np.where(ok, hit.t.numpy(), 0.0) - 1e-3 * d).astype(
        np.float32)
    target = np.array([[0.3], [2.9], [-0.2]], np.float32)
    dv = target - p
    dist = np.linalg.norm(dv, axis=0)
    d2 = (dv / dist).astype(np.float32)
    tmax = (dist * (1.0 - 1e-3)).astype(np.float32)

    po = torch.from_numpy(p).requires_grad_(True)
    vis = occlusion_soft(ts, Ray(Vec3(*po), Vec3(*map(torch.from_numpy,
                                                      d2))),
                         torch.from_numpy(tmax), torch.from_numpy(ok),
                         edge_eps=0.2)
    (gp,) = torch.autograd.grad(vis.sum(), po)

    def f(pj):
        return jax_occlusion_soft(js, JRay(JVec3(*pj), JVec3(
            *map(jnp.asarray, d2))), jnp.asarray(tmax), jnp.asarray(ok),
            edge_eps=0.2).sum()

    gj = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(p)))
    fin = np.isfinite(gj)
    assert fin.mean() > 0.99 and (np.abs(gj[fin]) > 0).any()
    np.testing.assert_allclose(gp.numpy()[fin], gj[fin], rtol=1e-3,
                               atol=1e-3 * np.abs(gj[fin]).max())
